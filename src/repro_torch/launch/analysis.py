"""Pricing of one traced step and its roofline terms: the port's
counterpart of the JAX package's ``launch/hlo_analysis.py``.

The reference prices a compiled XLA module: it parses the optimized HLO,
multiplies each while-loop body by its trip count, and derives FLOPs, HBM
bytes and the collectives' wire bytes from the ops.  The port has no XLA
and compiles nothing, so there is no HLO to parse.  Its dry run runs the
port's own step once, on tensors with no data (``FakeTensorMode``) over
a world of fake ranks, and ``StepRecorder`` records what rank 0 does:

  1. every collective the step issues, seen as a ``c10d`` or
     ``_c10d_functional`` op by a ``TorchDispatchMode`` (no model code is
     touched): its kind, its group's ranks and its result bytes, priced
     by the reference's ring conventions, copied below verbatim; a
     point-to-point send is a collective-permute; a group of one moves
     nothing and is not recorded (XLA drops such ops too).  A loop runs
     as often as it runs, so every trip multiplier is 1;
  2. FLOPs by the formulas of ``torch.utils.flop_counter`` (its
     ``flop_registry``), counted as ``FlopCounterMode`` counts them: an
     op with a composite kernel is taken as the ops it decomposes into;
     plus each shape-only kernel call at the operation count of its
     bound (flash attention, the SSD chunk; the codec and packing kernels
     do none);
  3. bytes: the inputs plus the outputs of every dispatched op (views
     and allocations move nothing and are skipped), plus each shape-only
     kernel's inputs read once and outputs written once.  This is the
     unfused count, an upper bound on the fused figure XLA reports;
  4. the peak: the bytes of live storages, those held on entry included,
     each rounded up to the caching allocator's 512 bytes on the card.

Conventions (the reference's, verbatim):
  * all-gather:       (g-1)/g * result_bytes per chip
  * all-reduce:       2*(g-1)/g * result_bytes per chip
  * reduce-scatter:   (g-1)   * result_bytes per chip (= (g-1)/g * input)
  * all-to-all:       (g-1)/g * result_bytes per chip
  * collective-permute: result_bytes per chip
  * a flat collective spanning P pods is attributed (P-1)/P of its bytes
    to DCN (the minimum that must cross); explicit pod-axis collectives
    (group size == P) are 100% DCN.
The field names stay the reference's: ``ici_*`` is the link inside a
cluster (NVLink here), ``dcn_*`` the link between clusters.

Hardware constants: the H100's 989e12 FLOP/s bf16 dense and 3.35e12 B/s
HBM, as PERF.md's kernel bounds use them; and two assumptions: 450e9 B/s
of NVLink per direction a GPU, and 50e9 B/s a GPU between clusters (one
400 Gb/s NDR port).
"""

from __future__ import annotations

import dataclasses
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
ICI_BW = 450e9
DCN_BW = 50e9
ALLOC_ROUND = 512          # the caching allocator's smallest block, bytes


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    result_bytes: int
    group_size: int
    crosses_pods: bool
    pods_spanned: int
    trip_mult: int
    wire_bytes_per_chip: float
    dcn_bytes: float
    ici_bytes: float
    line: str


@dataclasses.dataclass
class StepCosts:
    """What one traced step costs a rank (the reference's ``HloCosts``)."""
    flops_per_chip: float        # flop_registry's formulas + shape-only kernels
    bytes_per_chip: float        # unfused: every op's inputs and outputs
    collectives: list[CollectiveOp]
    peak_bytes: int              # live storages at their largest
    held_bytes: int              # live storages on entry
    kernels: dict                # shape-only calls by kernel: count, flops, bytes


def price_collective(kind: str, result_bytes: int, ranks: list[int], pod_size: int,
                     line: str = "", peer: int | None = None) -> CollectiveOp:
    """One collective of ``kind`` over the global ``ranks`` (a
    collective-permute: this rank and ``peer``), priced by the reference's
    conventions; pods are ``rank // pod_size``, as ``mesh_coords`` lays the
    ranks out."""
    rb = result_bytes
    if kind == "collective-permute":
        crosses = ranks[0] // pod_size != peer // pod_size
        wire = float(rb)
        return CollectiveOp(kind, rb, 2, crosses, 2 if crosses else 1, 1, wire,
                            wire if crosses else 0.0, 0.0 if crosses else wire, line)
    g = len(ranks)
    pods = len({r // pod_size for r in ranks})
    crosses = pods > 1
    if kind == "all-gather":
        wire = (g - 1) / g * rb
    elif kind == "all-reduce":
        wire = 2 * (g - 1) / g * rb
    elif kind == "reduce-scatter":
        wire = (g - 1) * rb
    else:  # all-to-all
        wire = (g - 1) / g * rb
    if crosses:
        dcn = wire * (pods - 1) / pods if g > pods else wire
        ici = wire - dcn
    else:
        dcn, ici = 0.0, wire
    return CollectiveOp(kind, rb, g, crosses, pods, 1, wire, dcn, ici, line)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tensors_of(tree) -> list[torch.Tensor]:
    """The tensors of a tree of lists, tuples, dicts and dataclasses."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tensors_of(x)]
    return []


def flash_pairs(Sq: int, causal: bool, window: int | None, q_offset: int,
                valid_kv: int) -> int:
    """The (query, key) pairs flash attention computes: causal and inside
    the window, as its bound counts them."""
    def keys(i):
        hi = min(valid_kv, q_offset + i + 1) if causal else valid_kv
        lo = 0 if window is None else max(0, q_offset + i + 1 - window)
        return max(0, hi - lo)

    if not causal and window is None:
        return Sq * valid_kv
    return sum(keys(i) for i in range(Sq))


def kernel_cost(name: str, info: dict) -> tuple[float, float]:
    """(FLOPs, bytes) of one shape-only kernel call, as PERF.md's bound
    counts them: flash 4 flops per (q, k) pair and head dim, reading q, k
    and v over the valid keys and writing o; the SSD chunk's products
    over the causal half; every other kernel reads its inputs and writes
    its outputs once, and computes nothing a roofline counts."""
    if name == "flash_attention":
        q, k, out = info["q"], info["k"], info["out"]
        B, H, Sq, dh = q.shape
        K = k.shape[1]
        pairs = flash_pairs(Sq, info["causal"], info["window"], info["q_offset"],
                            info["valid_kv"])
        return (4.0 * B * H * dh * pairs,
                q.element_size() * B * dh * (2 * H * Sq + 2 * K * info["valid_kv"]))
    if name == "ssd_chunk":
        x, B = info["x"], info["B"]
        b, s, h, p = x.shape
        g, n = B.shape[2], B.shape[3]
        q = info["chunk"]
        nc = s // q
        pairs = q * (q + 1) // 2
        flops = 2.0 * b * nc * (g * pairs * n + h * (pairs * p + q * p * n))
        elem = x.element_size()
        nbytes = (elem * b * s * (h * p + 2 * g * n) + 4 * b * s * h + 4 * h
                  + 4 * b * s * h * p + 4 * b * nc * h * p * n)
        return flops, float(nbytes)
    tensors = [t for v in info.values() for t in tree_leaves(v) if isinstance(t, torch.Tensor)]
    return 0.0, float(sum(_nbytes(t) for t in tensors))


# c10d op name -> (kind, index of the result in the op's arguments);
# ``dist.*`` calls reach these ops, so the recorder sees every collective
_C10D = {"allreduce_": ("all-reduce", 0), "_allgather_base_": ("all-gather", 0),
         "_reduce_scatter_base_": ("reduce-scatter", 0), "alltoall_base_": ("all-to-all", 0),
         "send": ("collective-permute", 0)}
_FUNCTIONAL = {"all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all"}
_ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}


class StepRecorder(TorchDispatchMode):
    """Records one traced step of rank 0 (see the module docstring):
    collectives, bytes and live storages.  ``hold`` registers what is
    live on entry; enter it inside ``FakeTensorMode`` and around
    ``_build.shape_only_calls(recorder.kernel_call)``."""

    def __init__(self, pod_size: int, rank: int = 0):
        super().__init__()
        self.pod_size, self.rank = pod_size, rank
        self.collectives: list[CollectiveOp] = []
        self.flops = self.bytes = 0.0
        self.kernels: dict[str, dict] = {}
        self.live = self.peak = self.held = 0
        self._storages = WeakIdKeyDictionary()
        self._ranks: dict[str, list[int]] = {}

    # ---- storages --------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._storages:
            return
        n = st.nbytes()
        if t.device.type == "cuda":
            n = -(-n // ALLOC_ROUND) * ALLOC_ROUND
        self._storages[st] = weakref.ref(st, lambda _, n=n: self._free(n))
        self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, n: int) -> None:
        self.live -= n

    def hold(self, *trees) -> None:
        """Count the storages of the tensors in ``trees`` (nested lists,
        tuples, dicts and dataclasses, such as an optimizer state) as live
        from now."""
        for t in tensors_of(trees):
            self._track(t)
        self.held = self.live

    # ---- collectives -----------------------------------------------------
    def _group_ranks(self, pg) -> list[int]:
        if isinstance(pg, str):
            from torch.distributed.distributed_c10d import _resolve_process_group
            key, group = pg, _resolve_process_group(pg)
        else:
            group = dist.ProcessGroup.unbox(pg)
            key = group.group_name
        if key not in self._ranks:
            self._ranks[key] = dist.get_process_group_ranks(group)
        return self._ranks[key]

    def _collective(self, func, args, out) -> None:
        name = func._opname
        if func.namespace == "c10d" and name in _C10D:
            kind, at = _C10D[name]
            result = args[at]
            ranks = self._group_ranks(next(a for a in args if isinstance(a, torch.ScriptObject)))
        elif func.namespace == "_c10d_functional" and name in _FUNCTIONAL:
            kind, result, ranks = _FUNCTIONAL[name], out, self._group_ranks(args[-1])
        else:
            return                       # waits, receives, barriers: nothing more on the wire
        if len(ranks) < 2:
            return
        rb = sum(_nbytes(t) for t in tree_leaves(result) if isinstance(t, torch.Tensor))
        peer = None
        if kind == "collective-permute":
            peer = ranks[args[2]]        # send(tensors, group, dst, tag): dst in the group
            ranks = [self.rank]
        self.collectives.append(price_collective(kind, rb, ranks, self.pod_size,
                                                 f"{func} over {len(ranks)} ranks", peer))

    # ---- kernels ---------------------------------------------------------
    def kernel_call(self, name: str, info: dict) -> None:
        flops, nbytes = kernel_cost(name, info)
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.bytes += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "aten":
            # an op with a composite kernel (under inference mode linear and
            # matmul arrive whole) is recorded as the ops it decomposes into
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        if func is torch.ops._c10d_functional.wait_tensor.default:
            # eager's wait returns its input; the fake kernel makes a copy
            out = args[0]
        else:
            out = func(*args, **kwargs)
        if func.namespace in ("c10d", "_c10d_functional"):
            self._collective(func, args, out)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if not func.is_view and func._opname not in _ALLOCATIONS:
            self.bytes += sum(_nbytes(t) for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t)
        return out

    def costs(self) -> StepCosts:
        kflops = sum(k["flops"] for k in self.kernels.values())
        return StepCosts(self.flops + kflops, self.bytes, self.collectives, self.peak,
                         self.held, self.kernels)


# ---------------------------------------------------------------------------
# Roofline
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Roofline:
    flops_per_chip: float
    bytes_per_chip: float
    ici_bytes: float
    dcn_bytes: float
    compute_s: float
    memory_s: float
    ici_s: float
    dcn_s: float
    collective_s: float          # max(ici, dcn): overlapped budget
    collective_seq_s: float      # ici + dcn: serialized budget
    bottleneck: str
    step_s: float                # max of the three terms
    model_flops: float
    useful_flops_ratio: float
    roofline_fraction: float     # ideal model-flops time / step time

    def to_dict(self):
        return dataclasses.asdict(self)


def roofline_terms(costs: StepCosts, n_chips: int,
                   model_flops_total: float) -> Roofline:
    ici = sum(o.ici_bytes for o in costs.collectives)
    dcn = sum(o.dcn_bytes for o in costs.collectives)
    compute_s = costs.flops_per_chip / PEAK_FLOPS
    memory_s = costs.bytes_per_chip / HBM_BW
    ici_s = ici / ICI_BW
    dcn_s = dcn / DCN_BW
    coll_s = max(ici_s, dcn_s)
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    bottleneck = max(terms, key=terms.get)
    step = max(terms.values())
    model_per_chip = model_flops_total / max(1, n_chips)
    useful = (model_per_chip / costs.flops_per_chip
              if costs.flops_per_chip else 0.0)
    ideal_s = model_per_chip / PEAK_FLOPS
    frac = ideal_s / step if step > 0 else 0.0
    return Roofline(costs.flops_per_chip, costs.bytes_per_chip, ici, dcn,
                    compute_s, memory_s, ici_s, dcn_s, coll_s, ici_s + dcn_s,
                    bottleneck, step, model_flops_total, useful, frac)


def summarize_ops(coll_ops: list[CollectiveOp]) -> dict:
    by_kind: dict[str, dict] = {}
    for o in coll_ops:
        d = by_kind.setdefault(o.kind, {"count": 0, "wire_bytes": 0.0,
                                        "dcn_bytes": 0.0, "ici_bytes": 0.0})
        d["count"] += 1
        d["wire_bytes"] += o.wire_bytes_per_chip
        d["dcn_bytes"] += o.dcn_bytes
        d["ici_bytes"] += o.ici_bytes
    return by_kind


def gib(nbytes: float) -> float:
    return round(nbytes / 2 ** 30, 3)

