"""The data-parallel training step, its gradients synced by the HetCCL
hierarchical collectives (the JAX package's ``train/train_step.py``).

Communication modes (``TrainConfig.comm_mode``) ported here:

  flat  replicated params; one all-reduce over (pod, data) for the gradients
        (the homogeneous-library emulation, the baseline).
  hier  the paper's AllReduceH: ReduceScatter(intra) -> c2cRed(pod,
        optionally bf16 or int8 on the wire) -> AllGather(intra), over
        the packed gradient buffer (Alg. 1, Table 7).
  hier_pipelined
        hier with the pod hop and its codec cut into ``n_chunks`` chunks
        of the shard, fill and drain peeled (§4.3.2, Fig. 9).
  hier_border_rs
        hier whose C2C hop is the border-communicator exchange (§4.3):
        a combining reduce-scatter over the pod group, then an
        all-gather of the owned shards; bf16 or no codec (int8 raises).
  hier_overlap
        AllReduceH per readiness-ordered gradient bucket
        (``core/overlap.py``): each bucket's gradients are packed as f32
        and synced inside the backward, as soon as the bucket and every
        bucket before it are complete (lm_head and norms first, layers
        in reverse, embeddings last).
  hier_zero1
        hier's breakdown fused with ZeRO-1: ReduceScatterH leaves each
        rank the f32 shard of the summed gradients, which feeds the
        flat-shard AdamW directly; the deferred end AllGather doubles as
        the parameter reconstruction.  The master and the moments live
        on the 1/intra_size shard (``zero_bootstrap`` builds them).
  fsdp  the layer parameters FSDP-sharded over the data group (the model
        built ``with_fsdp``): the gather's backward is the intra-cluster
        reduce-scatter, so a sharded leaf syncs over the pod group only
        (the codec on that hop); a replicated leaf goes through
        AllReduceH alone.

With ``TrainConfig.plan`` (a ``core.planner.CommPlan``) each gradient
buffer or bucket resolves its own schedule from the plan, bound to the
runtime's groups; ``packed=False`` runs the per-leaf data path that plans
choose when packing does not pay.

Each process holds one TP shard of one replica of the model (``Model``
on its device) and its data-parallel slice of the global batch; the
gradients of a shard are synced over the data-parallel groups of its
model index, so the TP ranks of a replica each run their own sync.  The step updates the parameters and
the Adam (or ZeRO) state in place.  With ``finite_gate`` a step whose synced loss
or grad norm is not finite leaves both untouched (the reference selects
the old values inside its compiled step; here the host reads the two
synced scalars first).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import collectives as coll
from repro_torch.core import compression, primitives
from repro_torch.core import overlap as overlap_lib
from repro_torch.core.collectives import CommConfig
from repro_torch.core.planner import BoundPlan
from repro_torch.core.schedule import STRUCTURAL_MODES, build_schedule
from repro_torch.kernels import quant as _qk
from repro_torch.kernels._build import shape_only
from repro_torch.models.model import STACKED, Model
from repro_torch.parallel.sharding import Runtime, group_size
from repro_torch.runtime import tree as tree_lib
from . import loss as loss_lib
from . import optimizer as opt_lib


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # any registered schedule mode (flat|hier|hier_pipelined|
    # hier_border_rs) or a structural mode (hier_overlap|hier_zero1|fsdp)
    # wrapping one: core.schedule.STRUCTURAL_MODES
    comm_mode: str = "hier"
    dcn_compression: str | None = None  # None|bf16|int8 (pod hop only)
    n_chunks: int = 4                   # hier_pipelined's chunks; aligns the packed layout
    # hier_overlap's bucket size cap, the planner-side default
    bucket_cap_mb: int = overlap_lib.DEFAULT_CAP_BYTES >> 20
    # the packed gradient data path (core/packing.py): one persistent
    # layout, one pack and one unpack per step.  False is the per-leaf path
    # (a fresh concatenate per dtype or per bucket each step), which a plan
    # chooses when packing does not pay
    packed: bool = True
    # per-pod gradient weights (mean 1 over pods) for an uneven batch split
    cluster_weights: tuple[float, ...] | None = None
    # a planner.CommPlan: when set, the collectives resolve mode, chunks and
    # codec per gradient bucket from the plan, and the fields above only
    # steer the structure (hier_overlap, hier_zero1, fsdp)
    plan: Any = None
    finite_gate: bool = True
    opt: opt_lib.OptConfig = dataclasses.field(default_factory=opt_lib.OptConfig)
    aux_weight: float = 1e-2          # MoE load-balance loss weight
    z_loss: float = 0.0

    def comm_config(self, rt: Runtime) -> CommConfig | BoundPlan:
        """The plan on ``rt``'s groups when there is one, else the one
        schedule of ``manual_config``."""
        if self.plan is not None:
            return BoundPlan.of(self.plan, rt)
        return self.manual_config(rt)

    def manual_config(self, rt: Runtime) -> CommConfig:
        """The schedule the fields give: fsdp's pod hop of a sharded leaf
        takes it with a plan too, as in the reference."""
        # structural modes wrap the hier schedule; every other comm_mode IS
        # a schedule-builder mode: build once so that an unknown mode fails
        # here with the registry's error
        mode = STRUCTURAL_MODES.get(self.comm_mode, self.comm_mode)
        build_schedule("all_reduce", mode, self.n_chunks, self.dcn_compression)
        return CommConfig(mode=mode, pod_group=rt.pod_group,
                          intra_group=rt.data_group, dp_group=rt.dp_group,
                          n_chunks=self.n_chunks,
                          compression=self.dcn_compression,
                          cluster_weights=self.cluster_weights)


def _global_grad_norm(grads: list[torch.Tensor], specs: list[tuple],
                      rt: Runtime) -> torch.Tensor:
    """L2 norm over the gradient leaves, summed in f32: each leaf's square
    is summed over the groups its spec is sharded on, "model" over the TP
    group and "data" over the FSDP group (the reference sums per set of
    axes)."""
    parts: dict[tuple, torch.Tensor] = {}
    for g, spec in zip(grads, specs):
        groups = tuple(group for axis, group in (("model", rt.tp_group),
                                                 ("data", rt.fsdp_group))
                       if group is not None and axis in spec)
        val = g.float().square().sum()
        parts[groups] = parts[groups] + val if groups in parts else val
    total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for groups, val in parts.items():
        for group in groups:
            val = primitives.hom_psum(val, group)
        total = total + val
    return torch.sqrt(total)


def _regroup(flat: list[torch.Tensor], leaves) -> list:
    """Tensors in ``flat_params`` order -> the leaf structure of ``leaves``."""
    out, i = [], 0
    for leaf in leaves:
        if isinstance(leaf, (list, tuple)):
            out.append(list(flat[i:i + len(leaf)]))
            i += len(leaf)
        else:
            out.append(flat[i])
            i += 1
    return out


def _expand(synced: list[torch.Tensor], leaves) -> list[torch.Tensor]:
    """Synced leaves (a list leaf as its (L, ...) stack) -> one tensor per
    parameter, in ``flat_params`` order."""
    out = []
    for s, leaf in zip(synced, leaves):
        out.extend(s.unbind(0) if isinstance(leaf, (list, tuple)) else [s])
    return out


def _stacked(g) -> torch.Tensor:
    """A leaf's gradient as one tensor: a list leaf's layers written into
    its (L, ...) stack by one ``pack_slots`` launch."""
    if not isinstance(g, list):
        return g
    pieces, off = [], 0
    for part in g:
        pieces.append((off, part))
        off += part.numel()
    return _qk.pack_slots_call(pieces, off, g[0].dtype).view((len(g),) + tuple(g[0].shape))


def fsdp_sync(g, is_sharded: bool, ccfg, rt: Runtime) -> torch.Tensor:
    """fsdp's sync of one leaf's gradient (a list leaf as its stack): a
    sharded leaf arrives reduce-scattered over data (the gather's
    backward), so only the pod hop is left, with ``ccfg``'s codec (a
    ``CommConfig``); a replicated leaf goes through AllReduceH alone
    (``ccfg`` a config or a bound plan)."""
    x = _stacked(g)
    if not is_sharded:
        return coll.hier_psum(x, ccfg) if rt.dp_group is not None else x
    if rt.pod_group is None:
        return x
    # the weight is constant within a pod, so scaling after the intra
    # reduce-scatter is still the exact weighted reduction
    w = None if ccfg.cluster_weights is None else coll._cluster_weight_scalar(ccfg)
    if ccfg.compression:
        return compression.compressed_psum(x, rt.pod_group, ccfg.compression, weight=w)
    if w is not None:
        x = x * w.to(device=x.device, dtype=x.dtype)
    return primitives.c2c_red(x, rt.pod_group)


def zero_bootstrap(model: Model, tcfg: TrainConfig) -> opt_lib.ZeroState:
    """The ZeRO-1 state of ``hier_zero1`` from the model's current
    parameters: this rank's slice of the packed f32 master (the layout the
    scattered gradient sync and the reconstruction use), zero moments."""
    shard, _ = coll.zero1_local_shard(model.train_leaves(), tcfg.comm_config(model.rt))
    return opt_lib.zero_init_from_flatparam(shard)


def _sq_norm(shard: torch.Tensor) -> torch.Tensor:
    """sum(shard^2) in f32, ``ZERO_CHUNK`` values at a time (no
    shard-sized temporary)."""
    return sum(c.float().square().sum() for c in shard.split(opt_lib.ZERO_CHUNK))


def make_train_step(model: Model, tcfg: TrainConfig):
    """Returns (step_fn, init_fn).

    ``init_fn(seed)`` draws the model's parameters from ``seed`` and
    returns a fresh ``AdamState``, or for ``hier_zero1`` with a
    data-parallel group the ``ZeroState`` of ``zero_bootstrap``.
    ``step_fn(opt_state, batch)`` takes
    this rank's ``{"tokens", "labels"}`` (B, S) tensors on the model's
    device (and an encoder-decoder model's ``enc`` frames, (B, S_enc,
    D)), runs forward, backward, gradient sync and the update in
    place, and returns the metrics synced over the data-parallel group
    as Python numbers: loss (the cross-entropy plus ``aux_weight`` times the
    MoE aux loss), grad_norm, aux, mean_logp and ``gated`` (the
    finite gate skipped the update).  Without a data-parallel group there
    is no sync (the reference's single-device step)."""
    rt = model.rt
    ccfg = tcfg.comm_config(rt)
    n_dp = group_size(rt.dp_group)
    # without a data-parallel group hier_zero1 is the plain step, as in the
    # reference
    zero1 = tcfg.comm_mode == "hier_zero1" and rt.dp_group is not None
    # hier_overlap syncs each bucket inside the backward; without a
    # data-parallel group it is the plain step too
    overlapped = tcfg.comm_mode == "hier_overlap" and rt.dp_group is not None
    if overlapped and rt.sp and rt.tp > 1 and model.cfg.family == "encdec":
        # the GELU MLP's b2 is no input of the loss under sequence parallelism
        # (R22): its gradient never arrives, so its bucket would never sync
        raise NotImplementedError(
            f"{model.cfg.name} with sequence parallelism under hier_overlap: a parameter "
            f"the loss does not read never fills its bucket; the encoder-decoder family "
            f"trains with sequence parallelism under the modes that sync after the backward")
    fsdp = tcfg.comm_mode == "fsdp"
    hop = tcfg.manual_config(rt) if fsdp else None

    def init_fn(seed: int = 0):
        model.init(seed)
        if zero1:
            return zero_bootstrap(model, tcfg)
        params, _ = opt_lib.flat_params(model.train_leaves())
        return opt_lib.adam_init(params)

    def step_fn(opt_state: opt_lib.AdamState | opt_lib.ZeroState, batch: dict) -> dict[str, Any]:
        leaves = model.train_leaves()
        params, decay = opt_lib.flat_params(leaves)
        for p in params:
            p.requires_grad_(True)
        # planned on the live parameters (init replaces them)
        overlap = (overlap_lib.BucketSync(model.param_tree(), ccfg, tcfg.bucket_cap_mb << 20,
                                          packed=tcfg.packed)
                   if overlapped else None)
        specs = list(model.param_specs().values())
        with torch.enable_grad():
            logits, aux = model.apply_train(batch["tokens"], batch.get("enc"))
            lval, metrics = loss_lib.sharded_xent(logits, batch["labels"], rt,
                                                  model.cfg.vocab_size, tcfg.z_loss)
            del logits
            lval = lval + tcfg.aux_weight * aux
            if overlap is not None:
                # the gradients come back synced, bucket by bucket
                with overlap.attached():
                    grads = list(torch.autograd.grad(lval, params))
            else:
                # a parameter the loss does not read (the GELU MLP's b2 under
                # sequence parallelism, R22) takes a zero gradient, as jax.grad
                # gives it
                grads = _regroup(torch.autograd.grad(lval, params, materialize_grads=True),
                                 leaves)

        # ---- gradient synchronization: the paper's technique -------------
        # (the record_function ranges name the phases in a profile)
        if zero1:
            # AllReduceH with the end AllGather fused into the parameter
            # reconstruction: RS(intra) -> c2cRed(pod) gives the synced f32
            # shard that feeds AdamW directly
            with torch.profiler.record_function("grad_sync"):
                shard, fmeta = coll.tree_hier_psum_scatter(grads, ccfg)
                del grads
            # the norm of the pod-summed shard: summed over the intra group,
            # then over the TP group, where the reference counts the
            # replicated leaves tp times (ROADMAP R10)
            with torch.profiler.record_function("grad_norm"):
                sq = primitives.hom_psum(_sq_norm(shard), ccfg.intra_group)
                gnorm = torch.sqrt(primitives.hom_psum(sq, rt.tp_group)) / n_dp
        elif overlap is not None:
            synced = grads           # one per parameter, synced in the backward
            del grads
            with torch.profiler.record_function("grad_norm"):
                # one spec per parameter: a list leaf's for each of its layers
                per_param = [spec for spec, leaf in zip(specs, leaves)
                             for _ in (leaf if isinstance(leaf, list) else [leaf])]
                gnorm = _global_grad_norm(synced, per_param, rt) / n_dp
        else:
            with torch.profiler.record_function("grad_sync"):
                if fsdp:
                    # leaf by leaf, each released once synced
                    synced = []
                    for i, spec in enumerate(specs):
                        is_sharded = "data" in spec
                        g, grads[i] = grads[i], None
                        # a plan resolves only AllReduceH; the pod hop of a
                        # sharded leaf keeps the fields' codec, as in the
                        # reference
                        synced.append(fsdp_sync(g, is_sharded, hop if is_sharded else ccfg,
                                                rt))
                        del g
                elif rt.dp_group is not None:
                    synced = coll.tree_hier_psum(grads, ccfg, packed=tcfg.packed)
                else:
                    synced = [torch.stack(g) if isinstance(g, list) else g
                              for g in grads]
                del grads
            with torch.profiler.record_function("grad_norm"):
                gnorm = _global_grad_norm(synced, specs, rt) / n_dp
        clip = torch.clamp(tcfg.opt.grad_clip / (gnorm + 1e-9), max=1.0)

        m = torch.stack([lval.detach().float(), gnorm / n_dp, aux.detach().float(),
                         metrics["mean_logp"].detach().float()])
        if n_dp > 1:
            dist.all_reduce(m, group=rt.dp_group)
        m = m / n_dp
        if shape_only(m):
            # a step traced on tensors with no data (the dry run) has no
            # values to read: nothing is gated, and the update is traced too
            out = dict.fromkeys(("loss", "grad_norm", "aux", "mean_logp"), math.nan)
            out["gated"] = False
        else:
            out = dict(zip(("loss", "grad_norm", "aux", "mean_logp"), m.tolist()))
            ok = math.isfinite(out["loss"]) and math.isfinite(out["grad_norm"])
            out["gated"] = tcfg.finite_gate and not ok
        if out["gated"]:
            return out
        if zero1:
            with torch.profiler.record_function("optimizer"):
                opt_lib.zero_update(shard, opt_state, tcfg.opt, clip / n_dp)
            del shard
            with torch.profiler.record_function("grad_sync"), torch.no_grad():
                new = coll.tree_hier_unscatter(opt_state.flat_param, fmeta, ccfg)
                for p, v in zip(params, _expand(new, leaves)):
                    p.copy_(v)
        else:
            with torch.profiler.record_function("optimizer"):
                opt_lib.adam_update(synced if overlap is not None else _expand(synced, leaves),
                                    opt_state, params, decay, tcfg.opt, clip / n_dp)
        return out

    return step_fn, init_fn


# ---------------------------------------------------------------------------
# The training state, global and on the host (checkpoints, elastic resharding)
# ---------------------------------------------------------------------------

def _shard_groups(model: Model) -> dict[str, Any]:
    """The group each sharded mesh axis of a parameter spec names."""
    return {"model": model.rt.tp_group, "data": model.rt.fsdp_group if model.fsdp > 1 else None}


def _zero_groups(model: Model, tcfg: TrainConfig) -> list:
    """The groups the ZeRO-1 master is sharded over, minor first: TP, then
    the intra group (the reference's ``P(("data", "model"))``)."""
    return [model.rt.tp_group, tcfg.comm_config(model.rt).intra_group]


def _gathered(model: Model, spec: tuple, t: torch.Tensor, keep: bool) -> torch.Tensor | None:
    """This rank's slice of a parameter-shaped leaf (a list leaf as its
    (L, ...) stack) gathered over the groups its spec shards it on, on the
    host (None where not ``keep``)."""
    t = t.detach()
    for axis, group in _shard_groups(model).items():
        if axis in spec and group is not None:
            t = primitives.hom_all_gather(t.contiguous(), group, spec.index(axis))
    return t.cpu() if keep else None


def _local_leaf(model: Model, spec: tuple, t: torch.Tensor) -> torch.Tensor:
    """The slice of a global parameter-shaped leaf this rank holds, as
    ``Model.set_params`` cuts it."""
    for axis, group in _shard_groups(model).items():
        if axis in spec and group is not None:
            t = t.chunk(group_size(group), spec.index(axis))[dist.get_rank(group)]
    return t


def _zero_shard(model: Model, tcfg: TrainConfig) -> tuple[int, int, int]:
    """(this rank's index, the shard count, the shard length) of the
    ZeRO-1 master over the (data, model) ranks, the data rank major."""
    groups = _zero_groups(model, tcfg)
    index = 0
    for g in reversed(groups):
        index = index * group_size(g) + (0 if g is None else dist.get_rank(g))
    isize = group_size(groups[1])
    per = coll._zero1_layout(model.train_leaves(), isize).padded_total // isize
    return index, math.prod(group_size(g) for g in groups), per


def _nest(flat: dict[tuple, Any]) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = v
    return out


def _by_path(tree: dict, prefix: tuple = ()) -> dict[tuple, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_by_path(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _stack(leaf) -> torch.Tensor:
    return torch.stack(list(leaf)) if isinstance(leaf, (list, tuple)) else leaf


def zero_global(model: Model, tcfg: TrainConfig, t: torch.Tensor,
                keep: bool = True) -> torch.Tensor | None:
    """One flat buffer of the ZeRO-1 state (the master or a moment) over
    every (data, model) rank, in that rank order, on the host (None where
    not ``keep``).  Collective over the TP and intra groups."""
    for group in _zero_groups(model, tcfg):
        t = primitives.hom_all_gather(t, group)
    return t.cpu() if keep else None


@torch.no_grad()
def state_tree(model: Model, opt_state, tcfg: TrainConfig,
               keep: bool = True) -> tuple[dict, Any] | None:
    """The global training state on the host, as the reference's ``(params,
    opt)`` checkpoint tree: the parameters as its param dict (the layer
    leaves stacked (L, ...)), each TP and FSDP shard gathered over its
    group; the optimizer state as an ``AdamState`` of parameter-shaped
    moments, or a ``ZeroState`` whose flat buffers are every rank's shard
    of the master in (data, model) rank order; the step an int32.
    Collective: every rank of the model's groups calls it; a rank that
    does not ``keep`` the state (one that does not write it) takes part in
    the gathers and gets None (the CPU tensors of bf16 leaves stay bf16).
    ``opt_state`` None gathers the parameters alone."""
    specs = list(model.param_specs().items())
    leaves = model.train_leaves()
    params = _nest({path: _gathered(model, spec, _stack(leaf), keep)
                    for (path, spec), leaf in zip(specs, leaves)})
    if opt_state is None:
        opt = None
    elif isinstance(opt_state, opt_lib.ZeroState):
        opt = opt_lib.ZeroState(*(zero_global(model, tcfg, t, keep) for t in (
            opt_state.flat_param, opt_state.mu, opt_state.nu)), step=np.int32(opt_state.step))
    else:
        moments = []
        for buf in (opt_state.mu, opt_state.nu):
            per_leaf = _regroup(list(buf), leaves)
            moments.append(_nest({path: _gathered(model, spec, _stack(m), keep)
                                  for (path, spec), m in zip(specs, per_leaf)}))
        opt = opt_lib.AdamState(moments[0], moments[1], np.int32(opt_state.step))
    return (params, opt) if keep else None


def state_like(model: Model, opt_state, tcfg: TrainConfig) -> tuple[dict, Any]:
    """``state_tree``'s shapes and dtypes as meta tensors, with no
    collective: the ``like`` tree of ``CheckpointManager.restore`` for this
    model's groups."""
    sizes = {axis: group_size(g) for axis, g in _shard_groups(model).items()}

    def meta(spec: tuple, t: torch.Tensor, dtype=None) -> torch.Tensor:
        shape = [n * (sizes[spec[d]] if spec[d] in sizes else 1) for d, n in enumerate(t.shape)]
        return torch.empty(shape, dtype=dtype or t.dtype, device="meta")

    specs = list(model.param_specs().items())
    leaves = [torch.empty((len(leaf),) + tuple(leaf[0].shape), dtype=leaf[0].dtype,
                          device="meta") if isinstance(leaf, list) else leaf
              for leaf in model.train_leaves()]
    params = _nest({path: meta(spec, t) for (path, spec), t in zip(specs, leaves)})
    step = np.int32(0)
    if isinstance(opt_state, opt_lib.ZeroState):
        _, n_shards, per = _zero_shard(model, tcfg)
        flat = torch.empty((n_shards * per,), dtype=torch.float32, device="meta")
        return params, opt_lib.ZeroState(flat, flat, flat, step)
    mom = _nest({path: meta(spec, t, torch.float32) for (path, spec), t in zip(specs, leaves)})
    return params, opt_lib.AdamState(mom, mom, step)


def state_shardings(model: Model, opt_state, tcfg: TrainConfig) -> tuple[dict, Any]:
    """For each leaf of ``state_like``: a function from the global host
    tensor to this rank's slice on the model's device, in the leaf's
    dtype (the ``shardings`` of ``CheckpointManager.restore``), so that a
    restore holds one global leaf at a time.  A ZeRO-1 master laid out for
    another world raises ``ValueError``."""
    dev = model.init_device

    def param(spec):
        return lambda t: _local_leaf(model, spec, t).to(dev, copy=True)

    specs = model.param_specs()
    params = _nest({path: param(spec) for path, spec in specs.items()})
    if isinstance(opt_state, opt_lib.ZeroState):
        index, n_shards, per = _zero_shard(model, tcfg)

        def shard(t):
            if t.numel() != per * n_shards:
                raise ValueError(f"ZeRO-1 master of {t.numel()} values is not {n_shards} "
                                 f"shard(s) of {per}: laid out for another world")
            return t.reshape(-1)[index * per:(index + 1) * per].to(dev, torch.float32,
                                                                     copy=True)
        return params, opt_lib.ZeroState(shard, shard, shard, lambda t: t)
    mom = _nest({path: param(spec) for path, spec in specs.items()})
    return params, opt_lib.AdamState(mom, mom, lambda t: t)


@torch.no_grad()
def load_state(model: Model, state: tuple[dict, Any], tcfg: TrainConfig,
               sliced: bool = False):
    """Adopt a training state (``state_tree``'s form) on this rank: the
    model's parameters become its slices of the param tree (copied in
    place where the model already holds parameters of those shapes, else
    set anew), and the returned optimizer state is this rank's slice of the
    moments or of the ZeRO-1 master (None for an optimizer state of None:
    the parameters alone).  ``state`` is global, on the host; with
    ``sliced`` its leaves are already this rank's slices on the model's
    device (a restore through ``state_shardings``).  A ZeRO-1 master laid
    out for another world raises ``ValueError``."""
    params, opt = state
    by_path = _by_path(params)

    def local(spec, t):
        return t if sliced else _local_leaf(model, spec, t)

    specs = model.param_specs() if hasattr(model, "_specs") else {}
    leaves = model.train_leaves() if specs else []
    if specs and all(tuple(local(spec, by_path[path]).shape) == tuple(_stack(leaf).shape)
                     for (path, spec), leaf in zip(specs.items(), leaves)):
        for (path, spec), leaf in zip(specs.items(), leaves):
            value = local(spec, by_path[path])
            parts = list(leaf) if isinstance(leaf, list) else [leaf]
            for p, v in zip(parts, value.unbind(0) if isinstance(leaf, list) else [value]):
                p.copy_(v)
    elif sliced:
        raise ValueError("load_state: sliced leaves need a model holding parameters of "
                         "their shapes")
    else:
        dev = model.init_device
        tree = {k: (v.to(dev, copy=True) if isinstance(v, torch.Tensor) else
                    _nest({q: t.to(dev, copy=True) for q, t in _by_path(v).items()}))
                for k, v in params.items() if k not in STACKED}
        for key in STACKED:
            if key in params:
                stacked = _by_path(params[key])
                n = next(iter(stacked.values())).shape[0]
                tree[key] = [_nest({q: t[i].to(dev, copy=True) for q, t in stacked.items()})
                             for i in range(n)]
        model.set_params(tree)
    if opt is None:
        return None
    step = int(opt.step)
    if not sliced:
        fns = state_shardings(model, opt, tcfg)[1]
        opt = tree_lib.unflatten(opt, [f(x) for f, x in zip(tree_lib.leaves(fns),
                                                              tree_lib.leaves(opt))])
    if isinstance(opt, opt_lib.ZeroState):
        return opt_lib.ZeroState(opt.flat_param, opt.mu, opt.nu, step=step)
    moments = []
    for tree in (opt.mu, opt.nu):
        flat_m = _by_path(tree)
        out = []
        for path, leaf in zip(model.param_specs(), model.train_leaves()):
            out.extend(flat_m[path].unbind(0) if isinstance(leaf, list) else [flat_m[path]])
        moments.append(out)
    return opt_lib.AdamState(moments[0], moments[1], step)
