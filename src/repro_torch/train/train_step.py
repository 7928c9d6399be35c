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

import torch
import torch.distributed as dist

from repro_torch.core import collectives as coll
from repro_torch.core import compression, primitives
from repro_torch.core import overlap as overlap_lib
from repro_torch.core.collectives import CommConfig
from repro_torch.core.planner import BoundPlan
from repro_torch.core.schedule import STRUCTURAL_MODES, build_schedule
from repro_torch.kernels import quant as _qk
from repro_torch.models.model import Model
from repro_torch.parallel.sharding import Runtime, group_size
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
    device, runs forward, backward, gradient sync and the update in
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
            logits, aux = model.apply_train(batch["tokens"])
            lval, metrics = loss_lib.sharded_xent(logits, batch["labels"], rt,
                                                  model.cfg.vocab_size, tcfg.z_loss)
            del logits
            lval = lval + tcfg.aux_weight * aux
            if overlap is not None:
                # the gradients come back synced, bucket by bucket
                with overlap.attached():
                    grads = list(torch.autograd.grad(lval, params))
            else:
                grads = _regroup(torch.autograd.grad(lval, params), leaves)

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
        m = (m / n_dp).tolist()
        out = dict(zip(("loss", "grad_norm", "aux", "mean_logp"), m))
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
