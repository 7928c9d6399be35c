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

Each process holds one replica of the model (``Model`` on its device)
and its slice of the global batch.  The step updates the parameters and
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
    # per-pod gradient weights (mean 1 over pods) for an uneven batch split
    cluster_weights: tuple[float, ...] | None = None
    finite_gate: bool = True
    opt: opt_lib.OptConfig = dataclasses.field(default_factory=opt_lib.OptConfig)

    def comm_config(self, rt: Runtime) -> CommConfig:
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


def _global_grad_norm(grads: list[torch.Tensor], sharded: list[bool] | None = None,
                      fsdp_group=None) -> torch.Tensor:
    """L2 norm over the gradient leaves, summed in f32: the squares of the
    FSDP-sharded leaves (``sharded``) are summed over ``fsdp_group``, the
    replicated leaves' are not (the reference sums per set of axes)."""
    parts: dict[bool, torch.Tensor] = {}
    for g, s in zip(grads, sharded or [False] * len(grads)):
        key = s and fsdp_group is not None
        val = g.float().square().sum()
        parts[key] = parts[key] + val if key in parts else val
    total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for key, val in parts.items():
        total = total + (primitives.hom_psum(val, fsdp_group) if key else val)
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


def fsdp_sync(g, is_sharded: bool, ccfg: CommConfig, rt: Runtime) -> torch.Tensor:
    """fsdp's sync of one leaf's gradient (a list leaf as its stack): a
    sharded leaf arrives reduce-scattered over data (the gather's
    backward), so only the pod hop is left, with ``ccfg``'s codec; a
    replicated leaf goes through AllReduceH alone."""
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
    as Python numbers: loss, grad_norm, mean_logp and ``gated`` (the
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
        overlap = (overlap_lib.BucketSync(model.param_tree(), ccfg, tcfg.bucket_cap_mb << 20)
                   if overlapped else None)
        sharded = ["data" in spec for spec in model.param_specs().values()]
        with torch.enable_grad():
            logits = model.apply_train(batch["tokens"])
            lval, metrics = loss_lib.sharded_xent(logits, batch["labels"], rt,
                                                  model.cfg.vocab_size)
            del logits
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
            # the norm of the pod-summed shard: sum over the intra group only
            with torch.profiler.record_function("grad_norm"):
                sq = _sq_norm(shard)
                if group_size(ccfg.intra_group) > 1:
                    dist.all_reduce(sq, group=ccfg.intra_group)
                gnorm = torch.sqrt(sq) / n_dp
        elif overlap is not None:
            synced = grads           # one per parameter, synced in the backward
            del grads
            with torch.profiler.record_function("grad_norm"):
                gnorm = _global_grad_norm(synced) / n_dp
        else:
            with torch.profiler.record_function("grad_sync"):
                if fsdp:
                    # leaf by leaf, each released once synced
                    synced = []
                    for i, is_sharded in enumerate(sharded):
                        g, grads[i] = grads[i], None
                        synced.append(fsdp_sync(g, is_sharded, ccfg, rt))
                        del g
                elif rt.dp_group is not None:
                    synced = coll.tree_hier_psum(grads, ccfg)
                else:
                    synced = [torch.stack(g) if isinstance(g, list) else g
                              for g in grads]
                del grads
            with torch.profiler.record_function("grad_norm"):
                gnorm = _global_grad_norm(synced, sharded, rt.fsdp_group) / n_dp
        clip = torch.clamp(tcfg.opt.grad_clip / (gnorm + 1e-9), max=1.0)

        m = torch.stack([lval.detach().float(), gnorm / n_dp,
                         metrics["mean_logp"].detach().float()])
        if n_dp > 1:
            dist.all_reduce(m, group=rt.dp_group)
        m = (m / n_dp).tolist()
        out = dict(zip(("loss", "grad_norm", "mean_logp"), m))
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
