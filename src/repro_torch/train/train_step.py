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
  hier_zero1
        hier's breakdown fused with ZeRO-1: ReduceScatterH leaves each
        rank the f32 shard of the summed gradients, which feeds the
        flat-shard AdamW directly; the deferred end AllGather doubles as
        the parameter reconstruction.  The master and the moments live
        on the 1/intra_size shard (``zero_bootstrap`` builds them).

The other modes of the reference (``hier_overlap``, ``fsdp``) raise
``NotImplementedError``.

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
from repro_torch.core.collectives import CommConfig
from repro_torch.core.schedule import STRUCTURAL_MODES, build_schedule
from repro_torch.models.model import Model
from repro_torch.parallel.sharding import Runtime, group_size
from . import loss as loss_lib
from . import optimizer as opt_lib

PORTED_MODES = ("flat", "hier", "hier_pipelined", "hier_border_rs", "hier_zero1")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    comm_mode: str = "hier"
    dcn_compression: str | None = None  # None|bf16|int8 (pod hop only)
    n_chunks: int = 4                   # hier_pipelined's chunks; aligns the packed layout
    # per-pod gradient weights (mean 1 over pods) for an uneven batch split
    cluster_weights: tuple[float, ...] | None = None
    finite_gate: bool = True
    opt: opt_lib.OptConfig = dataclasses.field(default_factory=opt_lib.OptConfig)

    def comm_config(self, rt: Runtime) -> CommConfig:
        if self.comm_mode not in PORTED_MODES:
            raise NotImplementedError(
                f"comm_mode {self.comm_mode!r} is not ported yet; the port "
                f"runs {PORTED_MODES}")
        mode = STRUCTURAL_MODES.get(self.comm_mode, self.comm_mode)
        build_schedule("all_reduce", mode, self.n_chunks, self.dcn_compression)
        return CommConfig(mode=mode, pod_group=rt.pod_group,
                          intra_group=rt.data_group, dp_group=rt.dp_group,
                          n_chunks=self.n_chunks,
                          compression=self.dcn_compression,
                          cluster_weights=self.cluster_weights)


def _global_grad_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """L2 norm over the (replicated) gradient leaves, summed in f32."""
    total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for g in grads:
        total = total + g.float().square().sum()
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
        with torch.enable_grad():
            logits = model.apply_train(batch["tokens"])
            lval, metrics = loss_lib.sharded_xent(logits, batch["labels"], rt,
                                                  model.cfg.vocab_size)
            del logits
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
        else:
            with torch.profiler.record_function("grad_sync"):
                if rt.dp_group is not None:
                    synced = coll.tree_hier_psum(grads, ccfg)
                else:
                    synced = [torch.stack(g) if isinstance(g, list) else g
                              for g in grads]
                del grads
            with torch.profiler.record_function("grad_norm"):
                gnorm = _global_grad_norm(synced) / n_dp
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
                opt_lib.adam_update(_expand(synced, leaves), opt_state, params,
                                    decay, tcfg.opt, clip / n_dp)
        return out

    return step_fn, init_fn
