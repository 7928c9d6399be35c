"""The data-parallel training step, its gradients synced by the HetCCL
hierarchical collectives (the JAX package's ``train/train_step.py``).

Communication modes (``TrainConfig.comm_mode``) ported here:

  flat  replicated params; one all-reduce over (pod, data) for the gradients
        (the homogeneous-library emulation, the baseline).
  hier  the paper's AllReduceH: ReduceScatter(intra) -> c2cRed(pod,
        optionally bf16 or int8 on the wire) -> AllGather(intra), over
        the packed gradient buffer (Alg. 1, Table 7).

The other modes of the reference (``hier_pipelined``, ``hier_border_rs``,
``hier_overlap``, ``hier_zero1``, ``fsdp``) raise ``NotImplementedError``.

Each process holds one replica of the model (``Model`` on its device)
and its slice of the global batch.  The step updates the parameters and
the Adam state in place.  With ``finite_gate`` a step whose synced loss
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

PORTED_MODES = ("flat", "hier")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    comm_mode: str = "hier"
    dcn_compression: str | None = None  # None|bf16|int8 (pod hop only)
    n_chunks: int = 4                   # aligns the packed layout as the reference does
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


def make_train_step(model: Model, tcfg: TrainConfig):
    """Returns (step_fn, init_fn).

    ``init_fn(seed)`` draws the model's parameters from ``seed`` and
    returns a fresh ``AdamState``.  ``step_fn(opt_state, batch)`` takes
    this rank's ``{"tokens", "labels"}`` (B, S) tensors on the model's
    device, runs forward, backward, gradient sync and the update in
    place, and returns the metrics synced over the data-parallel group
    as Python numbers: loss, grad_norm, mean_logp and ``gated`` (the
    finite gate skipped the update).  Without a data-parallel group there
    is no sync (the reference's single-device step)."""
    rt = model.rt
    ccfg = tcfg.comm_config(rt)
    n_dp = group_size(rt.dp_group)

    def init_fn(seed: int = 0) -> opt_lib.AdamState:
        model.init(seed)
        params, _ = opt_lib.flat_params(model.train_leaves())
        return opt_lib.adam_init(params)

    def step_fn(opt_state: opt_lib.AdamState, batch: dict) -> dict[str, Any]:
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
        with torch.profiler.record_function("grad_sync"):
            if rt.dp_group is not None:
                synced = coll.tree_hier_psum(grads, ccfg)
            else:
                synced = [torch.stack(g) if isinstance(g, list) else g for g in grads]
            del grads
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
        if not out["gated"]:
            with torch.profiler.record_function("optimizer"):
                opt_lib.adam_update(_expand(synced, leaves), opt_state, params,
                                    decay, tcfg.opt, clip / n_dp)
        return out

    return step_fn, init_fn
