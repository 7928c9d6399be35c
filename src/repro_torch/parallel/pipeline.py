"""GPipe pipeline parallelism over the pod group.

The paper's own end-to-end training setup (Appendix B, Table 8) places
pipeline stages across the vendor groups and data parallelism inside
each: the stage handoff puts only microbatch activations on the slow
links between clusters.  The pod group is the pipeline dimension, a stage
handoff is one ring shift over it (``core.primitives.shift``, HetCCL's
SendRecv), and TP and DP stay inside a pod.

SPMD GPipe, the JAX package's schedule slot for slot: every pod steps a
shared schedule of T = M + S - 1 slots (M microbatches, S stages), and
pod p is active in slots [p, p + M).  Every pod computes its stage in
every slot and masks the inactive ones (the bubble, (S - 1) / (M + S - 1)
of the step).  The backward is autograd's: each shift's backward is the
shift the other way round the ring, the transpose of the reference's
``ppermute``.  A pod issues one shift per slot in the forward and one in
the backward whatever it computes, so the masks are tensors: a branch on
the host would cut a pod's unused values out of its graph, and its
backward would then skip shifts its neighbours wait for.

The caller gives ``stage_fn`` this pod's slice of the layers (the
reference shards the stacked L dim over "pod").  No launcher runs PP, as
in the reference, whose only user is its check script.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.primitives import shift
from .sharding import Runtime, group_size, reduce_from_tp


def _pod_index(rt: Runtime) -> int:
    return 0 if rt.pod_group is None else dist.get_rank(rt.pod_group)


class _RingShift(torch.autograd.Function):
    """Forward: send to the next pod and receive from the previous one.
    Backward: the cotangent goes the other way round the ring."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return shift([x], group, by=1)[0]

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return shift([g], ctx.group, by=-1)[0], None


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """The stage handoff: ``x`` from pod (p - 1) % n arrives at pod p;
    the identity over a group of one."""
    return x if group_size(group) == 1 else _RingShift.apply(x, group)


def gpipe_apply(stage_fn, x_micros: torch.Tensor, rt: Runtime, n_stages: int) -> torch.Tensor:
    """Run microbatches through the pod pipeline.

    stage_fn: (x (Bm, S, D)) -> (Bm, S, D), this pod's layer slice.
    x_micros: (M, Bm, S, D); only stage 0's value is consumed.
    Returns (M, Bm, S, D): stage (n_stages - 1)'s outputs, zeros on the
    other pods (mask downstream with ``pp_loss_mask``)."""
    M = x_micros.shape[0]
    p = _pod_index(rt)
    dev = x_micros.device

    def flag(b: bool) -> torch.Tensor:
        return torch.tensor(b, device=dev)

    first, last = flag(p == 0), flag(p == n_stages - 1)
    buf = torch.zeros_like(x_micros[0])          # the activation in flight
    outs = list(torch.zeros_like(x_micros).unbind(0))
    for t in range(M + n_stages - 1):
        recv = ring_shift(buf, rt.pod_group)
        feed = torch.where(first, x_micros[min(max(t, 0), M - 1)], recv)
        active = flag(p <= t < p + M)
        out = torch.where(active, stage_fn(feed), torch.zeros_like(feed))
        slot = min(max(t - (n_stages - 1), 0), M - 1)
        outs[slot] = torch.where(active & last, out, outs[slot])
        buf = out
    return torch.stack(outs)


def pp_loss_mask(value: torch.Tensor, rt: Runtime, n_stages: int) -> torch.Tensor:
    """Keep the last stage's value, zero elsewhere, and sum it over the pod
    group, so every pod sees one scalar; the sum's backward is the
    identity (``reduce_from_tp``), as the reference's wrapper gives: a raw
    sum's transpose would re-sum the cotangent and over-count."""
    keep = torch.tensor(_pod_index(rt) == n_stages - 1, device=value.device)
    return reduce_from_tp(torch.where(keep, value, torch.zeros_like(value)), rt.pod_group)
