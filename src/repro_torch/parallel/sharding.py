"""Distribution context for the model code: process groups in place of
the JAX package's mesh axis names.

``Runtime`` carries one ``torch.distributed`` process group per role
(``None`` is a group of one): tensor parallel ("model"), the cluster
("pod"), the intra-cluster data-parallel group ("data") and the group
of every data-parallel rank that shares this rank's model index (the
reference's ``dp_axes``, pod x data), and the group the FSDP shards of
the layer parameters live on (``fsdp_group``, the data group when FSDP
is on); ``sp`` turns on Megatron sequence parallelism; ``remat_policy``
is what the decoder stack's checkpoint keeps (``remat_policy_for``):
``"none"`` recomputes the whole layer in the backward, and
``"save_collectives"`` keeps the output of each ``reduce_from_tp`` but
a layer's last (``reduce_from_tp(..., last=True)``), so the recompute
does not run its all-reduce again.  The MoE knobs
are the reference's: the expert capacity factor, the All2All schedule
mode of the expert-parallel dispatch and combine, the cluster group of
that exchange (``None`` on every mesh the launchers build: experts shard
over the TP group only) and the per-cluster capacity weights.  Kernels
are chosen by the device of the tensor they get, so there is no
``use_pallas`` switch.

The collectives below carry the reference's autodiff semantics.  Its
model code runs inside ``shard_map`` without replication checks, where
every device differentiates its own copy of the loss and a raw
collective transposes to its mirror: ``psum`` to ``psum``, a tiled
``all_gather`` to ``psum_scatter`` and back.  ``copy_to_tp`` and
``reduce_from_tp`` override that with custom VJPs (forward identity /
backward sum, forward sum / backward identity).  Each is a
``torch.autograd.Function`` here, so every rank's backward issues the
same collectives the reference's transposes do.  With a group of
``None`` each is the identity.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.distributed as dist
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Static distribution context threaded through the model code."""

    tp_group: Any = None            # tensor-parallel group ("model")
    pod_group: Any = None           # cluster group ("pod"): the KV-transfer ring
    data_group: Any = None          # intra-cluster data-parallel group ("data")
    dp_group: Any = None            # every data-parallel rank (pod x data)
    fsdp_group: Any = None          # FSDP shard group ("data"), or None: no FSDP
    sp: bool = False                # Megatron sequence parallelism
    remat_policy: str = "none"      # none | save_collectives
    moe_capacity_factor: float = 1.25
    # MoE expert-parallel dispatch/combine (models/moe.py's ep path): the
    # planner-chosen All2All schedule mode, the cluster group of the ep
    # exchange (None: one cluster, the TP group alone) and the skew
    # per-cluster weights steering expert capacity
    moe_a2a_mode: str = "flat"
    moe_a2a_pod_group: Any = None
    moe_cluster_weights: tuple[float, ...] | None = None

    @property
    def tp(self) -> int:
        return group_size(self.tp_group)

    @property
    def tp_rank(self) -> int:
        return 0 if self.tp_group is None else dist.get_rank(self.tp_group)


def group_size(group) -> int:
    """World size of ``group``; ``None`` (no group) counts as one."""
    return 1 if group is None else dist.get_world_size(group)


def _summed(x: torch.Tensor, group, kept: bool = True) -> torch.Tensor:
    """A new tensor: ``x`` summed over ``group``.  ``kept``: by the
    out-of-place functional all-reduce, an op whose output selective
    checkpointing can keep (``remat_policy_for``); otherwise by the
    in-place ``dist.all_reduce`` into a clone, an op it does not keep."""
    if not kept:
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out
    out = torch.ops._c10d_functional.all_reduce(x.contiguous(), "sum", group.group_name)
    return torch.ops._c10d_functional.wait_tensor(out)


# the ops of ``_summed``: inside a checkpointed layer only ``reduce_from_tp``
# issues them (``copy_to_tp``'s sum runs in the backward)
_TP_COLLECTIVE_OPS = frozenset({torch.ops._c10d_functional.all_reduce.default,
                                torch.ops._c10d_functional.wait_tensor.default})
REMAT_POLICIES = ("none", "save_collectives")


def _save_tp_collective(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _TP_COLLECTIVE_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_policy_for(rt: Runtime):
    """The ``context_fn`` of ``torch.utils.checkpoint.checkpoint`` for
    ``rt.remat_policy``, or None (recompute everything).
    ``"save_collectives"`` keeps the TP all-reduce's output and recomputes
    everything else, as the reference's ``save_only_these_names
    ("tp_collective")`` keeps the tagged output of its ``reduce_from_tp``,
    but for a layer's last (``reduce_from_tp(..., last=True)``), whose
    output XLA drops as unread: one kept a dense layer (the attention's),
    none an SSM layer.  With no TP group ``reduce_from_tp`` is the identity
    and there is nothing to keep, where the reference keeps the tagged
    row-parallel output all the same."""
    if rt.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat policy {rt.remat_policy!r}: one of {REMAT_POLICIES}")
    if rt.remat_policy == "save_collectives":
        return functools.partial(create_selective_checkpoint_contexts, _save_tp_collective)
    return None


class _CopyToTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _summed(g, ctx.group), None


class _ReduceFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group, last: bool) -> torch.Tensor:
        return _summed(x, group, kept=not last)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Entry of a TP region: forward identity, backward sum over ``group``
    (each shard consumes the same x; their cotangents add up)."""
    return x if group is None else _CopyToTp.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group, last: bool = False) -> torch.Tensor:
    """Exit of a row-parallel product: forward sum over ``group``,
    backward identity.  ``last`` marks a layer's last sum (its MLP, MoE
    block or SSM): its output feeds only the residual add, which no
    backward reads, so it goes through an op ``"save_collectives"`` does
    not keep, and the recompute stops before it (its early stop)."""
    return x if group is None else _ReduceFromTp.apply(x, group, last)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """A raw ``lax.psum`` of the reference: forward sum over ``group``,
    and, as its transpose under ``shard_map`` without replication checks,
    backward sum too (``reduce_from_tp``'s forward, ``copy_to_tp``'s
    backward)."""
    return copy_to_tp(reduce_from_tp(x, group), group)


def tp_entry_group(rt: Runtime):
    """The group for ``copy_to_tp`` at a TP-region entry.  Under sequence
    parallelism the gather/scatter pair already carries the reduction
    (``gather_sp``'s backward is a reduce-scatter); the copy's backward
    sum on top would count the gradient tp times, so SP drops it."""
    return None if rt.sp else rt.tp_group


def gather_sp(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """Sequence parallelism: (B, S/t, D) -> (B, S, D), a tiled all-gather
    along ``dim`` whose backward is the reduce-scatter (sum)."""
    return x if group is None else _Gather.apply(x, dim, group)


def scatter_sp(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """Sequence parallelism: partial sums (B, S, D) -> this rank's reduced
    (B, S/t, D), a reduce-scatter along ``dim`` whose backward is the
    tiled all-gather."""
    return x if group is None else _Scatter.apply(x, dim, group)


# ---------------------------------------------------------------------------
# FSDP parameter gather (per layer, inside the checkpointed layer)
# ---------------------------------------------------------------------------

FSDP_MIN_SIZE = 2 ** 16  # leaves smaller than this stay replicated


def fsdp_dim(global_shape: tuple[int, ...], fsdp_size: int,
             taken_dims: tuple[int, ...] = ()) -> int | None:
    """Choose the dim an FSDP shard lives on: the largest dim divisible
    by the shard count, excluding dims already sharded by TP or the
    stacked-layer dim; None keeps the leaf replicated."""
    if fsdp_size <= 1:
        return None
    size = 1
    for s in global_shape:
        size *= s
    if size < FSDP_MIN_SIZE:
        return None
    cands = [d for d in range(len(global_shape))
             if d not in taken_dims and global_shape[d] % fsdp_size == 0]
    if not cands:
        return None
    return max(cands, key=lambda d: global_shape[d])


def _to_front(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x.movedim(dim, 0).contiguous()


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Tiled all-gather along ``dim``, in group-rank order; the collective
    runs on dim 0 (another dim is moved to the front)."""
    front = _to_front(x, dim)
    out = front.new_empty((group_size(group) * front.shape[0],) + front.shape[1:])
    dist.all_gather_into_tensor(out, front, group=group)
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Reduce-scatter (sum) along ``dim``: this rank's 1/n slice of the sum."""
    front = _to_front(x, dim)
    out = front.new_empty((front.shape[0] // group_size(group),) + front.shape[1:])
    dist.reduce_scatter_tensor(out, front, group=group)
    return out.movedim(0, dim).contiguous()


class _Gather(torch.autograd.Function):
    """Tiled all-gather whose backward is the reduce-scatter of the
    cotangent along the same dim, as the reference's all_gather
    transposes to psum_scatter."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int, group) -> torch.Tensor:
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


class _Scatter(torch.autograd.Function):
    """Reduce-scatter whose backward is the tiled all-gather."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int, group) -> torch.Tensor:
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _all_gather(g, ctx.dim, ctx.group), None, None


def fsdp_gather(params: Any, dims: Any, group) -> Any:
    """All-gather the FSDP-sharded leaves of one layer's param dict.
    ``dims`` mirrors ``params`` with the (local) dim each leaf is sharded
    on, or -1 for a replicated leaf.  Differentiable: the gradient of a
    shard is the reduce-scatter of the gathered leaf's gradient over the
    group (the ZeRO gradient reduce-scatter).  With no group, or no
    sharded leaf, the params come back as they are."""
    if group is None:
        return params
    if isinstance(params, torch.Tensor):
        return params if dims < 0 else _Gather.apply(params, dims, group)
    return {k: fsdp_gather(v, dims[k], group) for k, v in params.items()}
