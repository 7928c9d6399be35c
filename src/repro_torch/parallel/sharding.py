"""Distribution context for the model code: process groups in place of
the JAX package's mesh axis names.

``Runtime`` carries one ``torch.distributed`` process group per role
(``None`` is a group of one): tensor parallel ("model"), the cluster
("pod"), the intra-cluster data-parallel group ("data") and the group
of every data-parallel rank (the reference's ``dp_axes``, pod x data),
and the group the FSDP shards of the layer parameters live on
(``fsdp_group``, the data group when FSDP is on).  The MoE knobs come
with their slice.  ``copy_to_tp``/``reduce_from_tp`` mark
the edges of a tensor-parallel region as in the JAX package; at a TP
group of one they are the identity, and tensor parallelism across
processes is not ported yet, so a larger group raises.  Kernels are chosen by the
device of the tensor they get, so there is no ``use_pallas`` switch.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Static distribution context threaded through the model code."""

    tp_group: Any = None            # tensor-parallel group ("model")
    pod_group: Any = None           # cluster group ("pod"): the KV-transfer ring
    data_group: Any = None          # intra-cluster data-parallel group ("data")
    dp_group: Any = None            # every data-parallel rank (pod x data)
    fsdp_group: Any = None          # FSDP shard group ("data"), or None: no FSDP


def group_size(group) -> int:
    """World size of ``group``; ``None`` (no group) counts as one."""
    return 1 if group is None else dist.get_world_size(group)


def _single(group, what: str) -> None:
    if group_size(group) != 1:
        raise NotImplementedError(
            f"{what} over a tensor-parallel group larger than one is not "
            f"ported yet")


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Entry of a TP region (forward identity)."""
    _single(group, "copy_to_tp")
    return x


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Exit of a row-parallel product (forward sum over the TP group)."""
    _single(group, "reduce_from_tp")
    return x


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


class _FsdpGather(torch.autograd.Function):
    """Tiled all-gather along ``dim`` over ``group``, in group-rank order;
    its backward is the reduce-scatter (sum) of the cotangent along the
    same dim, as the reference's all_gather transposes to psum_scatter.
    The collectives run on dim 0: another dim is moved to the front."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int, group) -> torch.Tensor:
        ctx.dim, ctx.group = dim, group
        front = _to_front(x, dim)
        out = front.new_empty((group_size(group) * front.shape[0],) + front.shape[1:])
        dist.all_gather_into_tensor(out, front, group=group)
        return out.movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        front = _to_front(g, ctx.dim)
        out = front.new_empty((front.shape[0] // group_size(ctx.group),) + front.shape[1:])
        dist.reduce_scatter_tensor(out, front, group=ctx.group)
        return out.movedim(0, ctx.dim).contiguous(), None, None


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
        return params if dims < 0 else _FsdpGather.apply(params, dims, group)
    return {k: fsdp_gather(v, dims[k], group) for k, v in params.items()}
