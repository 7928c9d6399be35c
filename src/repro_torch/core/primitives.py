"""Cluster-level primitives (paper §4.2.2, Table 4) over process groups.

The counterpart of the JAX package's ``core/primitives.py``: where the
reference names a mesh axis inside ``shard_map``, these take a
``torch.distributed`` group, and ``None`` stands for a group of one.

  * ``homColl`` -> native collectives over the intra-cluster ("data")
                   group: NVLink through NCCL on the card, gloo on the CPU.
  * ``c2cRed``  -> the combining step over the pod group (the native
                   all-reduce).

A collective over a group of one is the identity and issues no call, as
a reduction over an axis of size one is in the reference.  The
primitives consume their input: an all-reduce sums it in place (every
caller owns a freshly packed or computed buffer), so the payload is
never copied.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import group_size


def apply_inject(buf: torch.Tensor, phase: str) -> torch.Tensor:
    """The chaos engine's payload seam (identity: its hook is not ported
    yet).  ``phase`` names the transfer point, as in the reference."""
    return buf


def axis_size(group) -> int:
    return group_size(group)


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    if group_size(group) > 1:
        x = x.contiguous()
        dist.all_reduce(x, op=op, group=group)
    return x


def hom_psum(x: torch.Tensor, group) -> torch.Tensor:
    return _all_reduce(x, group)


def hom_reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """Flat ``x`` (size divisible by the group) -> this rank's summed
    1/n shard, in rank order (the reference's tiled ``psum_scatter``)."""
    n = group_size(group)
    if n == 1:
        return x
    if x.numel() % n:
        raise ValueError(f"reduce_scatter: {x.numel()} elements over {n} ranks")
    out = torch.empty((x.numel() // n,), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
    return out


def hom_all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Flat shard -> the concatenation of every rank's shard, in rank order."""
    n = group_size(group)
    if n == 1:
        return x
    out = torch.empty((n * x.numel(),), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def c2c_red(x: torch.Tensor, group) -> torch.Tensor:
    """Combining C2C step: the native all-reduce over the pod group."""
    return _all_reduce(x, group)


def shift(tensors: list[torch.Tensor], group, by: int = 1) -> list[torch.Tensor]:
    """Send each tensor to group rank (r + by) % n and receive the same
    shapes from (r - by) % n, in one ``batch_isend_irecv`` (the
    reference's ring ``ppermute``).  With a group of one, or a shift that
    is a multiple of n, the permutation is the identity and the tensors
    come back as they are."""
    n = group_size(group)
    if by % n == 0:
        return tensors
    r = dist.get_rank(group)
    dst = dist.get_global_rank(group, (r + by) % n)
    src = dist.get_global_rank(group, (r - by) % n)
    received = [torch.empty_like(t) for t in tensors]
    ops = ([dist.P2POp(dist.isend, t.contiguous(), dst, group) for t in tensors]
           + [dist.P2POp(dist.irecv, t, src, group) for t in received])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return received
