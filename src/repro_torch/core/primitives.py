"""Cluster-level primitives (paper §4.2.2, Table 4) over process groups.

The counterpart of the JAX package's ``core/primitives.py``: where the
reference names a mesh axis inside ``shard_map``, these take a
``torch.distributed`` group, and ``None`` stands for a group of one.

  * ``homColl`` -> native collectives over the intra-cluster ("data")
                   group: NVLink through NCCL on the card, gloo on the CPU.
  * ``c2cCpy``  -> the ring gather over the pod group (``c2c_cpy``): each
                   rank forwards one shard-sized message per hop.
  * ``c2cRed``  -> the combining step over the pod group: the native
                   all-reduce (``c2c_red``), or the mechanism-faithful
                   reduce ring (``c2c_red_ring``).
  * ``SendRecv`` -> one hop around the pod ring (``c2c_send_recv``, the
                   PP handoff); ``BcastH`` -> the root's value forwarded
                   around it (``c2c_bcast``).

  * ``hom_all_to_all`` -> the native exchange (``all_to_all_single``),
                   the reference's tiled ``lax.all_to_all``, differentiable.

A collective over a group of one is the identity and issues no call, as
a reduction over an axis of size one is in the reference.  The
primitives consume their input: an all-reduce sums it in place (every
caller owns a freshly packed or computed buffer), so the payload is
never copied.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import group_size


# ---------------------------------------------------------------------------
# Fault-injection hook (the chaos engine's seam)
# ---------------------------------------------------------------------------
#
# The executors (core/collectives.py, core/pipelined.py) pass every payload
# about to enter a transport phase through ``apply_inject(buf, phase)``,
# the identity when no hook is installed.  The chaos engine
# (runtime/faults.py) installs a hook that corrupts payloads (NaN
# gradients, bit-flipped int8 blocks).  The reference corrupts at trace
# time, inside the step it builds under the hook; the port runs eagerly,
# so the hook acts on the calls made while it is installed, in execution
# order.
#
# Phases: "flat" (the flat psum's input), "intra_rs" (before the intra
# ReduceScatter), "c2c" (before a C2C reduce or copy), "chunk_c2c" (the
# encoded chunk entering the pipelined C2C transfer: for int8 the
# (q, scale) pair, which is how a bit flip lands in a real int8 block).

_INJECT_HOOK = None


@contextlib.contextmanager
def inject_hook(fn):
    """Install ``fn(buf, phase) -> buf`` as the payload hook for the
    duration of the context; contexts nest, and the one outside is back
    on exit."""
    global _INJECT_HOOK
    prev = _INJECT_HOOK
    _INJECT_HOOK = fn
    try:
        yield
    finally:
        _INJECT_HOOK = prev


def apply_inject(buf, phase: str):
    """Pass a payload through the installed hook (identity when none is
    installed).  ``phase`` names the transfer point, as in the
    reference."""
    if _INJECT_HOOK is None:
        return buf
    return _INJECT_HOOK(buf, phase)


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


def hom_all_gather(x: torch.Tensor, group, gather_dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``gather_dim``, in rank order
    (the reference's tiled ``all_gather``)."""
    n = group_size(group)
    if n == 1:
        return x
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    if gather_dim == 0:
        return out
    return torch.cat(out.view((n,) + tuple(x.shape)).unbind(0), dim=gather_dim)


def _exchange(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """The tiled all-to-all: ``x`` cut into n blocks along ``split_dim``,
    block i sent to group rank i, and the blocks received concatenated
    along ``concat_dim`` in source rank order.  The exchange runs on dim 0
    (``split_dim`` moved to the front), then the received blocks are laid
    along ``concat_dim``."""
    n = group_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} over {n} ranks")
    front = x.movedim(split_dim, 0).contiguous()
    out = torch.empty_like(front)
    dist.all_to_all_single(out, front, group=group)
    # out: [source, block of split_dim, rest of x's dims in front's order]
    blocks = out.view((n, front.shape[0] // n) + tuple(front.shape[1:])).movedim(1, split_dim + 1)
    return torch.cat(blocks.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    """The exchange whose backward is the exchange with split and concat
    swapped, as ``lax.all_to_all`` transposes."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
        ctx.args = (group, split_dim, concat_dim)
        return _exchange(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        group, split_dim, concat_dim = ctx.args
        return _exchange(g, group, concat_dim, split_dim), None, None, None


def hom_all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """The reference's ``lax.all_to_all(x, axis, split_dim, concat_dim,
    tiled=True)`` over ``group`` (for the reference's pair of axes, one
    group of pod x intra ranks in pod-major order); the identity over a
    group of one."""
    if group_size(group) == 1:
        return x
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def c2c_red(x: torch.Tensor, group) -> torch.Tensor:
    """Combining C2C step: the native all-reduce over the pod group."""
    return _all_reduce(x, group)


def c2c_cpy(x: torch.Tensor, group) -> torch.Tensor:
    """Cluster-to-cluster copy: ring-gather every pod's ``x`` over the pod
    group.  Returns ``(n_pods, *x.shape)`` stacked in pod order.  Each
    rank forwards one ``x``-sized message per hop, so (n_pods - 1) *
    x.nbytes crosses between clusters per rank, the Table-7 AllGather
    volume."""
    n = group_size(group)
    if n == 1:
        return x[None]
    my = dist.get_rank(group)
    slots, cur = [x], x
    for _ in range(n - 1):
        (cur,) = shift([cur], group)
        slots.append(cur)                   # slot j: pod (my - j) % n
    return torch.stack([slots[(my - i) % n] for i in range(n)])


def c2c_red_ring(x: torch.Tensor, group) -> torch.Tensor:
    """Mechanism-faithful c2cRed: a reduce ring over the pod group.  Each
    hop passes the shard it last received on to the next cluster, which
    accumulates it (paper Fig. 8).  Sums ``x`` in place."""
    n = group_size(group)
    cur = x
    for _ in range(n - 1):
        (cur,) = shift([cur], group)
        x += cur
    return x


def shift(tensors: list[torch.Tensor], group, by: int = 1) -> list[torch.Tensor]:
    """Send each tensor to group rank (r + by) % n and receive the same
    shapes from (r - by) % n, in one ``batch_isend_irecv`` (the
    reference's ring ``ppermute``).  With a group of one, or a shift that
    is a multiple of n, the permutation is the identity and the tensors
    come back as they are.  gloo sends and receives host memory only (its
    collectives stage a CUDA tensor themselves, its send and receive do
    not), so under a gloo group a CUDA tensor crosses through a host copy:
    the ranks that share one card over gloo."""
    n = group_size(group)
    if by % n == 0:
        return tensors
    r = dist.get_rank(group)
    dst = dist.get_global_rank(group, (r + by) % n)
    src = dist.get_global_rank(group, (r - by) % n)
    device = tensors[0].device
    staged = device.type == "cuda" and dist.get_backend(group) == "gloo"
    wire = [t.contiguous().cpu() if staged else t.contiguous() for t in tensors]
    received = [torch.empty_like(t) for t in wire]
    ops = ([dist.P2POp(dist.isend, t, dst, group) for t in wire]
           + [dist.P2POp(dist.irecv, t, src, group) for t in received])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [t.to(device) for t in received] if staged else received


def c2c_send_recv(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Heterogeneous SendRecv between adjacent clusters (the PP handoff):
    ``x`` to pod group rank (r + shift) % n, and the tensor of rank
    (r - shift) % n back, as the reference's ring ``ppermute``.  A group
    of one returns ``x``."""
    (out,) = _ring_shift([x], group, shift)
    return out


def c2c_bcast(x: torch.Tensor, group, root: int = 0) -> torch.Tensor:
    """Broadcast the root cluster's ``x`` to every cluster of ``group``
    (``root`` a rank of the group): n - 1 hops around the ring, in each of
    which every rank passes on what it holds and every rank but the root
    takes what it received, hop for hop as the reference does (Table 7's
    BcastH).  A group of one returns ``x``."""
    n = group_size(group)
    if n == 1:
        return x
    is_root = dist.get_rank(group) == root
    cur = x
    for _ in range(n - 1):
        nxt = c2c_send_recv(cur, group)
        cur = x if is_root else nxt
    return cur


_ring_shift = shift     # ``c2c_send_recv``'s parameter shadows the name
