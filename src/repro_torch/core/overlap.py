"""Overlap-aware gradient communication scheduling (the JAX package's
``core/overlap.py``).

The parameter tree is partitioned into readiness-ordered, size-capped
gradient buckets (``partition_tree``): output-side leaves (lm_head,
final_norm) first, decoder layers in reverse, encoder layers next,
embeddings last.  Each bucket is synced by AllReduceH on its own f32
buffer, laid out by ``packing.plan_bucket_layout`` and aligned for the
schedule the bucket resolves to (``collectives.resolve_config``).

The reference pins the issue order with ``optimization_barrier`` so that
XLA may start bucket i's sync while the backward still produces later
buckets.  The port does it eagerly: ``BucketSync`` hooks every
parameter, counts each bucket down as its gradients arrive inside the
backward, and syncs a bucket as soon as it and every bucket before it
are complete, so every rank issues its collectives in index order.  A
parameter the loss does not read counts its bucket down with a zero
gradient before the backward starts, as the reference syncs the zeros
``jax.grad`` gives it.
``tree_hier_psum_overlap`` is the same sync run after the backward on a
tree of gradients; both write the synced values into the gradients they
are given (the synced buffer is cast back to each leaf's dtype), so the
two give the same bits.

A parameter tree is a dict at the top level (``Model.param_tree()``):
each value a tensor, a dict of subtrees, or, for a stacked key
(``layers``), a list of per-layer dicts standing for the reference's
stacked (L, ...) leaves.  With ``packed=False`` each bucket is
re-flattened into a fresh f32 buffer per sync, the reference's per-leaf
data path, which a plan chooses when packing does not pay.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Sequence

import torch

from . import collectives, packing

# Default per-bucket payload cap.  Large enough that α costs amortize,
# small enough that the first bucket's sync can start well before the
# backward pass finishes (the H2/HETHUB sweet spot is tens of MiB).
DEFAULT_CAP_BYTES = 64 << 20

# Top-level param-tree keys whose gradients only materialize at the very
# end of the backward pass (consumed at the start of the forward pass).
_TAIL_KEYS = ("embed", "pos_emb", "enc_norm")
# Stacked per-layer subtrees, in *forward* order of execution.  Encoder
# runs first in forward, but its cotangents finish accumulating only
# after every decoder cross-attention has back-propagated, so encoder
# buckets sort after the decoder ones in readiness order.
_LAYER_KEYS = ("layers", "enc_layers")


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """One readiness-ordered gradient bucket.

    ``entries`` addresses slices of the top-level tree: ``(key, None,
    None)`` takes the whole subtree under ``key``; ``(key, lo, hi)``
    takes layers ``lo:hi`` of the stacked subtree under ``key``.
    ``nbytes`` is the f32 wire payload of the bucket's flat buffer.
    """

    index: int                       # 0 = first gradients ready
    nbytes: int
    entries: tuple[tuple[str, int | None, int | None], ...]


def tree_leaves(subtree: Any) -> list:
    """The leaves of a subtree in the reference's flatten order (dict
    keys sorted): a tensor is one leaf; a list of per-layer dicts gives
    one list leaf per parameter, its L layer tensors."""
    if isinstance(subtree, torch.Tensor):
        return [subtree]
    if isinstance(subtree, (list, tuple)):
        per_layer = [tree_leaves(lp) for lp in subtree]
        return [list(ts) for ts in zip(*per_layer)]
    return [lf for key in sorted(subtree) for lf in tree_leaves(subtree[key])]


def _leaf_size(leaf) -> int:
    return sum(part.numel() for part in packing.leaf_parts(leaf))


def _subtree_f32_bytes(subtree: Any) -> int:
    return sum(4 * _leaf_size(lf) for lf in tree_leaves(subtree))


def _stacked_len(subtree: Any) -> int:
    leaves = tree_leaves(subtree)
    return len(leaves[0]) if leaves else 0


def _group_reversed_layers(key: str, n_layers: int, per_layer_bytes: int,
                           cap_bytes: int) -> list[tuple[int, tuple]]:
    """Group layers [n-1 .. 0] into consecutive runs of <= cap bytes."""
    out = []
    per_group = max(1, cap_bytes // max(1, per_layer_bytes))
    hi = n_layers
    while hi > 0:
        lo = max(0, hi - per_group)
        out.append((per_layer_bytes * (hi - lo), ((key, lo, hi),)))
        hi = lo
    return out


def _group_keys(pairs: list[tuple[tuple, int]],
                cap_bytes: int) -> list[tuple[int, tuple]]:
    """Group (entry, nbytes) pairs into cap-respecting buckets at key
    granularity; a single oversized key stays one bucket (leaves are
    never split, so e.g. an untied lm_head bigger than the cap syncs
    whole — but at least it no longer drags the norms and every other
    head leaf into the same oversized bucket)."""
    out: list[tuple[int, tuple]] = []
    cur: list[tuple] = []
    cur_b = 0
    for entry, b in pairs:
        if cur and cur_b + b > cap_bytes:
            out.append((cur_b, tuple(cur)))
            cur, cur_b = [], 0
        cur.append(entry)
        cur_b += b
    if cur:
        out.append((cur_b, tuple(cur)))
    return out


def partition_tree(tree: Any, cap_bytes: int = DEFAULT_CAP_BYTES
                   ) -> tuple[BucketSpec, ...]:
    """Partition a param/grad tree into readiness-ordered buckets.
    ``tree`` must be a dict at the top level (the Model param layout);
    unknown keys are treated as output-side ("head") leaves, which is
    correct for norms and projection heads and conservative (scheduled
    earliest) for anything else.  The cap applies to every bucket kind
    at its natural granularity: head/tail buckets split between
    top-level keys, layer buckets between layers."""
    if not isinstance(tree, dict):
        raise TypeError("partition_tree expects the top-level param dict")
    head: list[tuple[tuple, int]] = []
    tail: list[tuple[tuple, int]] = []
    groups: list[tuple[int, tuple]] = []
    for key in tree:
        if key in _LAYER_KEYS:
            continue
        pair = ((key, None, None), _subtree_f32_bytes(tree[key]))
        (tail if key in _TAIL_KEYS else head).append(pair)
    for key in _LAYER_KEYS:           # decoder groups first (ready first)
        if key not in tree:
            continue
        n = _stacked_len(tree[key])
        if n == 0:
            continue
        per = max(1, _subtree_f32_bytes(tree[key]) // n)
        groups.extend(_group_reversed_layers(key, n, per, cap_bytes))

    buckets: list[BucketSpec] = []
    for nbytes, entries in (_group_keys(head, cap_bytes) + groups
                            + _group_keys(tail, cap_bytes)):
        buckets.append(BucketSpec(len(buckets), max(1, nbytes), entries))
    if not buckets:
        raise ValueError("empty parameter tree")
    return tuple(buckets)


def bucket_sizes_for_volume(total_bytes: int, n_layers: int,
                            cap_bytes: int = DEFAULT_CAP_BYTES) -> list[int]:
    """Launcher-side approximation of ``partition_tree`` when only the
    total gradient volume is known: the volume is spread evenly over
    ``n_layers`` and grouped in reverse under the cap.  Returns bucket
    payloads in readiness order (for ``planner.plan``)."""
    total = max(1, int(total_bytes))
    # never more layers than bytes: per-layer size stays >= 1 and the
    # remainder fold-in below stays non-negative
    n_layers = max(1, min(int(n_layers), total))
    per = total // n_layers
    sizes = [b for b, _ in _group_reversed_layers("layers", n_layers, per,
                                                  cap_bytes)]
    # fold rounding remainder into the last-ready bucket
    sizes[-1] += total - sum(sizes)
    return sizes


# ---------------------------------------------------------------------------
# Execution: bucketed AllReduceH in readiness order
# ---------------------------------------------------------------------------

def _bucket_pieces(tree: Any, layout: Sequence[BucketSpec]):
    """Enumerate bucket pieces in readiness order: (pieces, the bucket of
    each piece, each bucket's (dtype, shape, size) metas).  Pieces go
    (entry, leaf, layer range): a leaf's layers ``lo:hi`` follow each
    other, and the leaves of an entry follow each other, as the reference
    slices its stacked leaves.  A piece is a tensor or a list of layer
    tensors."""
    pieces: list = []
    bucket_of: list[int] = []
    bucket_metas: list[list[tuple]] = []
    for bi, spec in enumerate(layout):
        bm: list[tuple] = []
        for key, lo, hi in spec.entries:
            for lf in tree_leaves(tree[key]):
                piece = lf if lo is None else lf[lo:hi]
                parts = packing.leaf_parts(piece)
                shape = tuple(parts[0].shape)
                if isinstance(piece, list):
                    shape = (len(parts),) + shape
                pieces.append(piece)
                bucket_of.append(bi)
                bm.append((packing.dtype_name(parts[0].dtype), shape,
                           sum(p.numel() for p in parts)))
        bucket_metas.append(bm)
    return pieces, bucket_of, bucket_metas


def _packed_bucket_plan(layout: Sequence[BucketSpec], bucket_metas: list, cfg):
    """The bucket-sliced packed layout: each bucket's bound is aligned for
    the schedule that bucket resolves to, so its buffer feeds
    ``hier_psum`` with zero re-padding.  Returns (the resolved config per
    bucket, the layout)."""
    world = collectives._dp_world(cfg)
    # resolve ONCE per bucket, by the spec's payload: execution must run
    # exactly the schedule the slice was aligned for
    rcs = [collectives.resolve_config(cfg, spec.nbytes) for spec in layout]
    aligns = [packing.comm_alignment(world, rc.n_chunks, collectives.wire_block(rc.compression))
              for rc in rcs]
    return rcs, packing.plan_bucket_layout(bucket_metas, align=aligns)


def sync_bucket(playout: packing.PackedLayout, bucket: int, pieces: list, rc) -> None:
    """AllReduceH of one bucket: pack its pieces into the bucket's f32
    buffer, sync it, and write each slot back into its piece, cast to
    the piece's dtype.  The pieces must be contiguous tensors that the
    caller hands over (they hold the synced values afterwards)."""
    start = playout.bucket_bounds[bucket][0]
    out = collectives.hier_psum(packing.pack_bucketed(playout, pieces, bucket), rc)
    slots = [sl for sl in playout.slots if sl.bucket == bucket]
    with torch.no_grad():
        for sl, piece in zip(slots, pieces):
            off = sl.offset - start
            for part in packing.leaf_parts(piece):
                part.copy_(out[off:off + part.numel()].view(part.shape))
                off += part.numel()


def sync_bucket_unpacked(pieces: list, cfg) -> None:
    """The per-leaf data path's AllReduceH of one bucket (the reference's
    per-bucket re-flatten): the pieces cast to f32 and concatenated into
    a fresh buffer, which ``hier_psum`` syncs on the config ``cfg``
    resolves to for its size; each piece gets its values back, cast to
    its dtype."""
    parts = [part for piece in pieces for part in packing.leaf_parts(piece)]
    out = collectives.hier_psum(torch.cat([p.reshape(-1).float() for p in parts]), cfg)
    off = 0
    with torch.no_grad():
        for part in parts:
            part.copy_(out[off:off + part.numel()].view(part.shape))
            off += part.numel()


def tree_hier_psum_overlap(tree: Any, cfg, cap_bytes: int = DEFAULT_CAP_BYTES,
                           layout: Sequence[BucketSpec] | None = None,
                           packed: bool = True) -> Any:
    """Gradient sync: AllReduceH per readiness-ordered bucket, in index
    order, after the backward.  ``cfg`` is a ``CommConfig`` or a plan with
    ``config_for`` (each bucket resolves its own schedule by payload
    size).  ``packed`` syncs slices of one bucket-aligned layout;
    ``packed=False`` re-flattens each bucket (``sync_bucket_unpacked``).
    The tree's tensors receive the synced values in place (each slot cast
    back to its leaf's dtype) and the tree is returned."""
    if layout is None:
        layout = partition_tree(tree, cap_bytes)
    pieces, bucket_of, bucket_metas = _bucket_pieces(tree, layout)
    if packed:
        rcs, playout = _packed_bucket_plan(layout, bucket_metas, cfg)
    for bi in range(len(layout)):
        mine = [p for p, b in zip(pieces, bucket_of) if b == bi]
        if packed:
            sync_bucket(playout, bi, mine, rcs[bi])
        else:
            sync_bucket_unpacked(mine, cfg)
    return tree


def reached_leaves(loss: torch.Tensor) -> set[int]:
    """The ids of the leaf tensors that the autograd graph of ``loss``
    reaches: a walk from ``loss.grad_fn`` through ``next_functions`` that
    collects each ``AccumulateGrad`` node's ``variable`` (DDP's
    ``find_unused_parameters`` makes the same walk).  A non-reentrant
    checkpoint records its forward graph as it runs, so the walk sees its
    parameters; a reentrant one would hide them."""
    ids: set[int] = set()
    seen = set()
    stack = [] if loss.grad_fn is None else [loss.grad_fn]
    while stack:
        fn = stack.pop()
        if fn in seen:
            continue
        seen.add(fn)
        var = getattr(fn, "variable", None)
        if var is not None:
            ids.add(id(var))
        stack.extend(nxt for nxt, _ in fn.next_functions if nxt is not None)
    return ids


class BucketSync:
    """The readiness chain, run eagerly inside the backward.

    ``BucketSync(params, cfg, cap_bytes, packed)`` plans the buckets of a
    parameter tree; within ``with sync.attached(loss):`` a hook on every
    parameter takes its gradient as the backward produces it and counts
    its bucket down.  A bucket is synced (``sync_bucket``, or with
    ``packed=False`` ``sync_bucket_unpacked``, in a ``grad_sync``
    profiler range) as soon as it and every bucket with a lower index are
    complete; the gradients that ``torch.autograd.grad`` returns then hold
    the synced values.

    A parameter that the graph of ``loss`` does not reach (the GELU MLP's
    ``b2`` under sequence parallelism, ROADMAP R22) gets no gradient from
    the backward.  ``attached`` finds those before the backward starts
    (``reached_leaves``) and counts them down at once, each with a zero
    gradient of its shape and dtype, so that its bucket syncs as soon as
    its read leaves arrive; ``fill`` hands the synced zeros (zero, as the
    reference's sync of ``jax.grad``'s zeros gives) to the step.  The
    unread set depends on the model and the runtime only, so every rank
    issues the same syncs in the same order.  ``events`` logs ("unread",
    bucket) per unread parameter, ("grad", bucket) per gradient and
    ("sync", bucket) per sync, in order; ``walk_ms`` is the walk's host
    time."""

    def __init__(self, params: Any, cfg, cap_bytes: int = DEFAULT_CAP_BYTES,
                 packed: bool = True):
        specs = partition_tree(params, cap_bytes)
        pieces, bucket_of, bucket_metas = _bucket_pieces(params, specs)
        self.cfg = cfg
        # the packed layout and each bucket's resolved config; None on the
        # per-leaf path, where hier_psum resolves each re-flattened buffer
        self.layout = self.rcs = None
        if packed:
            self.rcs, self.layout = _packed_bucket_plan(specs, bucket_metas, cfg)
        self.n_buckets = len(specs)
        self._is_list = [isinstance(p, list) for p in pieces]
        self._n_parts = [len(packing.leaf_parts(p)) for p in pieces]
        self._bucket_pieces: list[list[int]] = [[] for _ in specs]
        self._params: list[tuple[torch.Tensor, int, int, int]] = []  # (param, bucket, piece, part)
        for pi, (piece, bucket) in enumerate(zip(pieces, bucket_of)):
            self._bucket_pieces[bucket].append(pi)
            for k, part in enumerate(packing.leaf_parts(piece)):
                self._params.append((part, bucket, pi, k))
        self.events: list[tuple[str, int]] = []
        self.walk_ms = 0.0

    def _arrived(self, bucket: int, pi: int, k: int, grad: torch.Tensor, event: str) -> None:
        """Part ``k`` of piece ``pi`` holds ``grad``: count its bucket down
        and sync every bucket that is complete with all before it."""
        self._grads[pi][k] = grad
        self._pending[bucket] -= 1
        self.events.append((event, bucket))
        while self._next < self.n_buckets and self._pending[self._next] == 0:
            self._sync(self._next)
            self._next += 1

    def _hook(self, param: torch.Tensor, bucket: int, pi: int, k: int):
        def hook(grad: torch.Tensor) -> torch.Tensor:
            if id(param) in self._unread:
                raise RuntimeError("a parameter the graph walk did not reach took a "
                                   "gradient (a reentrant checkpoint hides its parameters)")
            grad = grad.contiguous()   # the returned tensor is the captured gradient
            self._arrived(bucket, pi, k, grad, "grad")
            return grad
        return hook

    def _sync(self, bucket: int) -> None:
        pis = self._bucket_pieces[bucket]
        pieces = [self._grads[pi] if self._is_list[pi] else self._grads[pi][0] for pi in pis]
        with torch.profiler.record_function("grad_sync"):
            if self.layout is None:
                sync_bucket_unpacked(pieces, self.cfg)
            else:
                sync_bucket(self.layout, bucket, pieces, self.rcs[bucket])
        for pi in pis:
            self._grads[pi] = None
        self.events.append(("sync", bucket))

    @contextlib.contextmanager
    def attached(self, loss: torch.Tensor):
        """Hooks on for the block, in which the caller runs the backward of
        ``loss``; the parameters that its graph does not reach are counted
        down before the block starts.  On a normal exit every bucket must
        have been synced, else it raises."""
        self._grads: list = [[None] * n for n in self._n_parts]
        self._pending = [sum(self._n_parts[pi] for pi in pis) for pis in self._bucket_pieces]
        self._next = 0
        self._unread: dict[int, torch.Tensor] = {}
        self.events.clear()
        t0 = time.perf_counter()
        reached = reached_leaves(loss)
        self.walk_ms = (time.perf_counter() - t0) * 1e3
        for p, b, pi, k in self._params:
            if id(p) not in reached:
                self._unread[id(p)] = zero = torch.zeros_like(
                    p, memory_format=torch.contiguous_format)
                self._arrived(b, pi, k, zero, "unread")
        handles = [p.register_hook(self._hook(p, b, pi, k)) for p, b, pi, k in self._params]
        try:
            yield self
        finally:
            for h in handles:
                h.remove()
        if self._next != self.n_buckets:
            raise RuntimeError(f"the backward synced {self._next} of {self.n_buckets} "
                               f"gradient buckets")

    def fill(self, params: Sequence[torch.Tensor], grads: Sequence) -> list[torch.Tensor]:
        """``grads`` as ``torch.autograd.grad(loss, params, allow_unused=True)``
        returns them after ``attached(loss)``, each None (a parameter the
        loss does not read) replaced by that parameter's synced zeros."""
        return [self._unread[id(p)] if g is None else g for p, g in zip(params, grads)]
