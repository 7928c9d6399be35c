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
are complete, so every rank issues its collectives in index order.
``tree_hier_psum_overlap`` is the same sync run after the backward on a
tree of gradients; both write the synced values into the gradients they
are given (the synced buffer is cast back to each leaf's dtype), so the
two give the same bits.

A parameter tree is a dict at the top level (``Model.param_tree()``):
each value a tensor, a dict of subtrees, or, for a stacked key
(``layers``), a list of per-layer dicts standing for the reference's
stacked (L, ...) leaves.  The reference's per-bucket re-flatten
(``packed=False``) is not ported.
"""

from __future__ import annotations

import contextlib
import dataclasses
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

def _packed_bucket_plan(tree: Any, layout: Sequence[BucketSpec], cfg):
    """Enumerate bucket pieces in readiness order and compute the
    bucket-sliced packed layout: each bucket's bound is aligned for the
    schedule that bucket resolves to, so its buffer feeds ``hier_psum``
    with zero re-padding.  Pieces go (entry, leaf, layer range): a leaf's
    layers ``lo:hi`` follow each other, and the leaves of an entry follow
    each other, as the reference slices its stacked leaves.  A piece is
    a tensor or a list of layer tensors."""
    world = collectives._dp_world(cfg)
    pieces: list = []
    bucket_metas: list[list[tuple]] = []
    aligns: list[int] = []
    rcs: list = []             # resolved CommConfig per bucket
    for spec in layout:
        bm: list[tuple] = []
        for key, lo, hi in spec.entries:
            for lf in tree_leaves(tree[key]):
                piece = lf if lo is None else lf[lo:hi]
                parts = packing.leaf_parts(piece)
                shape = tuple(parts[0].shape)
                if isinstance(piece, list):
                    shape = (len(parts),) + shape
                pieces.append(piece)
                bm.append((packing.dtype_name(parts[0].dtype), shape,
                           sum(p.numel() for p in parts)))
        bucket_metas.append(bm)
        # resolve ONCE per bucket, by the spec's payload: execution
        # must run exactly the schedule the slice was aligned for
        rc = collectives.resolve_config(cfg, spec.nbytes)
        rcs.append(rc)
        aligns.append(packing.comm_alignment(
            world, rc.n_chunks, collectives.wire_block(rc.compression)))
    return pieces, rcs, packing.plan_bucket_layout(bucket_metas, align=aligns)


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


def tree_hier_psum_overlap(tree: Any, cfg, cap_bytes: int = DEFAULT_CAP_BYTES,
                           layout: Sequence[BucketSpec] | None = None) -> Any:
    """Gradient sync: AllReduceH per readiness-ordered bucket, in index
    order, after the backward.  ``cfg`` is a ``CommConfig`` or a plan with
    ``config_for`` (each bucket resolves its own schedule by payload
    size).  The tree's tensors receive the synced values in place (each
    slot cast back to its leaf's dtype) and the tree is returned."""
    if layout is None:
        layout = partition_tree(tree, cap_bytes)
    pieces, rcs, playout = _packed_bucket_plan(tree, layout, cfg)
    slot_bucket = [sl.bucket for sl in playout.slots]
    for bi, rc in enumerate(rcs):
        sync_bucket(playout, bi, [p for p, b in zip(pieces, slot_bucket) if b == bi], rc)
    return tree


class BucketSync:
    """The readiness chain, run eagerly inside the backward.

    ``BucketSync(params, cfg, cap_bytes)`` plans the buckets of a
    parameter tree; within ``with sync.attached():`` a hook on every
    parameter takes its gradient as the backward produces it and counts
    its bucket down.  A bucket is synced (``sync_bucket``, in a
    ``grad_sync`` profiler range) as soon as it and every bucket with a
    lower index are complete; the gradients that ``torch.autograd.grad``
    returns then hold the synced values.  ``events`` logs ("grad",
    bucket) per gradient and ("sync", bucket) per sync, in order."""

    def __init__(self, params: Any, cfg, cap_bytes: int = DEFAULT_CAP_BYTES):
        pieces, self.rcs, self.layout = _packed_bucket_plan(
            params, partition_tree(params, cap_bytes), cfg)
        self._is_list = [isinstance(p, list) for p in pieces]
        self._n_parts = [len(packing.leaf_parts(p)) for p in pieces]
        self._bucket_pieces: list[list[int]] = [[] for _ in self.rcs]
        self._params: list[tuple[torch.Tensor, int, int, int]] = []  # (param, bucket, piece, part)
        for pi, (piece, sl) in enumerate(zip(pieces, self.layout.slots)):
            self._bucket_pieces[sl.bucket].append(pi)
            for k, part in enumerate(packing.leaf_parts(piece)):
                self._params.append((part, sl.bucket, pi, k))
        self.events: list[tuple[str, int]] = []

    @property
    def n_buckets(self) -> int:
        return len(self.rcs)

    def _hook(self, bucket: int, pi: int, k: int):
        def hook(grad: torch.Tensor) -> torch.Tensor:
            grad = grad.contiguous()   # the returned tensor is the captured gradient
            self._grads[pi][k] = grad
            self._pending[bucket] -= 1
            self.events.append(("grad", bucket))
            while self._next < self.n_buckets and self._pending[self._next] == 0:
                self._sync(self._next)
                self._next += 1
            return grad
        return hook

    def _sync(self, bucket: int) -> None:
        pis = self._bucket_pieces[bucket]
        pieces = [self._grads[pi] if self._is_list[pi] else self._grads[pi][0] for pi in pis]
        with torch.profiler.record_function("grad_sync"):
            sync_bucket(self.layout, bucket, pieces, self.rcs[bucket])
        for pi in pis:
            self._grads[pi] = None
        self.events.append(("sync", bucket))

    @contextlib.contextmanager
    def attached(self):
        """Hooks on for the block; on a normal exit every bucket must have
        been synced, else it raises."""
        self._grads: list = [[None] * n for n in self._n_parts]
        self._pending = [sum(self._n_parts[pi] for pi in pis) for pis in self._bucket_pieces]
        self._next = 0
        self.events.clear()
        handles = [p.register_hook(self._hook(b, pi, k)) for p, b, pi, k in self._params]
        try:
            yield self
        finally:
            for h in handles:
                h.remove()
        if self._next != self.n_buckets:
            raise RuntimeError(f"the backward synced {self._next} of {self.n_buckets} "
                               f"gradient buckets")
