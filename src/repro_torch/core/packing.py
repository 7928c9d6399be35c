"""Persistent packed gradient data path (zero-copy comm buffers).

The layout core is a copy of the JAX package's ``core/packing.py`` (pure
stdlib): one persistent layout per gradient sync, one segment per wire
dtype, each zero-padded to ``world * n_chunks * block`` elements so that
no collective downstream ever re-pads (the intra shard, the chunk split
and the int8 block codec all divide it).  Dtypes are named as the JAX
package names them (``"bfloat16"``, ``"float32"``), so the two layouts
compare equal.

``pack`` writes every gradient leaf of a segment, and zeros around them,
into a new segment buffer with one ``kernels.quant.pack_slots_call``
(one CUDA launch per segment on the card; on the CPU its plain version,
``copy_`` into slot views of a zeroed buffer); ``unpack`` returns views
of the synced segments, shaped as the leaves.  A leaf is a tensor,
or a list of equal tensors that stands for their stack (the per-layer
parameters of a model whose reference stacks a leading (L, ...) axis):
its slot holds layer after layer, as the reference's stacked leaf does.
``plan_bucket_layout`` is the overlap scheduler's layout (every bucket
cast to f32 and aligned on its own), and ``pack_bucketed`` writes one
bucket of it into a buffer of its own, so that each bucket is freed once
synced.  ``remap_shard_ops`` and ``apply_remap_ops``, the ZeRO-1
master's slice remap onto another intra world (the elastic path), are
verbatim copies of the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from repro_torch.kernels import quant as _qk

# Block granularity of the int8 wire codec.
DEFAULT_BLOCK = _qk.BLOCK

_ITEMSIZE = {
    "float32": 4, "float64": 8, "bfloat16": 2, "float16": 2,
    "int32": 4, "int64": 8, "int16": 2, "int8": 1, "uint8": 1,
    "bool": 1,
}


def itemsize_of(dtype_name: str) -> int:
    """Bytes per element of a wire dtype.  Unknown dtypes raise rather
    than silently pricing at 4 bytes — a wrong itemsize would falsify a
    segment's wire bytes."""
    try:
        return _ITEMSIZE[dtype_name]
    except KeyError:
        raise ValueError(
            f"unknown wire dtype {dtype_name!r}: add it to "
            "packing._ITEMSIZE") from None


def aligned_size(n: int, align: int) -> int:
    """Smallest multiple of ``align`` >= n (0 stays 0)."""
    align = max(1, int(align))
    return -(-int(n) // align) * align


def comm_alignment(world: int, n_chunks: int = 1,
                   block: int = 1) -> int:
    """Element alignment that keeps every downstream data-path step
    pad-free: ``world·n_chunks·block`` (see module docstring for why
    each factor is needed).  ``block`` should be ``DEFAULT_BLOCK`` when
    the int8 codec may run and 1 otherwise."""
    return max(1, int(world)) * max(1, int(n_chunks)) * max(1, int(block))


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """Where one leaf (or stacked-layer piece) lives in the packed
    buffers: ``segment`` names the wire-dtype buffer, ``offset`` the
    element offset inside it.  ``index`` is the slot's position in the
    caller's flatten order; ``bucket`` the overlap bucket (or 0)."""

    index: int
    segment: str
    offset: int
    size: int
    shape: tuple
    dtype: str
    bucket: int = 0


@dataclasses.dataclass(frozen=True)
class Segment:
    """One wire-dtype buffer: ``used`` payload elements, zero-padded to
    ``padded`` (a multiple of the layout alignment)."""

    dtype: str
    used: int
    padded: int

    @property
    def wire_bytes(self) -> int:
        """Bytes this segment puts on the wire (per rank, pre-codec) —
        the dtype-preservation regression tests pin this."""
        return self.padded * itemsize_of(self.dtype)


@dataclasses.dataclass(frozen=True)
class PackedLayout:
    """The persistent trace-time layout: every slot's home, every
    segment's padded extent, and (for overlap packing) the aligned
    bucket boundaries within the single segment."""

    slots: tuple[LeafSlot, ...]
    segments: tuple[Segment, ...]
    align: int
    # (start, end) element bounds per overlap bucket in segments[0]
    bucket_bounds: tuple[tuple[int, int], ...] = ()

    def segment(self, dtype: str) -> Segment:
        for s in self.segments:
            if s.dtype == dtype:
                return s
        raise KeyError(dtype)

    @property
    def padded_total(self) -> int:
        return sum(s.padded for s in self.segments)

    @property
    def used_total(self) -> int:
        return sum(s.used for s in self.segments)

    def wire_bytes(self) -> dict[str, int]:
        return {s.dtype: s.wire_bytes for s in self.segments}

    def segment_bounds(self) -> tuple[tuple[str, int, int], ...]:
        """(dtype, start, end) element bounds of each segment inside
        the concatenated single-buffer (f32 master) view, in segment
        order."""
        out = []
        off = 0
        for s in self.segments:
            out.append((s.dtype, off, off + s.padded))
            off += s.padded
        return tuple(out)

    def validate(self) -> None:
        """Structural invariants (the pure-math CI gate runs this):
        per-segment slots are disjoint, in-bounds, and tightly packed;
        padding respects the alignment."""
        by_seg: dict[str, list[LeafSlot]] = {}
        for sl in self.slots:
            by_seg.setdefault(sl.segment, []).append(sl)
        for seg in self.segments:
            if seg.padded % self.align != 0:
                raise ValueError(
                    f"segment {seg.dtype}: padded {seg.padded} not a "
                    f"multiple of align {self.align}")
            if not seg.used <= seg.padded:
                raise ValueError(f"segment {seg.dtype}: used > padded")
            slots = sorted(by_seg.get(seg.dtype, ()),
                           key=lambda s: s.offset)
            off = 0
            for sl in slots:
                if sl.offset < off:
                    raise ValueError(
                        f"overlapping slots in segment {seg.dtype} at "
                        f"offset {sl.offset}")
                off = sl.offset + sl.size
            if off > seg.padded:
                raise ValueError(f"segment {seg.dtype}: slots exceed pad")


def plan_layout(metas: Sequence[tuple[str, tuple, int]], *,
                world: int = 1, n_chunks: int = 1,
                block: int = 1,
                align_for: Callable[[str, int], int] | None = None
                ) -> PackedLayout:
    """Build the persistent layout for leaves described by ``metas``
    (ordered ``(dtype_name, shape, size)`` tuples — exactly what
    ``jax.tree.flatten`` order gives the jax-side wrappers).

    Leaves are grouped into one segment per wire dtype, preserving
    their relative order; each segment is padded to the comm alignment
    (``align_for(dtype, used)`` overrides the default
    ``comm_alignment(world, n_chunks, block)`` per segment)."""
    default_align = comm_alignment(world, n_chunks, block)
    order: list[str] = []
    used: dict[str, int] = {}
    slots: list[LeafSlot] = []
    for idx, (dt, shape, size) in enumerate(metas):
        if dt not in used:
            used[dt] = 0
            order.append(dt)
        slots.append(LeafSlot(idx, dt, used[dt], int(size),
                              tuple(shape), dt))
        used[dt] += int(size)
    segments = []
    for dt in order:
        a = align_for(dt, used[dt]) if align_for is not None else default_align
        segments.append(Segment(dt, used[dt], aligned_size(used[dt], a)))
    # `align` records the weakest guarantee across segments (validate()
    # checks each segment against it)
    align = default_align if align_for is None else _gcd_all(
        [s.padded or 1 for s in segments])
    layout = PackedLayout(tuple(slots), tuple(segments), align)
    layout.validate()
    return layout


def _gcd_all(xs: Sequence[int]) -> int:
    import math
    g = 0
    for x in xs:
        g = math.gcd(g, int(x))
    return max(1, g)


def plan_bucket_layout(bucket_metas: Sequence[Sequence[tuple[str, tuple, int]]],
                       *, align: int | Sequence[int]) -> PackedLayout:
    """Layout for the overlap scheduler: every bucket's pieces are cast
    to f32 and laid out contiguously, each bucket padded to ``align``
    (one int, or one per bucket — buckets may run different schedules,
    e.g. different chunk counts per the planner) so its slice of the
    one buffer is directly collective-ready (``bucket_bounds``).  Slot
    order is bucket-major (readiness order)."""
    aligns = ([int(align)] * len(bucket_metas)
              if isinstance(align, int) else [int(a) for a in align])
    if len(aligns) != len(bucket_metas):
        raise ValueError("need one alignment per bucket")
    slots: list[LeafSlot] = []
    bounds: list[tuple[int, int]] = []
    off = 0
    idx = 0
    for bi, metas in enumerate(bucket_metas):
        start = off
        for dt, shape, size in metas:
            slots.append(LeafSlot(idx, "float32", off, int(size),
                                  tuple(shape), dt, bucket=bi))
            off += int(size)
            idx += 1
        off = start + aligned_size(off - start, aligns[bi])
        bounds.append((start, off))
    layout = PackedLayout(tuple(slots),
                          (Segment("float32", off, off),),
                          _gcd_all([max(1, a) for a in aligns]),
                          bucket_bounds=tuple(bounds))
    # bucket padding lives between slots, so used == padded per segment
    # but every bucket boundary is align-multiple by construction
    layout.validate()
    return layout


# ---------------------------------------------------------------------------
# torch executors
# ---------------------------------------------------------------------------

_DTYPE_NAMES = {torch.float32: "float32", torch.float64: "float64",
                torch.bfloat16: "bfloat16", torch.float16: "float16",
                torch.int32: "int32", torch.int64: "int64", torch.int16: "int16",
                torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool"}
_DTYPES = {name: dt for dt, name in _DTYPE_NAMES.items()}


def dtype_name(dtype: torch.dtype) -> str:
    """The JAX package's name of a torch dtype (``torch.bfloat16`` ->
    ``"bfloat16"``)."""
    return _DTYPE_NAMES[dtype]


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a JAX package's dtype name (``"bfloat16"`` ->
    ``torch.bfloat16``)."""
    return _DTYPES[name]


def leaf_parts(leaf) -> list[torch.Tensor]:
    """The tensors of a leaf: itself, or the layers of a list leaf."""
    return list(leaf) if isinstance(leaf, (list, tuple)) else [leaf]


def tree_metas(leaves) -> list[tuple[str, tuple, int]]:
    """(dtype_name, shape, size) of each leaf; a list leaf has the shape
    of its stack."""
    metas = []
    for leaf in leaves:
        parts = leaf_parts(leaf)
        shape = tuple(parts[0].shape)
        if isinstance(leaf, (list, tuple)):
            shape = (len(parts),) + shape
        size = 1
        for d in shape:
            size *= int(d)
        metas.append((dtype_name(parts[0].dtype), shape, size))
    return metas


def segment_pieces(layout: PackedLayout, leaves) -> dict[str, list]:
    """(offset, tensor) of every leaf part, by segment: a list leaf's
    layers follow each other in its slot."""
    pieces: dict[str, list] = {seg.dtype: [] for seg in layout.segments}
    for sl, leaf in zip(layout.slots, leaves):
        off = sl.offset
        for part in leaf_parts(leaf):
            pieces[sl.segment].append((off, part))
            off += part.numel()
    return pieces


def pack(layout: PackedLayout, leaves) -> dict[str, torch.Tensor]:
    """Write ``leaves`` (in layout slot order) into one new buffer per
    segment, each leaf part at its slot offset and zeros elsewhere (the
    zero tail pad sums away harmlessly downstream).  The parts must be
    contiguous on the card (``pack_slots_call`` refuses strided ones)."""
    pieces = segment_pieces(layout, leaves)
    return {seg.dtype: _qk.pack_slots_call(pieces[seg.dtype], seg.padded,
                                           torch_dtype(seg.dtype))
            for seg in layout.segments}


def unpack(layout: PackedLayout, buffers: dict[str, torch.Tensor]) -> list:
    """Views of every slot in its segment buffer, shaped as the leaf (a
    list leaf comes back as its (L, ...) stack)."""
    return [buffers[sl.segment][sl.offset:sl.offset + sl.size].view(sl.shape)
            for sl in layout.slots]


def pack_bucketed(layout: PackedLayout, pieces, bucket: int) -> torch.Tensor:
    """One bucket of ``plan_bucket_layout``'s buffer: the bucket's
    ``pieces`` (in its slot order; each a tensor, or a list of tensors
    that follow each other in the slot) cast to f32 at their slot offsets,
    rebased to the bucket's start, with zeros in the gaps and the tail
    pad: the reference's ``buf[start:end]``, in one ``pack_slots`` launch."""
    start, end = layout.bucket_bounds[bucket]
    slots = [sl for sl in layout.slots if sl.bucket == bucket]
    if len(slots) != len(pieces):
        raise ValueError(f"bucket {bucket}: {len(pieces)} pieces for {len(slots)} slots")
    parts = []
    for sl, piece in zip(slots, pieces):
        off = sl.offset - start
        for part in leaf_parts(piece):
            parts.append((off, part))
            off += part.numel()
    return _qk.pack_slots_call(parts, end - start, torch.float32)


# ---------------------------------------------------------------------------
# Elastic shard remap (DESIGN.md §15)
# ---------------------------------------------------------------------------
#
# A ZeRO-1 rank's master shard is the per-segment concatenation of its
# slices: shard(r) = concat over segments of seg_buffer[r*per : (r+1)*per]
# with per = seg.padded // world (collectives.zero1_local_shard).  When
# the intra world changes (host loss / recovery), the new shards are a
# pure *slice remap* of the old ones through the slot map — every payload
# element keeps its (segment, in-segment offset) identity, only its
# (rank, in-shard offset) home moves.  No re-flatten, no repacking of
# leaves; the tail padding of each segment is zeros on both sides, so
# copying min(old.padded, new.padded) elements per segment is exact.

@dataclasses.dataclass(frozen=True)
class ShardRemapOp:
    """One contiguous host copy realizing part of the remap:
    ``new_shards[dst_rank][dst_offset:dst_offset+length] =
    old_shards[src_rank][src_offset:src_offset+length]``.  Offsets are
    in per-rank master-shard coordinates (per-segment bases included)."""

    dtype: str
    src_rank: int
    src_offset: int
    dst_rank: int
    dst_offset: int
    length: int


def remap_shard_ops(old: PackedLayout, new: PackedLayout, *,
                    old_world: int, new_world: int
                    ) -> tuple[tuple[ShardRemapOp, ...], ...]:
    """Copy ops mapping per-rank ZeRO-1 master shards from ``old``
    (sharded ``old_world``-way) to ``new`` (``new_world``-way), grouped
    per destination rank.  Raises ``ValueError`` when the layouts are
    not remappable — different leaf contents (the segments' (dtype,
    used) sequences differ, e.g. a TP resize changed the local leaves)
    or a world that does not divide a segment (the mesh shrank below
    the layout's divisibility) — the caller's cue to fall back to
    ``CheckpointManager.restore`` with new shardings."""
    old_world, new_world = int(old_world), int(new_world)
    if old_world < 1 or new_world < 1:
        raise ValueError(
            f"remap_shard_ops: worlds must be >= 1, got "
            f"{old_world} -> {new_world}")
    sig_old = [(s.dtype, s.used) for s in old.segments]
    sig_new = [(s.dtype, s.used) for s in new.segments]
    if sig_old != sig_new:
        raise ValueError(
            "remap_shard_ops: layouts describe different leaf contents "
            f"(old segments {sig_old} != new segments {sig_new}) — "
            "a slice remap cannot relate them; restore from checkpoint")
    for tag, lay, world in (("old", old, old_world), ("new", new, new_world)):
        for s in lay.segments:
            if s.padded % world != 0:
                raise ValueError(
                    f"remap_shard_ops: {tag} segment {s.dtype} padded "
                    f"{s.padded} is not divisible by world {world} — "
                    "mesh shrank below the layout's divisibility; "
                    "restore from checkpoint")
    per_old = [s.padded // old_world for s in old.segments]
    per_new = [s.padded // new_world for s in new.segments]
    ops: list[list[ShardRemapOp]] = [[] for _ in range(new_world)]
    base_old = 0
    base_new = 0
    for si, (seg_o, seg_n) in enumerate(zip(old.segments, new.segments)):
        po, pn = per_old[si], per_new[si]
        extent = min(seg_o.padded, seg_n.padded)
        p = 0
        while p < extent and po and pn:
            src_rank, src_in_seg = divmod(p, po)
            dst_rank, dst_in_seg = divmod(p, pn)
            length = min(extent - p, po - src_in_seg, pn - dst_in_seg)
            ops[dst_rank].append(ShardRemapOp(
                seg_o.dtype, src_rank, base_old + src_in_seg,
                dst_rank, base_new + dst_in_seg, length))
            p += length
        base_old += po
        base_new += pn
    return tuple(tuple(rank_ops) for rank_ops in ops)


def apply_remap_ops(ops, old_shards, new_shard_size: int):
    """Execute :func:`remap_shard_ops` on host arrays: ``old_shards``
    is the list of old per-rank 1-D buffers; returns the zero-initialized
    new per-rank buffers with every op applied.  numpy is imported
    lazily like the JAX executors below, keeping the layout core
    importable by the no-jax CI gate."""
    import numpy as np
    if not old_shards:
        return []
    dtype = np.asarray(old_shards[0]).dtype
    out = [np.zeros(int(new_shard_size), dtype) for _ in range(len(ops))]
    for rank_ops in ops:
        for op in rank_ops:
            src = np.asarray(old_shards[op.src_rank])
            out[op.dst_rank][op.dst_offset:op.dst_offset + op.length] = \
                src[op.src_offset:op.src_offset + op.length]
    return out
