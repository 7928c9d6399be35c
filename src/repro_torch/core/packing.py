"""Persistent packed gradient data path (zero-copy comm buffers).

The layout core is a copy of the JAX package's ``core/packing.py`` (pure
stdlib): one persistent layout per gradient sync, one segment per wire
dtype, each zero-padded to ``world * n_chunks * block`` elements so that
no collective downstream ever re-pads (the intra shard, the chunk split
and the int8 block codec all divide it).  Dtypes are named as the JAX
package names them (``"bfloat16"``, ``"float32"``), so the two layouts
compare equal.

``pack`` writes each gradient leaf into a zero-initialised segment with
``copy_`` into its slot's view (no concatenate); ``unpack`` returns
views of the synced segments, shaped as the leaves.  A leaf is a tensor,
or a list of equal tensors that stands for their stack (the per-layer
parameters of a model whose reference stacks a leading (L, ...) axis):
its slot holds layer after layer, as the reference's stacked leaf does.
The overlap scheduler's bucket layout and the elastic shard remap are
not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

# Block granularity of the int8 wire codec (== kernels.quant.BLOCK;
# duplicated as a plain int so the layout math stays importable without
# jax — tests assert the two constants agree).
DEFAULT_BLOCK = 1024

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


def pack(layout: PackedLayout, leaves) -> dict[str, torch.Tensor]:
    """Write ``leaves`` (in layout slot order) into one zero-initialised
    buffer per segment, each leaf by ``copy_`` into its slot's view; the
    zero tail pad sums away harmlessly downstream."""
    device = leaf_parts(leaves[0])[0].device
    out = {seg.dtype: torch.zeros((seg.padded,), dtype=_DTYPES[seg.dtype],
                                  device=device)
           for seg in layout.segments}
    for sl, leaf in zip(layout.slots, leaves):
        off = sl.offset
        for part in leaf_parts(leaf):
            n = part.numel()
            out[sl.segment][off:off + n].view(part.shape).copy_(part)
            off += n
    return out


def unpack(layout: PackedLayout, buffers: dict[str, torch.Tensor]) -> list:
    """Views of every slot in its segment buffer, shaped as the leaf (a
    list leaf comes back as its (L, ...) stack)."""
    return [buffers[sl.segment][sl.offset:sl.offset + sl.size].view(sl.shape)
            for sl in layout.slots]
