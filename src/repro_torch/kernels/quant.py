"""Blockwise int8 quantize / dequantize: the local-scale codec of the
disaggregated KV-cache transfer and the shared-scale codec of the
gradient sync.

Symmetric int8 per 1024-element block with an f32 scale, as in the JAX
package's ``kernels/quant.py``, and the packing of the gradient sync's
comm buffer.  Each ``*_call`` launches its CUDA kernel (``csrc/quant.cu``,
``csrc/pack.cu``) for tensors on the card and uses its plain version
(``*_plain``) for tensors on the CPU; each counts its kernel launches in
``.launches``.  The shared-scale codec is two kernels: ``amax_block_call``
(per-block max |x|, agreed across the pod group by the caller) and
``quant_scaled_call`` (quantize with that scale).  Every input is read
as it is, bf16 or f32, with the ragged tail counted as zeros.
``amax_block_call``, ``quant_scaled_call`` and ``dequant_int8_call``
launch a vector kernel (up to 16 bytes per lane and access) when the
payload's base is 16-byte aligned and a scalar one otherwise; each counts
its vector launches in ``.vector_launches`` beside ``.launches``.
``pack_slots_call`` writes leaves at their slot offsets into one padded
buffer, zeros elsewhere; ``fused_pack_quant_call`` is that packing into
f32 followed by ``quant_int8_call``, in one pass.  A tensor with no data
(``_build.shape_only``) gets the outputs' shapes alone, counted in
``.fake_launches``.
"""

from __future__ import annotations

import torch

from . import _build, ref

BLOCK = 1024
PACK_TILE = 8192      # elements one pack_slots block copies (passed to the kernel)
_CODES = {torch.float32: _build.F32, torch.bfloat16: _build.BF16,
          torch.int8: _build.INT8, torch.int32: _build.INT32}
VECTOR_ALIGN = 16     # bytes; the vector kernels' payload base (csrc/quant.cu)


def _padded_f32(x: torch.Tensor) -> torch.Tensor:
    """Flat f32 copy of ``x`` zero-padded to a multiple of BLOCK."""
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat


def quant_int8_plain(x: torch.Tensor):
    """x: any shape, bf16 or f32 -> (q (nb, BLOCK) int8, s (nb,) f32); the
    ragged tail counts as zeros (``ref.quant_int8_block`` per block)."""
    return ref.quant_int8_block(_padded_f32(x), BLOCK)


def amax_block_plain(x: torch.Tensor) -> torch.Tensor:
    """x: any shape, bf16 or f32 -> per-block max |x|, (nb,) f32."""
    return ref.amax_block(_padded_f32(x), BLOCK)


def quant_scaled_plain(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x: any shape, bf16 or f32; scale (nb,) f32 -> q (nb, BLOCK) int8."""
    return ref.quant_scaled_block(_padded_f32(x), scale, BLOCK)


def dequant_int8_plain(q: torch.Tensor, s: torch.Tensor, size: int,
                       dtype=torch.float32, gain: float | None = None):
    """(nb, BLOCK) int8 or int32 with per-block ``s`` -> the first
    ``size`` values, flat, in ``dtype``."""
    if gain is not None:
        s = s * gain
    return ref.dequant_int8_block(q, s)[:size].to(dtype)


def _codec_input(x: torch.Tensor, what: str) -> int:
    """Checks a codec kernel's payload; returns its number of blocks."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: bf16 or f32 input, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: input must be contiguous")
    if x.numel() == 0:
        raise ValueError(f"{what}: empty input")
    return -(-x.numel() // BLOCK)


def quant_int8_call(x: torch.Tensor):
    """Fused amax + scale + round + clip, one pass per block.
    x: any shape, bf16 or f32 -> (q (nb, BLOCK) int8, s (nb,) f32)."""
    if x.device.type == "cpu":
        return quant_int8_plain(x)
    nb = _codec_input(x, "quant_int8")
    size = x.numel()
    q = torch.empty((nb, BLOCK), dtype=torch.int8, device=x.device)
    s = torch.empty((nb,), dtype=torch.float32, device=x.device)
    if _build.shape_only(x):
        _build.count_shape_only(quant_int8_call, "quant_int8", x=x, q=q, s=s)
        return q, s
    lib = _build.library()
    err = lib.quant_int8_launch(x.data_ptr(), _CODES[x.dtype], size,
                                q.data_ptr(), s.data_ptr(), nb,
                                _build.stream_handle(x.device))
    _build.check(err, "quant_int8")
    quant_int8_call.launches += 1
    return q, s


quant_int8_call.launches = 0
quant_int8_call.fake_launches = 0


def amax_block_call(x: torch.Tensor) -> torch.Tensor:
    """Per-block max |x| in one read pass.  x: any shape, bf16 or f32 ->
    (nb,) f32; the shared-scale codec's caller agrees it across the pod
    group before quantizing."""
    if x.device.type == "cpu":
        return amax_block_plain(x)
    nb = _codec_input(x, "amax_block")
    a = torch.empty((nb,), dtype=torch.float32, device=x.device)
    if _build.shape_only(x):
        _build.count_shape_only(amax_block_call, "amax_block", x=x, amax=a)
        return a
    vector = x.data_ptr() % VECTOR_ALIGN == 0
    err = _build.library().amax_block_launch(
        x.data_ptr(), _CODES[x.dtype], x.numel(), a.data_ptr(), nb, vector,
        _build.stream_handle(x.device))
    _build.check(err, "amax_block")
    amax_block_call.launches += 1
    amax_block_call.vector_launches += vector
    return a


amax_block_call.launches = 0
amax_block_call.fake_launches = 0
amax_block_call.vector_launches = 0


def quant_scaled_call(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Quantize ``x`` (any shape, bf16 or f32) with the caller's per-block
    ``scale`` (nb,) f32 in one fused scale+round+clip+cast pass ->
    (nb, BLOCK) int8.  A scale <= 0 divides as 1."""
    if x.device.type == "cpu":
        return quant_scaled_plain(x, scale)
    nb = _codec_input(x, "quant_scaled")
    if scale.shape != (nb,) or scale.dtype != torch.float32:
        raise ValueError(f"quant_scaled: scale {tuple(scale.shape)} {scale.dtype}, "
                         f"want ({nb},) float32")
    if scale.device != x.device:
        raise ValueError("quant_scaled: x and scale on different devices")
    scale = scale.contiguous()
    q = torch.empty((nb, BLOCK), dtype=torch.int8, device=x.device)
    if _build.shape_only(x):
        _build.count_shape_only(quant_scaled_call, "quant_scaled", x=x, scale=scale, q=q)
        return q
    vector = x.data_ptr() % VECTOR_ALIGN == 0
    err = _build.library().quant_scaled_launch(
        x.data_ptr(), _CODES[x.dtype], x.numel(), scale.data_ptr(), q.data_ptr(),
        nb, vector, _build.stream_handle(x.device))
    _build.check(err, "quant_scaled")
    quant_scaled_call.launches += 1
    quant_scaled_call.vector_launches += vector
    return q


quant_scaled_call.launches = 0
quant_scaled_call.fake_launches = 0
quant_scaled_call.vector_launches = 0


def dequant_int8_call(q: torch.Tensor, s: torch.Tensor, size: int,
                      dtype=torch.float32, gain: float | None = None):
    """Decode (nb, BLOCK) int8 or int32 with per-block scale ``s`` into
    the first ``size`` values, flat, in ``dtype``.  ``gain`` folds into
    the nb-sized scale vector, never into a payload-sized pass."""
    if q.device.type == "cpu":
        return dequant_int8_plain(q, s, size, dtype, gain)
    if q.dtype not in (torch.int8, torch.int32):
        raise TypeError(f"dequant_int8: int8 or int32 payload, got {q.dtype}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dequant_int8: bf16 or f32 output, got {dtype}")
    nb = q.shape[0]
    if q.shape != (nb, BLOCK) or s.shape != (nb,) or s.dtype != torch.float32:
        raise ValueError(f"dequant_int8: q {tuple(q.shape)}, s {tuple(s.shape)} "
                         f"{s.dtype}")
    if not (0 < size <= nb * BLOCK):
        raise ValueError(f"dequant_int8: size {size} outside the payload")
    if s.device != q.device:
        raise ValueError("dequant_int8: q and s on different devices")
    q = q.contiguous()
    s = (s * gain if gain is not None else s).contiguous()
    out = torch.empty((size,), dtype=dtype, device=q.device)
    if _build.shape_only(q):
        _build.count_shape_only(dequant_int8_call, "dequant_int8", q=q, s=s, out=out)
        return out
    vector = q.data_ptr() % VECTOR_ALIGN == 0
    lib = _build.library()
    err = lib.dequant_int8_launch(q.data_ptr(), _CODES[q.dtype], s.data_ptr(),
                                  size, out.data_ptr(), _CODES[dtype], vector,
                                  _build.stream_handle(q.device))
    _build.check(err, "dequant_int8")
    dequant_int8_call.launches += 1
    dequant_int8_call.vector_launches += vector
    return out


dequant_int8_call.launches = 0
dequant_int8_call.fake_launches = 0
dequant_int8_call.vector_launches = 0


# ---------------------------------------------------------------------------
# Slot packing
# ---------------------------------------------------------------------------

def pack_slots_plain(pieces, padded: int, dtype=torch.float32) -> torch.Tensor:
    """``pieces = [(offset, tensor), ...]`` -> one (padded,) buffer of
    ``dtype`` holding each tensor, flattened, at its offset and zeros
    elsewhere (``copy_`` into a zeroed buffer, casting as it copies)."""
    buf = torch.zeros((padded,), dtype=dtype, device=pieces[0][1].device)
    for off, t in pieces:
        buf[off:off + t.numel()].view(t.shape).copy_(t)
    return buf


def fused_pack_quant_plain(pieces, padded: int):
    """Pack into f32, then the local-scale codec: -> (q (padded/BLOCK,
    BLOCK) int8, s (nb,) f32)."""
    return quant_int8_plain(pack_slots_plain(pieces, padded, torch.float32))


def _spans(pieces, padded: int, what: str) -> tuple[list, int]:
    """The spans covering [0, padded) once, in order: (source tensor or
    None, offset, length, first tile, source dtype code) per row, and the
    number of tiles.  The gaps and the tail become null spans, written as
    zeros.  Raises for pieces the kernels refuse."""
    device = pieces[0][1].device
    rows, pos, tiles = [], 0, 0

    def span(src, off, n, code):
        nonlocal tiles
        rows.append((src, off, n, tiles, code))
        tiles += -(-n // PACK_TILE)

    for off, t in sorted(pieces, key=lambda p: p[0]):
        if t.device != device:
            raise ValueError(f"{what}: pieces on {device} and {t.device}")
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{what}: bf16 or f32 pieces, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: pieces must be contiguous (a strided "
                             "piece is refused, not copied)")
        if off < pos:
            raise ValueError(f"{what}: the piece at {off} overlaps the one before")
        if off > pos:
            span(None, pos, off - pos, _CODES[torch.float32])
        if t.numel():
            span(t, off, t.numel(), _CODES[t.dtype])
        pos = off + t.numel()
    if pos > padded:
        raise ValueError(f"{what}: pieces end at {pos}, past the buffer's {padded}")
    if pos < padded:
        span(None, pos, padded - pos, _CODES[torch.float32])
    return rows, tiles


def _span_table(pieces, padded: int, what: str) -> tuple[torch.Tensor, int]:
    """The kernels' table of ``_spans``: (source address or 0, offset,
    length, first tile, source dtype code) per row, int64, on the card;
    and the number of tiles.  Copied through pinned memory on the current
    stream, so the host does not wait."""
    rows, tiles = _spans(pieces, padded, what)
    table = torch.tensor([(0 if src is None else src.data_ptr(), *rest) for src, *rest in rows],
                         dtype=torch.int64).pin_memory()
    return table.to(pieces[0][1].device, non_blocking=True), tiles


def pack_slots_call(pieces, padded: int, dtype=torch.float32) -> torch.Tensor:
    """Write ``pieces = [(offset, tensor), ...]`` (bf16 or f32, each
    contiguous, any shape) into one new (padded,) buffer of ``dtype``
    (bf16 or f32) at their offsets, and zeros everywhere else, the tail
    pad included: one launch for the whole buffer."""
    if not pieces:
        raise ValueError("pack_slots: no pieces")
    device = pieces[0][1].device
    if device.type == "cpu":
        return pack_slots_plain(pieces, padded, dtype)
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"pack_slots: bf16 or f32 buffer, got {dtype}")
    if _build.shape_only(pieces[0][1]):
        _spans(pieces, padded, "pack_slots")
        buf = torch.empty((padded,), dtype=dtype, device=device)
        _build.count_shape_only(pack_slots_call, "pack_slots", pieces=pieces, buf=buf)
        return buf
    table, tiles = _span_table(pieces, padded, "pack_slots")
    buf = torch.empty((padded,), dtype=dtype, device=device)
    err = _build.library().pack_slots_launch(
        table.data_ptr(), table.shape[0], tiles, PACK_TILE, buf.data_ptr(), _CODES[dtype],
        _build.stream_handle(device))
    _build.check(err, "pack_slots")
    pack_slots_call.launches += 1
    return buf


pack_slots_call.launches = 0
pack_slots_call.fake_launches = 0


def fused_pack_quant_call(pieces, padded: int):
    """Pack ``pieces`` (as ``pack_slots_call``) into f32 and quantize with
    the local scale in one pass: -> (q (padded/BLOCK, BLOCK) int8, s (nb,)
    f32), bit-equal to ``quant_int8_call(pack_slots_call(pieces, padded))``.
    ``padded`` must be a multiple of BLOCK."""
    if not pieces:
        raise ValueError("fused_pack_quant: no pieces")
    if padded <= 0 or padded % BLOCK:
        raise ValueError(f"fused_pack_quant: padded {padded} is not a positive "
                         f"multiple of {BLOCK}")
    device = pieces[0][1].device
    if device.type == "cpu":
        return fused_pack_quant_plain(pieces, padded)
    nb = padded // BLOCK
    if _build.shape_only(pieces[0][1]):
        _spans(pieces, padded, "fused_pack_quant")
        q = torch.empty((nb, BLOCK), dtype=torch.int8, device=device)
        s = torch.empty((nb,), dtype=torch.float32, device=device)
        _build.count_shape_only(fused_pack_quant_call, "fused_pack_quant", pieces=pieces,
                                q=q, s=s)
        return q, s
    table, _ = _span_table(pieces, padded, "fused_pack_quant")
    q = torch.empty((nb, BLOCK), dtype=torch.int8, device=device)
    s = torch.empty((nb,), dtype=torch.float32, device=device)
    err = _build.library().fused_pack_quant_launch(
        table.data_ptr(), table.shape[0], nb, q.data_ptr(), s.data_ptr(),
        _build.stream_handle(device))
    _build.check(err, "fused_pack_quant")
    fused_pack_quant_call.launches += 1
    return q, s


fused_pack_quant_call.launches = 0
fused_pack_quant_call.fake_launches = 0
