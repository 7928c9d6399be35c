"""Blockwise int8 quantize / dequantize: the local-scale codec of the
disaggregated KV-cache transfer and the shared-scale codec of the
gradient sync.

Symmetric int8 per 1024-element block with an f32 scale, as in the JAX
package's ``kernels/quant.py``.  Each ``*_call`` launches its CUDA kernel
of ``csrc/quant.cu`` for a tensor on the card and uses its plain version
(``*_plain``) for a tensor on the CPU; each counts its kernel launches in
``.launches``.  The shared-scale codec is two kernels: ``amax_block_call``
(per-block max |x|, agreed across the pod group by the caller) and
``quant_scaled_call`` (quantize with that scale).  Every input is read
as it is, bf16 or f32, with the ragged tail counted as zeros.  The
packing kernels are not ported yet.
"""

from __future__ import annotations

import torch

from . import _build, ref

BLOCK = 1024
_CODES = {torch.float32: _build.F32, torch.bfloat16: _build.BF16,
          torch.int8: _build.INT8, torch.int32: _build.INT32}


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
    lib = _build.library()
    err = lib.quant_int8_launch(x.data_ptr(), _CODES[x.dtype], size,
                                q.data_ptr(), s.data_ptr(), nb,
                                _build.stream_handle(x.device))
    _build.check(err, "quant_int8")
    quant_int8_call.launches += 1
    return q, s


quant_int8_call.launches = 0


def amax_block_call(x: torch.Tensor) -> torch.Tensor:
    """Per-block max |x| in one read pass.  x: any shape, bf16 or f32 ->
    (nb,) f32; the shared-scale codec's caller agrees it across the pod
    group before quantizing."""
    if x.device.type == "cpu":
        return amax_block_plain(x)
    nb = _codec_input(x, "amax_block")
    a = torch.empty((nb,), dtype=torch.float32, device=x.device)
    err = _build.library().amax_block_launch(
        x.data_ptr(), _CODES[x.dtype], x.numel(), a.data_ptr(), nb,
        _build.stream_handle(x.device))
    _build.check(err, "amax_block")
    amax_block_call.launches += 1
    return a


amax_block_call.launches = 0


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
    err = _build.library().quant_scaled_launch(
        x.data_ptr(), _CODES[x.dtype], x.numel(), scale.data_ptr(), q.data_ptr(),
        nb, _build.stream_handle(x.device))
    _build.check(err, "quant_scaled")
    quant_scaled_call.launches += 1
    return q


quant_scaled_call.launches = 0


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
    lib = _build.library()
    err = lib.dequant_int8_launch(q.data_ptr(), _CODES[q.dtype], s.data_ptr(),
                                  size, out.data_ptr(), _CODES[dtype],
                                  _build.stream_handle(q.device))
    _build.check(err, "dequant_int8")
    dequant_int8_call.launches += 1
    return out


dequant_int8_call.launches = 0
