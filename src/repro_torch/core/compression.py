"""Wire codecs: the local-scale int8 codec of the disaggregated KV-cache
transfer, and the pod-hop gradient compression of the gradient sync.

The counterpart of the JAX package's ``core/compression.py``:
  * ``bf16`` — round to bf16 on the wire, summed by the native all-reduce.
  * ``int8`` — per 1024-element block, symmetric int8 with an f32 scale
    shared across the pod group (all-reduce MAX of the per-block amax),
    so the int8 payloads sum exactly in an int32 accumulator; int8 is
    what crosses the wire (a reduce ring of ``batch_isend_irecv``).

The block codec runs the CUDA kernels of ``kernels/quant.py`` for a
tensor on the card (``amax_block``, ``quant_scaled``, ``dequant_int8``)
and their plain versions for one on the CPU.  The kernels read the bf16
or f32 payload as it is, with the ragged tail as zeros, where the
reference upcasts to f32 and pads; the results are the same bits.  A
``group`` of ``None`` is a group of one.  ``psum_ef`` is the
error-feedback form of either codec: the quantization residual of one
step is added to the next step's payload.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.kernels import quant as _qk
from repro_torch.kernels import ref as _ref
from repro_torch.parallel.sharding import group_size
from . import primitives

BLOCK = _qk.BLOCK


# ---------------------------------------------------------------------------
# Local-scale codec (KV transfer)
# ---------------------------------------------------------------------------

def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: any shape, bf16 or f32 -> (q (nb, BLOCK) int8, scale (nb,) f32)."""
    return _qk.quant_int8_call(x.contiguous())


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, size: int,
                    dtype=torch.float32, gain: float | None = None) -> torch.Tensor:
    """The first ``size`` decoded values, flat, in ``dtype``."""
    return _qk.dequant_int8_call(q, scale, size, dtype, gain)


# ---------------------------------------------------------------------------
# Shared-scale collective codec (gradient sync)
# ---------------------------------------------------------------------------

def _shared_scale(amax: torch.Tensor, group) -> torch.Tensor:
    """Per-block scale agreed across ``group``: max over its ranks, then
    amax * f32(1/127) (the reference's compiled division, R6), 1 where
    the block is all zeros."""
    if group_size(group) > 1:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    return torch.where(amax > 0, amax * _ref.INV127, torch.ones_like(amax))


def _ring_int8_sum(q: torch.Tensor, group) -> torch.Tensor:
    """Sum int8 payloads over ``group`` with int8 on the wire: a reduce
    ring accumulating locally in int32."""
    world = group_size(group)
    acc = q.to(torch.int32)
    cur = q
    for _ in range(world - 1):
        (cur,) = primitives.shift([cur], group)
        acc += cur
    return acc


def int8_encode(x: torch.Tensor, group, weight: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Compress stage: per-block amax -> cluster-weight fold -> MAX over
    ``group`` -> quantize.  Returns (q (nb, BLOCK) int8, shared scale
    (nb,) f32).  ``weight`` (this rank's f32 cluster weight, a 0-d
    tensor) multiplies the nb-sized amax and divides the encode scale,
    which quantizes ``w * x`` without a payload-sized pass."""
    x = x.reshape(-1).contiguous()
    amax = _qk.amax_block_call(x)
    if weight is not None:
        weight = weight.to(device=amax.device, dtype=torch.float32)
        amax = amax * weight
    scale = _shared_scale(amax, group)
    enc_scale = scale if weight is None else scale / weight
    return _qk.quant_scaled_call(x, enc_scale), scale


def int8_transfer(q: torch.Tensor, scale: torch.Tensor, group, size: int,
                  dtype=torch.float32) -> torch.Tensor:
    """Transfer stage: int8 reduce ring over ``group``, then the decode of
    the int32 sums into the first ``size`` values, flat, in ``dtype``."""
    return _qk.dequant_int8_call(_ring_int8_sum(q, group), scale, size, dtype)


def compressed_psum(x: torch.Tensor, group, codec: str,
                    weight: torch.Tensor | None = None) -> torch.Tensor:
    """All-reduce ``x`` over ``group`` with wire compression.  ``weight``
    is this rank's cluster gradient weight (the deferred ``Scale`` step),
    folded into the codec.  ``x`` is consumed."""
    if codec == "bf16":
        if weight is not None:
            x = x * weight.to(device=x.device, dtype=x.dtype)
        return primitives.c2c_red(x.to(torch.bfloat16), group).to(x.dtype)
    if codec == "int8":
        # int8_transfer inlined, so that x is freed once quantized and q once
        # the ring has summed it (on the card, ZeRO-1's f32 gradient segment
        # is 12.34 GB and q 3.09 GB, beside a 12.34 GB int32 sum); x goes
        # only if the caller handed it over, holding no reference of its own
        size, dtype, shape = x.numel(), x.dtype, x.shape
        q, scale = int8_encode(x, group, weight=weight)
        del x
        acc = _ring_int8_sum(q, group)
        del q
        return _qk.dequant_int8_call(acc, scale, size, dtype).reshape(shape)
    raise ValueError(f"unknown codec {codec!r}")


def psum_ef(x: torch.Tensor, residual: torch.Tensor, group,
            codec: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback compressed all-reduce over ``group``: the wire
    carries the compressed payload, and the local quantization error is
    returned as the next step's residual.

        corrected = x + residual
        wire      = psum(encode(corrected))          # compressed payload
        residual' = corrected - decode(encode(corrected))
    """
    corrected = x + residual
    if codec == "bf16":
        enc = corrected.to(torch.bfloat16)
        summed = primitives.c2c_red(enc.clone(), group).to(x.dtype)
        return summed, corrected - enc.to(corrected.dtype)
    if codec == "int8":
        size = corrected.numel()
        flat = corrected.reshape(-1).contiguous()
        scale = _shared_scale(_qk.amax_block_call(flat), group)
        q = _qk.quant_scaled_call(flat, scale)
        # corrected - q * scale rounded once: the reference's compiled
        # subtract-of-product is one fused multiply-add (the f64 product is
        # exact, and so is the difference for a residual of this size)
        local_dec = (q.double() * scale.double()[:, None]).view(-1)[:size]
        new_res = (flat.double() - local_dec).float()
        summed = _qk.dequant_int8_call(_ring_int8_sum(q, group), scale, size, torch.float32)
        return (summed.reshape(x.shape).to(x.dtype),
                new_res.reshape(x.shape).to(residual.dtype))
    raise ValueError(codec)
