"""Flash attention, causal / sliding-window GQA: the wrapper of the CUDA
kernel in ``csrc/flash_attention.cu`` and its plain version.

Layout as in the JAX package's ``kernels/flash_attention.py``: q
(B, H, Sq, dh), k/v (B, K, Skv, dh), query head h reads kv head
h // (H // K).  The kernel takes strided views (the last axis
contiguous), masks ragged lengths itself and needs no padding of dh.
bf16 runs on the tensor cores and copies 16 bytes at a time, so a bf16
tensor's base and strides must be 16-byte aligned; f32 runs on the CUDA
cores and takes any strides.
"""

from __future__ import annotations

import math

import torch

from . import _build, ref

HEAD_DIMS = (16, 32, 64, 80, 128)
_CODES = {torch.float32: _build.F32, torch.bfloat16: _build.BF16}


def flash_attention_bhsd_plain(q, k, v, *, causal: bool = True,
                               window: int | None = None, q_offset: int = 0,
                               valid_kv: int | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``ref.attention`` in the
    head-major layout."""
    out = ref.attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        causal=causal, window=window, q_offset=q_offset,
                        valid_kv=valid_kv)
    return out.transpose(1, 2)


def _check(q, k, v, out, valid_kv):
    B, H, Sq, dh = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != dh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    K, Skv = k.shape[1], k.shape[2]
    if K == 0 or H % K:
        raise ValueError(f"flash_attention: {H} q heads over {K} kv heads")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head size {dh} not in {HEAD_DIMS}")
    if q.dtype not in _CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: bf16 or f32, one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if out.shape != q.shape or out.dtype != q.dtype:
        raise ValueError("flash_attention: out must match q")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}")
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name} head axis not contiguous")
        # an axis of extent 1 is never stepped, so its stride is free
        if t.dtype == torch.bfloat16 and (t.data_ptr() % 16 or any(
                st % 8 for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1)):
            raise ValueError(f"flash_attention: bf16 {name} not 16-byte aligned "
                             f"(base or strides {t.stride()})")
    if not 0 <= valid_kv <= Skv:
        raise ValueError(f"flash_attention: valid_kv {valid_kv} outside 0..{Skv}")


def flash_attention_bhsd(q, k, v, *, causal: bool = True,
                         window: int | None = None, q_offset: int = 0,
                         valid_kv: int | None = None,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """q: (B, H, Sq, dh), k/v: (B, K, Skv, dh) -> (B, H, Sq, dh), written
    into ``out`` when given (any strides with a contiguous last axis).
    ``q_offset`` and ``valid_kv`` are Python ints."""
    if not isinstance(q_offset, int) or not (valid_kv is None or isinstance(valid_kv, int)):
        raise TypeError("flash_attention: q_offset and valid_kv are Python ints")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if q.device.type == "cpu":
        res = flash_attention_bhsd_plain(q, k, v, causal=causal, window=window,
                                         q_offset=q_offset, valid_kv=valid_kv)
        return res if out is None else out.copy_(res)
    B, H, Sq, dh = q.shape
    K, Skv = k.shape[1], k.shape[2]
    if out is None:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
    valid_kv = Skv if valid_kv is None else valid_kv
    _check(q, k, v, out, valid_kv)
    scale = 1.0 / math.sqrt(dh)
    lib = _build.library()
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _CODES[q.dtype], B, H, K, Sq, Skv, dh,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        scale, int(causal), 0 if window is None else window, q_offset,
        valid_kv, _build.stream_handle(q.device))
    _build.check(err, "flash_attention")
    flash_attention_bhsd.launches += 1
    return out


flash_attention_bhsd.launches = 0
