"""Flash attention, causal / sliding-window GQA: the wrapper of the CUDA
kernels in ``csrc/flash_attention.cu`` and its plain version.

Layout as in the JAX package's ``kernels/flash_attention.py``: q
(B, H, Sq, dh), k/v (B, K, Skv, dh), query head h reads kv head
h // (H // K).  The kernels take strided views (the last axis
contiguous), mask ragged lengths themselves and need no padding of dh.

On the card the dtype and the head size alone choose the kernel
(``route``): bf16 at dh 64 and 128 runs the Hopper kernel (TMA loads
into an mbarrier ring, warp-specialised wgmma), bf16 at 16, 32 and 80
the mma.sync kernel, f32 the tensor cores at f32 accuracy (each f32
operand split into TF32 hi + lo, three mma.sync products for each).
Each launch is counted in ``.launches`` and, by route, in
``.route_launches``.  bf16 kernels copy 16 bytes at a time (TMA or
cp.async), so a bf16 tensor's base and strides must be 16-byte aligned;
f32 takes any strides (16-byte copies where they allow, 4-byte ones
otherwise).
"""

from __future__ import annotations

import math

import torch

from . import _build, ref

HEAD_DIMS = (16, 32, 64, 80, 128)
WGMMA_HEAD_DIMS = (64, 128)
ROUTES = ("wgmma", "mma", "tf32x3")
# keys per tile of each route's kernel (kWgKeys, kBc, kTfKeys)
KEY_TILE = {"wgmma": 128, "mma": 64, "tf32x3": 32}
# The f32 route's distance from f32 attention, as a share of the output's
# largest magnitude.  Three TF32 products keep about 2^-21 of each product,
# one 2^-11: tests/test_torch_kernels.py's emulation of both at smoke shapes
# errs by 1.8e-7-4.1e-7 and 4.7e-4-6.1e-4 of the largest magnitude, so
# this sits 49x above the first and 23x below the second.
TF32X3_TOL = 2e-5
_CODES = {torch.float32: _build.F32, torch.bfloat16: _build.BF16}


def route(dtype: torch.dtype, dh: int) -> str:
    """The kernel a call on the card runs, as ``flash_attention_launch``
    picks it: "wgmma" (``flash_attention_wgmma_kernel``) for bf16 at dh 64
    and 128, "mma" (``flash_attention_mma_kernel``) for bf16 at the other
    head sizes, "tf32x3" (``flash_attention_tf32x3_kernel``, 3xTF32
    ``mma.sync``) for f32 at every head size."""
    if dtype == torch.float32:
        return "tf32x3"
    return "wgmma" if dh in WGMMA_HEAD_DIMS else "mma"


def flash_attention_bhsd_plain(q, k, v, *, causal: bool = True,
                               window: int | None = None, q_offset: int = 0,
                               valid_kv: int | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``ref.attention`` in the
    head-major layout."""
    out = ref.attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        causal=causal, window=window, q_offset=q_offset,
                        valid_kv=valid_kv)
    return out.transpose(1, 2)


def _check(q, k, v, out, valid_kv, with_data: bool = True):
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
    # every call on the card passes here, so the host's work is kept small
    # (t.stride() once: t.stride(i) costs the host microseconds a call)
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}")
        st, n = t.stride(), t.shape
        if st[3] != 1:
            raise ValueError(f"flash_attention: {name} head axis not contiguous")
        # an axis of extent 1 is never stepped, so its stride is free
        if t.dtype == torch.bfloat16 and (
                (with_data and t.data_ptr() % 16) or (n[0] > 1 and st[0] % 8)
                or (n[1] > 1 and st[1] % 8) or (n[2] > 1 and st[2] % 8)):
            raise ValueError(f"flash_attention: bf16 {name} not 16-byte aligned "
                             f"(base or strides {st})")
    if not 0 <= valid_kv <= Skv:
        raise ValueError(f"flash_attention: valid_kv {valid_kv} outside 0..{Skv}")


def flash_attention_bhsd(q, k, v, *, causal: bool = True,
                         window: int | None = None, q_offset: int = 0,
                         valid_kv: int | None = None,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """q: (B, H, Sq, dh), k/v: (B, K, Skv, dh) -> (B, H, Sq, dh), written
    into ``out`` when given (any strides with a contiguous last axis).
    ``q_offset`` and ``valid_kv`` are Python ints.  On the card it raises
    ``NoBackwardError`` under autograd when an input requires grad (the
    kernel has no backward)."""
    if not isinstance(q_offset, int) or not (valid_kv is None or isinstance(valid_kv, int)):
        raise TypeError("flash_attention: q_offset and valid_kv are Python ints")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if q.device.type == "cpu":
        res = flash_attention_bhsd_plain(q, k, v, causal=causal, window=window,
                                         q_offset=q_offset, valid_kv=valid_kv)
        return res if out is None else out.copy_(res)
    _build.refuse_autograd("flash_attention", q, k, v, out)
    B, H, Sq, dh = q.shape
    K, Skv = k.shape[1], k.shape[2]
    if out is None:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
    valid_kv = Skv if valid_kv is None else valid_kv
    if _build.shape_only(q):
        _check(q, k, v, out, valid_kv, with_data=False)
        _build.count_shape_only(flash_attention_bhsd, "flash_attention", q=q, k=k, v=v, out=out,
                                causal=causal, window=window, q_offset=q_offset,
                                valid_kv=valid_kv)
        flash_attention_bhsd.route_fake_launches[route(q.dtype, dh)] += 1
        return out
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
    flash_attention_bhsd.route_launches[route(q.dtype, dh)] += 1
    return out


flash_attention_bhsd.launches = 0
flash_attention_bhsd.fake_launches = 0
flash_attention_bhsd.route_launches = dict.fromkeys(ROUTES, 0)
flash_attention_bhsd.route_fake_launches = dict.fromkeys(ROUTES, 0)
