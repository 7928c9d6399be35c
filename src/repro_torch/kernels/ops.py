"""Dispatch wrappers over the kernels in the model layer's layouts.

The counterpart of the JAX package's ``kernels/ops.py``: each op takes
the model's layout, calls the kernel wrapper (which launches the CUDA
kernel for a tensor on the card and the plain version for one on the
CPU) and keeps the semantics of ``ref.py``.
"""

from __future__ import annotations

import torch

from . import flash_attention as _fa
from . import quant as _q
from . import ref
from . import ssd as _ssd

KERNELS = {"flash_attention_bhsd": _fa.flash_attention_bhsd,
           "quant_int8": _q.quant_int8_call,
           "dequant_int8": _q.dequant_int8_call,
           "amax_block": _q.amax_block_call,
           "quant_scaled": _q.quant_scaled_call,
           "ssd_chunk": _ssd.ssd_chunk_call,
           "pack_slots": _q.pack_slots_call,
           "fused_pack_quant": _q.fused_pack_quant_call}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def vector_launch_counts() -> dict[str, int]:
    """Launches of the vector variant, for the kernels that have one."""
    return {name: fn.vector_launches for name, fn in KERNELS.items()
            if hasattr(fn, "vector_launches")}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
        if hasattr(fn, "vector_launches"):
            fn.vector_launches = 0


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, dh); k/v: (B, Skv, K, dh) -> (B, Sq, H, dh).

    The kernel reads the sequence-major tensors through head-major views
    and writes its output straight into the (B, Sq, H, dh) result, so no
    transpose is copied."""
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _fa.flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=causal, window=window,
                             q_offset=q_offset, valid_kv=k.shape[1],
                             out=out.transpose(1, 2))
    return out


def ssd_chunked(x, dt, A, B, C, chunk: int = 128):
    """Same contract as ``ref.ssd_chunked`` with a zero initial state:
    x (b, s, h, p), dt (b, s, h), A (h,), B/C (b, s, g, n), s a multiple
    of ``chunk`` -> (y (b, s, h, p) in x's dtype, final state (b, h, p, n)
    f32).  The kernel computes each chunk's y_diag and state; the
    inter-chunk recurrence (s / chunk steps over (p, n) states) and y_off
    follow in PyTorch, with chunk_decay = exp(dA_cs[-1]) as in the
    reference's ``ops.ssd_chunked`` (its ``ref`` sums dA instead)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if s % chunk:
        raise ValueError(f"ssd_chunked: length {s} is not a multiple of {chunk}")
    nc, q, rep = s // chunk, chunk, h // g
    y_diag, states = _ssd.ssd_chunk_call(x, dt, A, B, C, chunk)
    with torch.profiler.record_function("ssd_inter_chunk"):
        dA_cs = torch.cumsum((dt.float() * A.float()).reshape(b, nc, q, h), dim=2)
        chunk_decay = torch.exp(dA_cs[:, :, -1])                 # (b, nc, h)
        hstate = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
        before = []
        for c in range(nc):
            before.append(hstate)
            hstate = hstate * chunk_decay[:, c, :, None, None] + states[:, c]
        h_before = torch.stack(before, dim=1).reshape(b, nc, g, rep, p, n)
        # y_off[i] = exp(dA_cs[i]) * (C_i . h_before), C read per group
        Cg = C.float().reshape(b, nc, q, g, n)
        y_off = torch.einsum("bcqgn,bcgrpn->bcqgrp", Cg, h_before)
        y_off = y_off.reshape(b, nc, q, h, p) * torch.exp(dA_cs)[..., None]
        y = (y_diag + y_off).reshape(b, s, h, p)
    return y.to(x.dtype), hstate


def causal_conv1d(x, w, bias=None):
    """Depthwise causal conv, x (b, s, ch), w (ch, width).  The reference
    has no kernel for it (its ``ops.causal_conv1d`` is the jnp form), so
    every device runs the plain version."""
    with torch.profiler.record_function("causal_conv1d"):
        return ref.causal_conv1d(x, w, bias)


def quant_int8(x: torch.Tensor):
    """x: any shape -> (q (nb, 1024) int8, scales (nb,), orig_size)."""
    q, s = _q.quant_int8_call(x.contiguous())
    return q, s, x.numel()


def dequant_int8(q, s, size: int, shape, dtype=torch.float32):
    return _q.dequant_int8_call(q, s, size, dtype).reshape(shape)
