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

KERNELS = {"flash_attention_bhsd": _fa.flash_attention_bhsd,
           "quant_int8": _q.quant_int8_call,
           "dequant_int8": _q.dequant_int8_call,
           "amax_block": _q.amax_block_call,
           "quant_scaled": _q.quant_scaled_call}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


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


def quant_int8(x: torch.Tensor):
    """x: any shape -> (q (nb, 1024) int8, scales (nb,), orig_size)."""
    q, s = _q.quant_int8_call(x.contiguous())
    return q, s, x.numel()


def dequant_int8(q, s, size: int, shape, dtype=torch.float32):
    return _q.dequant_int8_call(q, s, size, dtype).reshape(shape)
