"""Local-scale int8 block codec: the wire format of the disaggregated
KV-cache transfer.

The counterpart of ``quantize_int8`` / ``dequantize_int8`` in the JAX
package's ``core/compression.py``: per 1024-element block, symmetric int8
with an f32 scale.  Both go straight to the codec kernels, which read
the bf16 or f32 leaf as it is (no upcast, no zero-pad copy) and give the
same bits as the JAX path.  The shared-scale collective codec of the
gradient sync belongs to the training path and is not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import quant as _qk

BLOCK = _qk.BLOCK


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: any shape, bf16 or f32 -> (q (nb, BLOCK) int8, scale (nb,) f32)."""
    return _qk.quant_int8_call(x.contiguous())


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, size: int,
                    dtype=torch.float32, gain: float | None = None) -> torch.Tensor:
    """The first ``size`` decoded values, flat, in ``dtype``."""
    return _qk.dequant_int8_call(q, scale, size, dtype, gain)
