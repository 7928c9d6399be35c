"""Plain PyTorch versions of the kernels' functions, in the layouts of
the JAX package's ``kernels/ref.py``.  The kernel wrappers take these for
tensors on the CPU, and the card's checks hold each kernel against them.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              q_offset: int = 0, valid_kv: int | None = None) -> torch.Tensor:
    """q: (B, Sq, H, dh); k/v: (B, Skv, K, dh), H % K == 0 -> (B, Sq, H, dh).

    The flash kernel's function, f32 throughout: causal and window masks
    with q[0] at position ``q_offset``, keys from ``valid_kv`` on masked,
    and a row whose keys are all masked gives 0."""
    B, Sq, H, dh = q.shape
    Skv, K = k.shape[1], k.shape[2]
    rep = H // K
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * (1.0 / math.sqrt(dh))
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = kpos < (Skv if valid_kv is None else valid_kv)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(torch.where(m > NEG_INF / 2, s - m, NEG_INF))
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l == 0, 1.0, l)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


# The reference's compiled code computes amax / 127 as amax times the f32
# reciprocal (XLA rewrites a division by a constant so), which differs
# from a true division by one ulp for some amax; the port follows it.
INV127 = 1.0 / 127.0


def _to_int8(r: torch.Tensor) -> torch.Tensor:
    """clip(round_half_even(r), -127, 127) as int8, NaN as 0 (XLA's float
    to int conversion; a cast of NaN is otherwise undefined)."""
    q = torch.clamp(torch.round(r), -127, 127)
    return torch.where(q.isnan(), 0.0, q).to(torch.int8)


def quant_int8_block(x: torch.Tensor, block: int = 1024):
    """x: flat (N,) with N % block == 0 -> (q int8 (N//block, block),
    scales f32 (N//block,)).  s = amax * f32(1/127) (1 where amax is 0);
    q = clip(round_half_even(x / s), -127, 127) by true division."""
    if x.ndim != 1 or x.numel() % block:
        raise ValueError(f"quant_int8_block: flat multiple of {block}, got {tuple(x.shape)}")
    blocks = x.float().reshape(-1, block)
    amax = blocks.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax * INV127, torch.ones_like(amax))
    return _to_int8(blocks / scale[:, None]), scale


def amax_block(x: torch.Tensor, block: int = 1024) -> torch.Tensor:
    """x: flat (N,) with N % block == 0 -> per-block max |x|, (N//block,) f32."""
    if x.ndim != 1 or x.numel() % block:
        raise ValueError(f"amax_block: flat multiple of {block}, got {tuple(x.shape)}")
    return x.float().reshape(-1, block).abs().amax(dim=1)


def quant_scaled_block(x: torch.Tensor, scale: torch.Tensor,
                       block: int = 1024) -> torch.Tensor:
    """Quantize flat ``x`` (N % block == 0) with per-block ``scale``:
    clip(round_half_even(x / s'), -127, 127) as int8 (nb, block), where
    s' = s if s > 0 else 1, by true division."""
    if x.ndim != 1 or x.numel() % block:
        raise ValueError(f"quant_scaled_block: flat multiple of {block}, "
                         f"got {tuple(x.shape)}")
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    return _to_int8(x.float().reshape(-1, block) / safe[:, None])


def dequant_int8_block(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (q.float() * scale[:, None]).reshape(-1)
