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


# ---------------------------------------------------------------------------
# Mamba2 SSD (state-space duality): chunked scan, decode step, front conv
# ---------------------------------------------------------------------------

def ssd_chunked(x, dt, A, B, C, chunk: int = 64):
    """Chunked SSD (Mamba-2, arXiv:2405.21060 listing 1), in the order of
    operations of the reference's ``ref.ssd_chunked``.

    x: (b, s, h, p); dt: (b, s, h) (softplus'd, > 0); A: (h,) negative;
    B/C: (b, s, g, n), heads share their group's rows -> y (b, s, h, p)
    in x's dtype, final state (b, h, p, n) f32.  The state starts at 0.
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if s % chunk:
        raise ValueError(f"ssd_chunked: length {s} is not a multiple of {chunk}")
    nc, q = s // chunk, chunk
    rep = h // g

    xc = x.float().reshape(b, nc, q, h, p)
    dtc = dt.float().reshape(b, nc, q, h)
    Bc = B.float().repeat_interleave(rep, dim=2).reshape(b, nc, q, h, n)
    Cc = C.float().repeat_interleave(rep, dim=2).reshape(b, nc, q, h, n)

    dA = dtc * A.float()                                      # (b, nc, q, h)
    dA_cs = torch.cumsum(dA, dim=2)

    # 1) intra-chunk: causal "attention" with decay, masked BEFORE exp
    seg = dA_cs[:, :, :, None, :] - dA_cs[:, :, None, :, :]   # (b,nc,q_i,q_j,h)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    seg = torch.where(causal[None, None, :, :, None], seg, NEG_INF)
    L = torch.exp(seg)
    scores = torch.einsum("bcihn,bcjhn->bcijh", Cc, Bc) * L
    y_diag = torch.einsum("bcijh,bcjh,bcjhp->bcihp", scores, dtc, xc)

    # 2) chunk states: decay-weighted outer products at the chunk's end
    decay_to_end = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)     # (b, nc, q, h)
    states = torch.einsum("bcqh,bcqh,bcqhn,bcqhp->bchpn",
                          decay_to_end, dtc, Bc, xc)

    # 3) inter-chunk recurrence, emitting the state before each chunk
    chunk_decay = torch.exp(dA.sum(dim=2))                    # (b, nc, h)
    hstate = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    before = []
    for c in range(nc):
        before.append(hstate)
        hstate = hstate * chunk_decay[:, c, :, None, None] + states[:, c]
    h_before = torch.stack(before, dim=1)                     # (b, nc, h, p, n)

    # 4) inter-chunk contribution
    in_decay = torch.exp(dA_cs)
    y_off = torch.einsum("bcqhn,bcqh,bchpn->bcqhp", Cc, in_decay, h_before)
    y = (y_diag + y_off).reshape(b, s, h, p)
    return y.to(x.dtype), hstate


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t):
    """One-token SSD update.  state: (b, h, p, n) f32; x_t: (b, h, p);
    dt_t: (b, h); B_t/C_t: (b, g, n) -> y_t (b, h, p) in x_t's dtype,
    new state (b, h, p, n) f32."""
    rep = x_t.shape[1] // B_t.shape[1]
    Bf = B_t.float().repeat_interleave(rep, dim=1)            # (b, h, n)
    Cf = C_t.float().repeat_interleave(rep, dim=1)
    dtf = dt_t.float()
    dA = torch.exp(dtf * A.float())                           # (b, h)
    upd = dtf[..., None, None] * x_t.float()[..., None] * Bf[:, :, None, :]
    new = state * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", new, Cf)
    return y.to(x_t.dtype), new


def causal_conv1d(x, w, bias=None):
    """Depthwise causal conv, x: (b, s, ch); w: (ch, width) -> (b, s, ch):
    the left-padded tap loop in f32, cast back to x's dtype."""
    b, s, ch = x.shape
    width = w.shape[1]
    xp = torch.nn.functional.pad(x.float(), (0, 0, width - 1, 0))
    wf = w.float()
    out = torch.zeros((b, s, ch), dtype=torch.float32, device=x.device)
    for i in range(width):
        out = out + xp[:, i:i + s] * wf[:, i]
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)
