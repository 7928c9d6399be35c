"""Shared neural building blocks: norms, QK-norm, RoPE, embedding, LM
head, SwiGLU.

Parameters are plain dicts of tensors at init (the JAX package's param
pytree, leaf for leaf) and ``nn.ParameterDict``s once a ``Model`` holds
them; the apply functions read either.  Init draws from an explicit
``torch.Generator`` on the target device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.parallel.sharding import Runtime, copy_to_tp, reduce_from_tp, tp_entry_group


def init_dense(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float | None = None) -> torch.Tensor:
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * s).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(kind: str, d: int, dtype, device) -> dict:
    if kind == "rmsnorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "ln":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    if kind == "ln_nonparam":       # OLMo: non-parametric LayerNorm
        return {}
    raise ValueError(kind)


def apply_norm(p, x: torch.Tensor, kind: str, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = (xf * xf).mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"].float()
    else:
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps)
        if kind == "ln":
            out = out * p["scale"].float() + p["bias"].float()
    return out.to(x.dtype)


def rms_norm_head(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Parameter-free RMS norm over the last axis (chameleon's QK-norm, per
    head), in f32 and cast back."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (split halves)
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, dh), positions: (..., S) integer."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)               # (dh/2,)
    ang = positions[..., None].float() * freqs             # (..., S, dh/2)
    cos = torch.cos(ang)[..., None, :]                     # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding and LM head
# ---------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, vocab_padded: int, d: int, dtype) -> torch.Tensor:
    tbl = torch.randn((vocab_padded, d), generator=gen, dtype=torch.float32,
                      device=gen.device) * 0.02
    return tbl.to(dtype)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """Vocab-sharded lookup: each rank holds rows [r * Vl, (r + 1) * Vl)
    of the table, takes the ids that fall there, zeroes the rest, and the
    rows meet in a sum over the TP group."""
    if rt.tp_group is None:
        return table[ids]
    vl = table.shape[0]
    local = ids - rt.tp_rank * vl
    ok = (local >= 0) & (local < vl)
    emb = table[torch.where(ok, local, 0)]
    emb = torch.where(ok[..., None], emb, torch.zeros((), dtype=emb.dtype, device=emb.device))
    return reduce_from_tp(emb, rt.tp_group)


def lm_head_logits(x: torch.Tensor, table: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """Vocab-sharded logits (B, S, Vl) in f32.  As in the reference, the
    local table is cast to f32 on every call (151936 x 2048 for
    qwen2.5-3b at TP 1: 1.24 GB)."""
    x = copy_to_tp(x, rt.tp_group)
    return x.float() @ table.float().T


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, d_ff: int, dtype) -> dict:
    return {"w_gate": init_dense(gen, d, d_ff, dtype),
            "w_up": init_dense(gen, d, d_ff, dtype),
            "w_down": init_dense(gen, d_ff, d, dtype)}


def apply_mlp(p, x: torch.Tensor, rt: Runtime, reduce: bool = True,
              last: bool = False) -> torch.Tensor:
    """Column-parallel gate and up, row-parallel down; ``reduce=False``
    returns the partial sums (sequence parallelism reduce-scatters them).
    ``last``: the layer's last sum (``reduce_from_tp``)."""
    x = copy_to_tp(x, tp_entry_group(rt))
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    out = h @ p["w_down"]
    return reduce_from_tp(out, rt.tp_group, last) if reduce else out
