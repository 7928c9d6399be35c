"""GQA attention: prefill (writes the KV cache) and decode.

Parameters, as in the JAX package: ``wq (D, H*dh)``, ``wk/wv (D, K*dh)``,
``wo (H*dh, D)``, optional ``bq/bk/bv``.  Prefill attention goes through
the flash kernel (``kernels/ops.flash_attention``) with a plain integer
offset; short prompts and decode use plain PyTorch, as the reference
does.

Caches are updated in place: prefill writes a freshly allocated cache,
and decode writes one slot of the cache it is given (the reference's
decode step donates its cache, so no caller sees the old one either).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.parallel.sharding import Runtime, copy_to_tp, reduce_from_tp
from . import layers

NEG_INF = -1e30
FLASH_MIN_Q = 128     # prefill shorter than this takes sdpa_reference


class KVCache(NamedTuple):
    k: torch.Tensor        # stacked (L, B, W, Kl, dh), or one layer's (B, W, Kl, dh)
    v: torch.Tensor
    length: torch.Tensor   # (L,) int32, or one layer's (): tokens written so far

    @property
    def window(self) -> int:
        return self.k.shape[-3]

    def layer(self, i: int) -> "KVCache":
        """Views of layer ``i`` of a stacked cache."""
        return KVCache(self.k[i], self.v[i], self.length[i])


def init_attention(gen: torch.Generator, cfg: ModelConfig, tp: int, dtype) -> dict:
    """Attention params; q heads padded to a multiple of tp with the
    phantom heads zeroed (as in the reference)."""
    D, dh = cfg.d_model, cfg.head_dim
    hp, kp = cfg.padded_heads(tp), cfg.padded_kv_heads(tp)
    wq = layers.init_dense(gen, D, hp * dh, dtype)
    wk = layers.init_dense(gen, D, kp * dh, dtype)
    wv = layers.init_dense(gen, D, kp * dh, dtype)
    wo = layers.init_dense(gen, hp * dh, D, dtype,
                           scale=1.0 / math.sqrt(max(1, cfg.n_heads) * dh))
    if hp > cfg.n_heads:
        wq[:, cfg.n_heads * dh:] = 0
        wo[cfg.n_heads * dh:, :] = 0
    if kp > cfg.n_kv_heads:
        wk[:, cfg.n_kv_heads * dh:] = 0
        wv[:, cfg.n_kv_heads * dh:] = 0
    p = {"wq": wq, "wk": wk, "wv": wv, "wo": wo}
    if cfg.qkv_bias:
        for name, width in (("bq", hp), ("bk", kp), ("bv", kp)):
            p[name] = torch.zeros((width * dh,), dtype=dtype, device=gen.device)
    return p


def _project_qkv(p, xq, xkv, cfg: ModelConfig, rt: Runtime):
    """q (B,Sq,H,dh) and k/v (B,Skv,K,dh)."""
    dh = cfg.head_dim
    q = xq @ p["wq"]
    k = xkv @ p["wk"]
    v = xkv @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    B, Sq, Skv = xq.shape[0], xq.shape[1], xkv.shape[1]
    q = q.reshape(B, Sq, -1, dh)
    k = k.reshape(B, Skv, -1, dh)
    v = v.reshape(B, Skv, -1, dh)
    return q, k, v


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    return k if n_rep == 1 else k.repeat_interleave(n_rep, dim=2)


def sdpa_reference(q, k, v, *, causal: bool, window: int | None,
                   q_offset: int = 0) -> torch.Tensor:
    """Plain scaled-dot-product attention (``kernels/ref.attention``).
    q: (B, Sq, H, dh); k/v: (B, Skv, K, dh); q_offset is the position of
    q[0]."""
    return kref.attention(q, k, v, causal=causal, window=window,
                          q_offset=q_offset)


def _attn_core(q, k, v, cfg: ModelConfig) -> torch.Tensor:
    """Causal attention of a prompt over itself (positions from 0)."""
    if q.shape[1] >= FLASH_MIN_Q:
        return kops.flash_attention(q, k, v, causal=True,
                                    window=cfg.sliding_window, q_offset=0)
    return sdpa_reference(q, k, v, causal=True, window=cfg.sliding_window)


def attention_prefill(p, x, cfg: ModelConfig, rt: Runtime, cache: KVCache):
    """Causal attention over the prompt; writes k/v into ``cache`` (a
    fresh zero cache, written in place) and returns (out, cache)."""
    x = copy_to_tp(x, rt.tp_group)
    q, k, v = _project_qkv(p, x, x, cfg, rt)
    B, S = x.shape[0], x.shape[1]
    pos = torch.arange(S, device=x.device)[None, :]
    q = layers.apply_rope(q, pos, cfg.rope_theta)
    k = layers.apply_rope(k, pos, cfg.rope_theta)
    out = _attn_core(q, k, v, cfg)
    W = cache.window
    if S >= W:   # keep the last W positions, rolled so slot == pos % W
        cache.k.copy_(torch.roll(k[:, S - W:], S % W, dims=1))
        cache.v.copy_(torch.roll(v[:, S - W:], S % W, dims=1))
    else:
        cache.k[:, :S] = k
        cache.v[:, :S] = v
    cache.length.fill_(S)
    out = out.reshape(B, S, -1) @ p["wo"]
    return reduce_from_tp(out, rt.tp_group), cache


def attention_decode(p, x, cfg: ModelConfig, rt: Runtime, cache: KVCache):
    """One-token decode step, x: (B, 1, D).  Writes slot length % W of
    ``cache`` (a ring for sliding-window caches) and advances its length,
    in place; the position stays on the device (no host sync)."""
    x = copy_to_tp(x, rt.tp_group)
    q, k, v = _project_qkv(p, x, x, cfg, rt)
    pos = cache.length.long()                 # () global position
    q = layers.apply_rope(q, pos.view(1, 1), cfg.rope_theta)
    k = layers.apply_rope(k, pos.view(1, 1), cfg.rope_theta)
    W = cache.window
    slot = torch.remainder(pos, W)
    cache.k.index_copy_(1, slot.view(1), k.to(cache.k.dtype))
    cache.v.index_copy_(1, slot.view(1), v.to(cache.v.dtype))
    # ring-aware mask: valid slots are the min(pos+1, W) most recent;
    # slot s holds the largest global position g <= pos with g % W == s
    n_valid = torch.clamp(pos + 1, max=W)
    kpos = torch.arange(W, device=x.device)
    gpos = torch.where(kpos <= slot, pos - slot + kpos, pos - slot + kpos - W)
    valid = gpos >= torch.clamp(pos + 1 - n_valid, min=0)
    if cfg.sliding_window is not None:
        valid &= gpos > pos - cfg.sliding_window
    rep = q.shape[2] // cache.k.shape[2]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          _repeat_kv(cache.k, rep).float())
    scores = scores / math.sqrt(cfg.head_dim)
    scores = torch.where(valid[None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, _repeat_kv(cache.v, rep).float())
    out = out.to(x.dtype)
    cache.length.add_(1)
    B = x.shape[0]
    out = out.reshape(B, 1, -1) @ p["wo"]
    return reduce_from_tp(out, rt.tp_group), cache


def make_cache(cfg: ModelConfig, n_layers: int, batch: int, tp: int,
               seq_len: int, dtype, device) -> KVCache:
    """An empty KV cache, stacked over layers: (L, B, W, kl, dh) for k and
    v and (L,) for the length, the layout the transfer moves."""
    kl = max(1, cfg.padded_kv_heads(tp) // max(1, tp))
    W = seq_len if cfg.sliding_window is None else min(cfg.sliding_window, seq_len)
    shape = (n_layers, batch, W, kl, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros((n_layers,), dtype=torch.int32, device=device))
