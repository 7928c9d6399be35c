"""GQA attention: training, prefill (writes the KV cache) and decode.

Parameters, as in the JAX package, hold this rank's TP shard:
``wq (D, Hl*dh)``, ``wk/wv (D, Kl*dh)``, ``wo (Hl*dh, D)``, optional
``bq/bk/bv`` (never on a cross-attention block).  Q heads are padded to a
multiple of the TP size; when
there are fewer KV heads than TP ranks every rank holds all of them and
gathers, per local Q head, the one it uses (replicated-KV GQA), and the
cache keeps that gathered layout.  With ``cfg.qk_norm`` (chameleon) q and
k take the parameter-free per-head RMS norm before that gather.

Masks: causal (the decoders), optional sliding window, or none: the
whisper encoder's self-attention and every cross-attention, whose K/V
come from the encoder's output (``x_cross``) and take no RoPE; the
encoder's self-attention keeps RoPE, as in the reference.  A
cross-attention cache holds the encoder's K/V, written once by the
prefill and only read by decode.  Prefill attention (and the serving
encoder's) goes through the flash kernel (``kernels/ops.flash_attention``)
with a plain integer offset, causal or not, from ``FLASH_MIN_Q`` queries
on; short prompts and decode use plain PyTorch, as the reference does.

Training attention is plain PyTorch under autograd: the plain attention
below ``CHUNKED_ATTN_MIN_KV`` keys, the chunked online softmax (each kv
chunk checkpointed) from there on.  That is what the reference computes
in training: its ``attention_train`` passes a traced ``q_offset``, so its
kernel dispatch returns the plain attention (ROADMAP.md R4), and the JAX
package has no attention backward kernel.  The flash forward kernel is
never called in training.

Caches are updated in place: prefill writes a freshly allocated cache,
and decode writes one slot of the cache it is given (the reference's
decode step donates its cache, so no caller sees the old one either).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.parallel.sharding import Runtime, copy_to_tp, reduce_from_tp, tp_entry_group
from . import layers

NEG_INF = -1e30
FLASH_MIN_Q = 128     # prefill shorter than this takes sdpa_reference
CHUNKED_ATTN_MIN_KV = 2048


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


def init_attention(gen: torch.Generator, cfg: ModelConfig, tp: int, dtype,
                   cross: bool = False) -> dict:
    """Attention params; q heads padded to a multiple of tp with the
    phantom heads zeroed (as in the reference).  A ``cross`` block has no
    qkv bias."""
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
    if cfg.qkv_bias and not cross:
        for name, width in (("bq", hp), ("bk", kp), ("bv", kp)):
            p[name] = torch.zeros((width * dh,), dtype=dtype, device=gen.device)
    return p


def _kv_map_for_local_q(cfg: ModelConfig, rt: Runtime) -> torch.Tensor:
    """Replicated-KV path: the KV head each local Q head uses.  Global Q
    head h takes KV head h * K // Hp (phantom heads wrap to the last)."""
    tp = rt.tp
    hl, hp, K = cfg.local_q_heads(tp), cfg.padded_heads(tp), cfg.n_kv_heads
    qh = rt.tp_rank * hl + torch.arange(hl)
    return torch.clamp(qh * K // hp, 0, K - 1)


def _project_qkv(p, xq, xkv, cfg: ModelConfig, rt: Runtime):
    """q (B,Sq,Hl,dh) and k/v (B,Skv,Kl,dh), Hl % Kl == 0 after the
    replicated-KV gather."""
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
    if cfg.qk_norm:
        q, k = layers.rms_norm_head(q), layers.rms_norm_head(k)
    if rt.tp_group is not None and cfg.kv_replicated(rt.tp):
        kv_map = _kv_map_for_local_q(cfg, rt).to(k.device)
        k, v = k.index_select(2, kv_map), v.index_select(2, kv_map)
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


def _chunk_step(m, l, acc, kci, vci, *, ci: int, chunk: int, qf, qpos, Skv: int,
                causal: bool, window: int | None):
    """One kv chunk of the online softmax (the reference's scan body)."""
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kci.float())
    kpos = ci * chunk + torch.arange(chunk, device=qf.device)
    mask = kpos[None, :] < Skv
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    s = torch.where(mask[None, None], s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    safe = m_new > -1e29
    p = torch.exp(torch.where(safe[..., None], s - m_new[..., None], NEG_INF))
    alpha = torch.exp(torch.where(safe, m - m_new, 0.0))
    l_new = l * alpha + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vci.float())
    return m_new, l_new, acc_new


def chunked_attention(q, k, v, *, causal: bool, window: int | None,
                      q_offset: int = 0, chunk: int = 512) -> torch.Tensor:
    """Memory-efficient attention: an online-softmax loop over kv chunks,
    each checkpointed (the reference's ``lax.scan(jax.checkpoint(step))``),
    so the live set is (B, H, Sq, chunk) instead of (B, H, Sq, Skv).
    q: (B, Sq, H, dh); k/v: (B, Skv, K, dh) -> (B, Sq, H, dh)."""
    B, Sq, H, dh = q.shape
    Skv, K = k.shape[1], k.shape[2]
    k, v = _repeat_kv(k, H // K), _repeat_kv(v, H // K)
    pad = (-Skv) % chunk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    nck = (Skv + pad) // chunk
    kc = k.reshape(B, nck, chunk, H, dh)
    vc = v.reshape(B, nck, chunk, H, dh)
    qf = q.float() / math.sqrt(dh)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, dh), dtype=torch.float32, device=q.device)
    for ci in range(nck):
        step = functools.partial(_chunk_step, ci=ci, chunk=chunk, qf=qf, qpos=qpos,
                                 Skv=Skv, causal=causal, window=window)
        m, l, acc = checkpoint(step, m, l, acc, kc[:, ci], vc[:, ci],
                               use_reentrant=False)
    l = torch.where(l == 0, 1.0, l)
    out = (acc / l[..., None]).to(q.dtype)
    return out.transpose(1, 2)


def attention_train(p, x, cfg: ModelConfig, rt: Runtime, *,
                    causal: bool = True, x_cross: torch.Tensor | None = None,
                    reduce: bool = True) -> torch.Tensor:
    """Full-sequence attention for training and for the encoder, x: (B,
    S, D); ``x_cross`` (B, Skv, D) makes it cross-attention over those
    rows: no RoPE and no mask.  ``reduce=False`` returns the row-parallel
    partial sums.  Under ``torch.inference_mode`` (the serving encoder)
    the core is ``_attn_core``'s, the flash kernel's path, as the
    reference's serving runtime takes its kernel there."""
    x = copy_to_tp(x, tp_entry_group(rt))
    xkv = x if x_cross is None else copy_to_tp(x_cross, tp_entry_group(rt))
    q, k, v = _project_qkv(p, x, xkv, cfg, rt)
    B, S = x.shape[0], x.shape[1]
    if x_cross is None:
        pos = torch.arange(S, device=x.device)[None, :]
        q = layers.apply_rope(q, pos, cfg.rope_theta)
        k = layers.apply_rope(k, pos, cfg.rope_theta)
    causal = causal and x_cross is None
    if torch.is_inference_mode_enabled():
        out = _attn_core(q, k, v, cfg, causal)
    elif k.shape[1] >= CHUNKED_ATTN_MIN_KV:
        out = chunked_attention(q, k, v, causal=causal, window=cfg.sliding_window)
    else:
        out = sdpa_reference(q, k, v, causal=causal, window=cfg.sliding_window)
    out = out.reshape(B, S, -1) @ p["wo"]
    return reduce_from_tp(out, rt.tp_group) if reduce else out


def _attn_core(q, k, v, cfg: ModelConfig, causal: bool = True) -> torch.Tensor:
    """Attention of a prompt (positions from 0) over itself (``causal``)
    or over every key (the serving encoder, cross-attention), without
    autograd: the flash kernel from ``FLASH_MIN_Q`` queries on."""
    if q.shape[1] >= FLASH_MIN_Q:
        return kops.flash_attention(q, k, v, causal=causal,
                                    window=cfg.sliding_window, q_offset=0)
    return sdpa_reference(q, k, v, causal=causal, window=cfg.sliding_window)


def attention_prefill(p, x, cfg: ModelConfig, rt: Runtime, cache: KVCache,
                      x_cross: torch.Tensor | None = None):
    """Causal attention over the prompt; writes k/v into ``cache`` (a
    fresh zero cache, written in place) and returns (out, cache).  With
    ``x_cross`` (the encoder's output) it is cross-attention: no RoPE, no
    mask, and ``cache`` (``make_cache(cross=True)``) takes the encoder's
    K/V whole, its length the encoder's."""
    x = copy_to_tp(x, rt.tp_group)
    xkv = x if x_cross is None else copy_to_tp(x_cross, rt.tp_group)
    q, k, v = _project_qkv(p, x, xkv, cfg, rt)
    B, S = x.shape[0], x.shape[1]
    if x_cross is not None:
        out = _attn_core(q, k, v, cfg, causal=False)
        cache.k.copy_(k)
        cache.v.copy_(v)
        cache.length.fill_(k.shape[1])
        out = out.reshape(B, S, -1) @ p["wo"]
        return reduce_from_tp(out, rt.tp_group), cache
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


def attention_decode(p, x, cfg: ModelConfig, rt: Runtime, cache: KVCache,
                     cross: bool = False):
    """One-token decode step, x: (B, 1, D).  Writes slot length % W of
    ``cache`` (a ring for sliding-window caches) and advances its length,
    in place; the position stays on the device (no host sync).  A
    ``cross`` cache is read only: attention over all of the encoder's K/V,
    no RoPE, no mask."""
    x = copy_to_tp(x, rt.tp_group)
    q, k, v = _project_qkv(p, x, x, cfg, rt)
    B = x.shape[0]
    if cross:
        # the reference masks keys from cache.length on; a cross cache is
        # always full (its length is its window), so nothing is masked
        out = sdpa_reference(q, cache.k.to(q.dtype), cache.v.to(q.dtype), causal=False,
                             window=None)
        out = out.reshape(B, 1, -1) @ p["wo"]
        return reduce_from_tp(out, rt.tp_group), cache
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
    out = out.reshape(B, 1, -1) @ p["wo"]
    return reduce_from_tp(out, rt.tp_group), cache


def make_cache(cfg: ModelConfig, n_layers: int, batch: int, tp: int,
               seq_len: int, dtype, device, cross: bool = False,
               enc_seq: int = 0) -> KVCache:
    """An empty KV cache, stacked over layers: (L, B, W, kl, dh) for k and
    v and (L,) for the length, the layout the transfer moves.  kl is the
    local KV shard, or with replicated KV the local Q heads (the gathered
    layout).  W is ``seq_len`` (at most the window), or ``enc_seq`` for a
    ``cross`` cache."""
    if cfg.kv_replicated(tp):
        kl = cfg.local_q_heads(tp)
    else:
        kl = max(1, cfg.padded_kv_heads(tp) // max(1, tp))
    if cross:
        W = enc_seq
    else:
        W = seq_len if cfg.sliding_window is None else min(cfg.sliding_window, seq_len)
    shape = (n_layers, batch, W, kl, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros((n_layers,), dtype=torch.int32, device=device))
