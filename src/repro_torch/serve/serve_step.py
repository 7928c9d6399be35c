"""Serving: prefill / decode steps and the disaggregated KV transfer.

The paper's §6.2.2 scenario: prefill on one cluster, decode on another,
with the KV cache crossing between them through the HetCCL SendRecv
(``kv_transfer_body``: a shift over the pod group, optionally with int8
on the wire) instead of forwarding through the hosts.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from repro_torch.core import compression
from repro_torch.models.attention import KVCache
from repro_torch.models.model import Model
from repro_torch.parallel.sharding import Runtime, group_size
from repro_torch.train.loss import sharded_argmax


def make_serve_steps(model: Model):
    """Returns (prefill, decode):
    ``prefill(tokens (B, S)) -> (next token (B, 1), caches)`` and
    ``decode(token (B, 1), caches) -> (next token (B, 1), caches)``,
    decode updating ``caches`` in place.

    The prefill's cache is as long as the prompt: the reference's
    prefill step calls ``apply_prefill`` without ``max_len``, and the
    port keeps that, so each decode step writes ring slot
    ``pos % S`` over the oldest prompt token."""
    rt, vocab = model.rt, model.cfg.vocab_size

    def prefill(tokens):
        logits, caches = model.apply_prefill(tokens)
        return sharded_argmax(logits, rt, vocab), caches

    def decode(token, caches):
        logits, caches = model.apply_decode(token, caches)
        return sharded_argmax(logits, rt, vocab), caches

    return prefill, decode


def _shift(tensors: list[torch.Tensor], group, shift: int) -> list[torch.Tensor]:
    """Send each tensor to pod rank (r + shift) % n and receive the same
    shapes from (r - shift) % n, in one ``batch_isend_irecv``.  With a
    group of one, or a shift that is a multiple of n, the permutation is
    the identity and the tensors come back as they are."""
    n = group_size(group)
    if shift % n == 0:
        return tensors
    r = dist.get_rank(group)
    dst = dist.get_global_rank(group, (r + shift) % n)
    src = dist.get_global_rank(group, (r - shift) % n)
    received = [torch.empty_like(t) for t in tensors]
    ops = ([dist.P2POp(dist.isend, t.contiguous(), dst, group) for t in tensors]
           + [dist.P2POp(dist.irecv, t, src, group) for t in received])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return received


@torch.inference_mode()
def kv_transfer_body(caches: KVCache, rt: Runtime, compress: str | None = None,
                     shift: int = 1) -> KVCache:
    """Move every cache leaf from pod i to pod (i + shift).  With
    ``compress="int8"`` a bf16 or f32 leaf of at least 1024 elements
    crosses as int8 blocks plus f32 scales (the codec kernels run even
    when the permutation is the identity); other leaves travel raw.
    Always returns new tensors."""
    def move(leaf: torch.Tensor) -> torch.Tensor:
        if compress == "int8" and leaf.dtype in (torch.bfloat16, torch.float32) \
                and leaf.numel() >= compression.BLOCK:
            q, s = compression.quantize_int8(leaf)
            q2, s2 = _shift([q, s], rt.pod_group, shift)
            out = compression.dequantize_int8(q2, s2, leaf.numel(), leaf.dtype)
            return out.reshape(leaf.shape)
        (out,) = _shift([leaf], rt.pod_group, shift)
        return out.clone() if out is leaf else out

    if compress not in (None, "int8"):
        raise ValueError(f"unknown KV codec {compress!r}")
    return KVCache(*(move(leaf) for leaf in caches))


def make_kv_transfer(model: Model, compress: str | None = None, shift: int = 1):
    """``transfer(caches) -> moved caches`` over ``model.rt.pod_group``."""
    return functools.partial(kv_transfer_body, rt=model.rt, compress=compress,
                             shift=shift)
