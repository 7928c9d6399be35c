"""Serving: prefill / decode steps and the disaggregated KV transfer.

The paper's §6.2.2 scenario: prefill on one cluster, decode on another,
with the cache crossing between them through the HetCCL SendRecv
(``kv_transfer_body``: a shift over the pod group, optionally with int8
on the wire) instead of forwarding through the hosts.  The cache is a
``KVCache`` (dense family) or an ``SSMState`` (Mamba2); the transfer
moves every leaf of either.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import compression, primitives
from repro_torch.models.model import Model
from repro_torch.parallel.sharding import Runtime
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


@torch.inference_mode()
def kv_transfer_body(caches, rt: Runtime, compress: str | None = None,
                     shift: int = 1):
    """Move every leaf of ``caches`` (a NamedTuple of tensors) from pod i
    to pod (i + shift), returned as the same NamedTuple type.  With
    ``compress="int8"`` a bf16 or f32 leaf of at least 1024 elements
    crosses as int8 blocks plus f32 scales (the codec kernels run even
    when the permutation is the identity); other leaves travel raw.
    Always returns new tensors."""
    def move(leaf: torch.Tensor) -> torch.Tensor:
        if compress == "int8" and leaf.dtype in (torch.bfloat16, torch.float32) \
                and leaf.numel() >= compression.BLOCK:
            q, s = compression.quantize_int8(leaf)
            q2, s2 = primitives.shift([q, s], rt.pod_group, shift)
            out = compression.dequantize_int8(q2, s2, leaf.numel(), leaf.dtype)
            return out.reshape(leaf.shape)
        (out,) = primitives.shift([leaf], rt.pod_group, shift)
        return out.clone() if out is leaf else out

    if compress not in (None, "int8"):
        raise ValueError(f"unknown KV codec {compress!r}")
    return type(caches)(*(move(leaf) for leaf in caches))


def make_kv_transfer(model: Model, compress: str | None = None, shift: int = 1):
    """``transfer(caches) -> moved caches`` over ``model.rt.pod_group``."""
    return functools.partial(kv_transfer_body, rt=model.rt, compress=compress,
                             shift=shift)
