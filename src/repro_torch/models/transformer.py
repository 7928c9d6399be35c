"""Per-layer init, the training layer and the layer stack.  The dense
decoder family is ported; the other families (MoE, SSM, hybrid,
encoder-decoder, VLM) come with their slices."""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.sharding import Runtime
from . import attention, layers


def init_layer(gen: torch.Generator, cfg: ModelConfig, tp: int, dtype) -> dict:
    """One decoder layer's params, the reference's pytree leaf for leaf."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet; only "
            f"'dense' is")
    return {
        "norm_attn": layers.init_norm(cfg.norm, cfg.d_model, dtype, gen.device),
        "attn": attention.init_attention(gen, cfg, tp, dtype),
        "norm_mlp": layers.init_norm(cfg.norm, cfg.d_model, dtype, gen.device),
        "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype),
    }


def apply_layer(p, x: torch.Tensor, cfg: ModelConfig, rt: Runtime, *,
                causal: bool = True) -> torch.Tensor:
    """One dense decoder layer for training, x: (B, S, D) -> (B, S, D).
    The dense family has no auxiliary loss; it comes with MoE."""
    h = layers.apply_norm(p["norm_attn"], x, cfg.norm)
    x = x + attention.attention_train(p["attn"], h, cfg, rt, causal=causal)
    h = layers.apply_norm(p["norm_mlp"], x, cfg.norm)
    return x + layers.apply_mlp(p["mlp"], h, rt)


def decoder_stack(stack, x: torch.Tensor, cfg: ModelConfig, rt: Runtime, *,
                  causal: bool = True) -> torch.Tensor:
    """The layers in order, each checkpointed (its activations are
    recomputed in the backward pass), as the reference checkpoints its
    scan body."""
    for lp in stack:
        fn = functools.partial(apply_layer, lp, cfg=cfg, rt=rt, causal=causal)
        x = checkpoint(fn, x, use_reentrant=False)
    return x
