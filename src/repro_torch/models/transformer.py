"""Per-layer parameter init.  The dense decoder family is ported; the
other families (MoE, SSM, hybrid, encoder-decoder, VLM) come with their
slices."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
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
