"""Architecture registry: --arch <id> resolution for every entry point."""

from __future__ import annotations

from . import (chameleon_34b, hymba_1_5b, internlm2_20b, mamba2_2_7b,
               mixtral_8x7b, olmo_1b, qwen1_5_4b, qwen2_5_3b,
               qwen3_moe_30b_a3b, whisper_tiny)
from .base import SHAPES, ModelConfig, ShapeConfig

_MODULES = {
    "qwen2.5-3b": qwen2_5_3b,
    "olmo-1b": olmo_1b,
    "internlm2-20b": internlm2_20b,
    "qwen1.5-4b": qwen1_5_4b,
    "chameleon-34b": chameleon_34b,
    "hymba-1.5b": hymba_1_5b,
    "mixtral-8x7b": mixtral_8x7b,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b,
    "whisper-tiny": whisper_tiny,
    "mamba2-2.7b": mamba2_2_7b,
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_NAMES}")
    mod = _MODULES[name]
    return mod.smoke() if smoke else mod.full()


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def cell_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether an (arch x shape) cell runs, per the assignment rules."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, "long_500k needs sub-quadratic attention (skip: full attn)"
    return True, ""
