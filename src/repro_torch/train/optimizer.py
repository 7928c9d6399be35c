"""AdamW with f32 moments (the JAX package's ``train/optimizer.py``,
plain form).

The port updates parameters and moments in place (the reference returns
new ones and donates the old).  Weight decay applies to a parameter
whose reference leaf has two or more dimensions; a per-layer parameter
stands for the reference's stacked (L, ...) leaf, so its norm scales and
biases decay too, as in the reference.  ZeRO-1 waits for its slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def lr_at(cfg: OptConfig, step: int) -> float:
    """Linear warm-up, computed in f32 as the reference does."""
    warm = np.minimum(np.float32(1.0), np.float32(step + 1) / np.float32(cfg.warmup_steps))
    return float(np.float32(cfg.lr) * warm)


@dataclasses.dataclass
class AdamState:
    mu: list[torch.Tensor]          # f32, one per parameter tensor
    nu: list[torch.Tensor]
    step: int = 0


def flat_params(leaves) -> tuple[list[torch.Tensor], list[bool]]:
    """Parameter tensors of ``Model.train_leaves()`` in order, and whether
    each decays (its reference leaf has ndim >= 2)."""
    tensors, decay = [], []
    for leaf in leaves:
        parts = list(leaf) if isinstance(leaf, (list, tuple)) else [leaf]
        ndim = parts[0].ndim + (1 if isinstance(leaf, (list, tuple)) else 0)
        tensors.extend(parts)
        decay.extend([ndim >= 2] * len(parts))
    return tensors, decay


def adam_init(params: list[torch.Tensor]) -> AdamState:
    return AdamState([torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                      for p in params],
                     [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                      for p in params])


@torch.no_grad()
def adam_update(grads: list[torch.Tensor], state: AdamState,
                params: list[torch.Tensor], decay: list[bool], cfg: OptConfig,
                scale: torch.Tensor | float = 1.0) -> None:
    """Elementwise AdamW, in place; ``scale`` pre-multiplies the grads
    (clip / n_dp)."""
    t = np.float32(state.step + 1)
    lr = lr_at(cfg, state.step)
    c1 = float(np.float32(1.0) - np.float32(cfg.b1) ** t)
    c2 = float(np.float32(1.0) - np.float32(cfg.b2) ** t)
    b1, b2 = cfg.b1, cfg.b2
    for g, m, v, p, dec in zip(grads, state.mu, state.nu, params, decay):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        step = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        if dec:
            step += cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * step)
    state.step += 1
