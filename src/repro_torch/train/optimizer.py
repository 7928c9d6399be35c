"""AdamW with f32 moments (the JAX package's ``train/optimizer.py``):
the plain form, per parameter tensor, and the ZeRO-1 flat-shard form.

The port updates parameters and moments in place (the reference returns
new ones and donates the old).  In the plain form weight decay applies
to a parameter whose reference leaf has two or more dimensions; a
per-layer parameter stands for the reference's stacked (L, ...) leaf, so
its norm scales and biases decay too, as in the reference.  The ZeRO-1
form consumes the flat f32 gradient shard of
``collectives.tree_hier_psum_scatter`` and decays every element of the
f32 master, 1-D leaves too, as the reference's ``zero_update`` does.
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


def _step_consts(cfg: OptConfig, step: int) -> tuple[float, float, float]:
    """(lr, 1 - b1^t, 1 - b2^t) of update ``step``, t = step + 1, in f32."""
    t = np.float32(step + 1)
    return (lr_at(cfg, step), float(np.float32(1.0) - np.float32(cfg.b1) ** t),
            float(np.float32(1.0) - np.float32(cfg.b2) ** t))


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
    lr, c1, c2 = _step_consts(cfg, state.step)
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


# --- ZeRO-1 flat-shard form -------------------------------------------------

# values per pass of zero_update: its temporaries are this long, not as long
# as the shard (at qwen2.5-3b, 1.07 GB each against 12.34 GB)
ZERO_CHUNK = 1 << 28


@dataclasses.dataclass
class ZeroState:
    flat_param: torch.Tensor        # f32 master shard (padded_size / intra,)
    mu: torch.Tensor
    nu: torch.Tensor
    step: int = 0


def zero_init_from_flatparam(flat_shard: torch.Tensor) -> ZeroState:
    master = flat_shard.float()
    return ZeroState(master, torch.zeros_like(master), torch.zeros_like(master))


@torch.no_grad()
def zero_update(grad_shard: torch.Tensor, st: ZeroState, cfg: OptConfig,
                scale: torch.Tensor | float = 1.0) -> None:
    """Elementwise AdamW on the flat shard, in place and ``ZERO_CHUNK``
    values at a time (elementwise, so the bits do not depend on the
    chunking); ``scale`` pre-multiplies the gradients (clip / n_dp)."""
    lr, c1, c2 = _step_consts(cfg, st.step)
    b1, b2 = cfg.b1, cfg.b2
    for g, m, v, p in zip(*(x.split(ZERO_CHUNK) for x in
                            (grad_shard, st.mu, st.nu, st.flat_param))):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        step = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        step += cfg.weight_decay * p
        p.sub_(lr * step)
    st.step += 1
