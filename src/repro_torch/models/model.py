"""Top-level model: init, training forward, caches, prefill and decode.

``Model`` is an ``nn.Module`` whose parameters mirror the JAX package's
param pytree: ``embed``, ``layers`` (one ``ModuleDict`` per layer where
the reference stacks a leading (L, ...) axis), ``final_norm`` and, when
embeddings are not tied, ``lm_head``.  ``init(seed)`` draws them from a
``torch.Generator`` on the model's device; ``convert.params_from_jax``
loads the reference's arrays instead.  Caches are stacked per leaf,
(L, B, W, kl, dh) for k and v and (L,) for the length, as in the
reference, so the KV transfer moves the same blocks.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.sharding import Runtime, group_size
from . import attention, layers, transformer


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; a CUDA device without a card
    raises instead of running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this runs on the GPU unless the "
                           "caller passes device='cpu'")
    return device


def _to_module(tree: dict) -> nn.Module:
    """Nested dict of tensors -> ModuleDict / ParameterDict (frozen)."""
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                                 for k, v in tree.items()})
    return nn.ModuleDict({k: _to_module(v) for k, v in tree.items()})


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, rt: Runtime | None = None,
                 device="cuda"):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} ({cfg.name}) is not ported yet")
        self.cfg = cfg
        self.rt = rt if rt is not None else Runtime()
        self.tp = group_size(self.rt.tp_group)
        self.init_device = resolve_device(device)

    # ------------------------------------------------------------- init --

    def init(self, seed: int = 0) -> "Model":
        cfg, tp, dtype = self.cfg, self.tp, self.cfg.dtype
        gen = torch.Generator(device=self.init_device)
        gen.manual_seed(seed)
        params = {"embed": layers.init_embedding(gen, cfg.padded_vocab(tp),
                                                 cfg.d_model, dtype),
                  "layers": [transformer.init_layer(gen, cfg, tp, dtype)
                             for _ in range(cfg.n_layers)],
                  "final_norm": layers.init_norm(cfg.norm, cfg.d_model, dtype,
                                                 self.init_device)}
        if not cfg.tie_embeddings:
            params["lm_head"] = layers.init_embedding(
                gen, cfg.padded_vocab(tp), cfg.d_model, dtype)
        return self.set_params(params)

    def set_params(self, params: dict) -> "Model":
        """Take a param tree (dicts of tensors, ``layers`` a list of
        per-layer trees) as the model's parameters."""
        self.embed = nn.Parameter(params["embed"], requires_grad=False)
        self.layers = nn.ModuleList(_to_module(lp) for lp in params["layers"])
        self.final_norm = _to_module(params["final_norm"])
        if "lm_head" in params:
            self.lm_head = nn.Parameter(params["lm_head"], requires_grad=False)
        return self

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _head(self) -> torch.Tensor:
        return self.embed if self.cfg.tie_embeddings else self.lm_head

    # -------------------------------------------------------- training --

    def train_leaves(self) -> list:
        """The parameters in the order of the reference's flattened param
        pytree (dict keys sorted): each leaf a tensor, or, for a per-layer
        parameter, the list of its L layer tensors (the reference's
        stacked (L, ...) leaf).  Gradient sync and Adam walk this order."""
        def walk(tree):
            for key in sorted(tree.keys()):
                v = tree[key]
                if isinstance(v, torch.Tensor):
                    yield v
                else:
                    yield from walk(v)

        top = {"embed": self.embed, "final_norm": self.final_norm, "layers": None}
        if not self.cfg.tie_embeddings:
            top["lm_head"] = self.lm_head
        leaves: list = []
        for key in sorted(top):
            if key == "layers":
                per_layer = [list(walk(lp)) for lp in self.layers]
                leaves.extend(list(ts) for ts in zip(*per_layer))
            elif isinstance(top[key], torch.Tensor):
                leaves.append(top[key])
            else:
                leaves.extend(walk(top[key]))
        return leaves

    def apply_train(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S, V) f32, differentiable in the
        parameters."""
        cfg, rt = self.cfg, self.rt
        x = layers.embed_lookup(self.embed, tokens, rt)
        x = transformer.decoder_stack(self.layers, x, cfg, rt)
        x = layers.apply_norm(self.final_norm, x, cfg.norm)
        return layers.lm_head_logits(x, self._head(), rt)

    # --------------------------------------------------------- serving --

    def make_caches(self, batch: int, seq_len: int) -> attention.KVCache:
        return attention.make_cache(self.cfg, self.cfg.n_layers, batch,
                                    self.tp, seq_len, self.cfg.dtype, self.device)

    @torch.inference_mode()
    def apply_prefill(self, tokens: torch.Tensor, max_len: int | None = None):
        """tokens (B, S) -> (last-token logits (B, 1, V) f32, caches).
        ``max_len`` sizes the KV cache (>= S) to leave decode headroom."""
        cfg, rt = self.cfg, self.rt
        B, S = tokens.shape
        caches = self.make_caches(B, max_len or S)
        x = layers.embed_lookup(self.embed, tokens, rt)
        for i, lp in enumerate(self.layers):
            h = layers.apply_norm(lp["norm_attn"], x, cfg.norm)
            a, _ = attention.attention_prefill(lp["attn"], h, cfg, rt,
                                               caches.layer(i))
            x = x + a
            h = layers.apply_norm(lp["norm_mlp"], x, cfg.norm)
            x = x + layers.apply_mlp(lp["mlp"], h, rt)
        x = layers.apply_norm(self.final_norm, x[:, -1:], cfg.norm)
        return layers.lm_head_logits(x, self._head(), rt), caches

    @torch.inference_mode()
    def apply_decode(self, token: torch.Tensor, caches: attention.KVCache):
        """One decode step, token (B, 1) -> (logits (B, 1, V) f32, caches);
        ``caches`` is updated in place and returned."""
        cfg, rt = self.cfg, self.rt
        x = layers.embed_lookup(self.embed, token, rt)
        for i, lp in enumerate(self.layers):
            h = layers.apply_norm(lp["norm_attn"], x, cfg.norm)
            a, _ = attention.attention_decode(lp["attn"], h, cfg, rt,
                                              caches.layer(i))
            x = x + a
            h = layers.apply_norm(lp["norm_mlp"], x, cfg.norm)
            x = x + layers.apply_mlp(lp["mlp"], h, rt)
        x = layers.apply_norm(self.final_norm, x, cfg.norm)
        return layers.lm_head_logits(x, self._head(), rt), caches
