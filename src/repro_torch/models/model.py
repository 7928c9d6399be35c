"""Top-level model: init, training forward, caches, prefill and decode.

``Model`` is an ``nn.Module`` whose parameters mirror the JAX package's
param pytree: ``embed``, ``layers`` (one ``ModuleDict`` per layer where
the reference stacks a leading (L, ...) axis), ``final_norm`` and, when
embeddings are not tied, ``lm_head``.  ``init(seed)`` draws them from a
``torch.Generator`` on the model's device; ``convert.params_from_jax``
loads the reference's arrays instead.  Caches are stacked per leaf, as
in the reference, so the transfer cuts the same int8 blocks: a
``KVCache`` of (L, B, W, kl, dh) k and v for the dense family, an
``SSMState`` of (L, B, W-1, ch) conv and (L, B, h, p, n) ssm leaves for
the SSM family, each with an (L,) length.

FSDP (``with_fsdp(n)``, before ``init`` or ``set_params``): the layer
parameters are sharded over ``rt.fsdp_group`` by the reference's rules
(``param_specs``, from the global stacked (L, ...) shapes), each rank
keeping its slice of every layer tensor along the chosen dim, and each
layer gathers them before it runs (``fsdp_dims``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.sharding import Runtime, fsdp_dim, fsdp_gather, group_size
from . import attention, layers, ssm, transformer


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; a CUDA device without a card
    raises instead of running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this runs on the GPU unless the "
                           "caller passes device='cpu'")
    return device


# ---------------------------------------------------------------------------
# Sharding rules (the reference's, a leaf named by its path of dict keys)
# ---------------------------------------------------------------------------

_COL = {"wq", "w_gate", "w_up", "w_z", "w_x", "w_dt", "w1", "bq", "b1",
        "dt_bias", "A_log", "D_skip", "norm_scale"}
_ROW = {"wo", "w_down", "w_out", "w2"}
_KV = {"wk", "wv", "bk", "bv"}
_VOCAB = {"embed", "lm_head"}
_CONV_X = {"conv_w_x", "conv_b_x"}  # sharded with the ssm inner dim (dim 0)


def _tp_dim(path: tuple, shape, cfg: ModelConfig, tp: int, stacked: bool) -> int | None:
    """Dim index (into the given shape) sharded over the model axis."""
    name = path[-1]
    off = 1 if stacked else 0
    nd = len(shape)
    if "moe" in path and name in ("w_gate", "w_up", "w_down"):
        raise NotImplementedError("MoE sharding is not ported yet (the MoE slice)")
    if name in _KV:
        if cfg.kv_replicated(tp):
            return None
        return nd - 1
    if name in _CONV_X:
        return off  # (di, width) / (di,): shard the channel dim
    if name in _COL:
        return nd - 1
    if name in _ROW:
        return off
    if name in _VOCAB:
        return off  # handled unstacked (vocab dim 0)
    return None


def _spec_for(path: tuple, shape, cfg: ModelConfig, tp: int, fsdp: int,
              stacked: bool) -> tuple:
    """The reference's PartitionSpec of a leaf, as a tuple of None,
    "model" and "data" per dim."""
    tp_d = None if "ssm" in path and path[-1] == "w_bc" else _tp_dim(path, shape, cfg,
                                                                      tp, stacked)
    spec: list = [None] * len(shape)
    if tp_d is not None and tp > 1:
        spec[tp_d] = "model"
    # FSDP on a remaining dim
    if fsdp > 1:
        taken = tuple(d for d in range(len(shape))
                      if spec[d] is not None or (stacked and d == 0))
        shard_shape = tuple(
            s // tp if (tp_d is not None and tp > 1 and d == tp_d) else s
            for d, s in enumerate(shape))
        fd = fsdp_dim(shard_shape, fsdp, taken)
        if fd is not None:
            spec[fd] = "data"
    return tuple(spec)


def param_specs(params: dict, cfg: ModelConfig, tp: int = 1, fsdp: int = 1) -> dict:
    """The reference's ``Model.param_specs`` of a global param tree
    (``layers`` a list of per-layer dicts), by leaf path, in
    ``Model.train_leaves`` order: one tuple of None, "model" or "data" per
    dim of the leaf, a layer leaf stacked (L, ...).  FSDP only applies to
    layer leaves (gathered inside the layer); top-level leaves stay
    replicated."""
    specs = {}
    for key in sorted(params):
        if key == "layers":
            n = len(params["layers"])
            for path, t in _paths(params["layers"][0], ("layers",)):
                specs[path] = _spec_for(path, (n,) + tuple(t.shape), cfg, tp, fsdp, True)
        elif isinstance(params[key], torch.Tensor):
            specs[(key,)] = _spec_for((key,), tuple(params[key].shape), cfg, tp, 1, False)
        else:
            for path, t in _paths(params[key], (key,)):
                specs[path] = _spec_for(path, tuple(t.shape), cfg, tp, 1, False)
    return specs


def _paths(tree, prefix: tuple = ()):
    """(path, tensor) of every tensor of a nested dict, keys sorted."""
    for key in sorted(tree):
        v = tree[key]
        if isinstance(v, torch.Tensor):
            yield prefix + (key,), v
        else:
            yield from _paths(v, prefix + (key,))


def _nested(flat: dict) -> dict:
    """{path: value} -> the nested dict it flattens."""
    out: dict = {}
    for path, v in flat.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = v
    return out


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
        if cfg.family not in transformer.PORTED_FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} ({cfg.name}) is not ported yet")
        self.cfg = cfg
        self.rt = rt if rt is not None else Runtime()
        self.tp = group_size(self.rt.tp_group)
        self.fsdp = 1
        self.init_device = resolve_device(device)

    def with_fsdp(self, fsdp_size: int) -> "Model":
        """Shard the layer parameters ``fsdp_size`` ways over
        ``rt.fsdp_group`` (no group: no sharding, as in the reference)."""
        self.fsdp = fsdp_size if self.rt.fsdp_group is not None else 1
        return self

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
        per-layer trees) as the model's parameters.  With FSDP the layer
        tensors are the global ones: each rank keeps its slice."""
        self._specs = param_specs(params, self.cfg, self.tp, self.fsdp)
        # the local gather dim of each layer leaf (its leading L consumed)
        dims = {path[1:]: spec.index("data") - 1 if "data" in spec else -1
                for path, spec in self._specs.items() if path[0] == "layers"}
        self._fdims = _nested(dims)
        layer_trees = params["layers"]
        if self.fsdp > 1:
            rank = dist.get_rank(self.rt.fsdp_group)
            layer_trees = [_nested({path: t if dims[path] < 0 else
                                    t.chunk(self.fsdp, dims[path])[rank].clone()
                                    for path, t in _paths(lp)})
                           for lp in layer_trees]
        self.embed = nn.Parameter(params["embed"], requires_grad=False)
        self.layers = nn.ModuleList(_to_module(lp) for lp in layer_trees)
        self.final_norm = _to_module(params["final_norm"])
        if "lm_head" in params:
            self.lm_head = nn.Parameter(params["lm_head"], requires_grad=False)
        return self

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _head(self) -> torch.Tensor:
        return self.embed if self.cfg.tie_embeddings else self.lm_head

    def param_tree(self) -> dict:
        """The parameters as the reference's param dict, keys sorted:
        ``layers`` is the list of per-layer dicts (this rank's shards
        under FSDP)."""
        def tree(m):
            return {k: v if isinstance(v, torch.Tensor) else tree(v) for k, v in m.items()}

        top = {"embed": self.embed, "final_norm": tree(self.final_norm),
               "layers": [tree(lp) for lp in self.layers]}
        if not self.cfg.tie_embeddings:
            top["lm_head"] = self.lm_head
        return dict(sorted(top.items()))

    def param_specs(self) -> dict[tuple, tuple]:
        """``param_specs`` of the global parameters this model was given."""
        return self._specs

    def fsdp_dims(self) -> dict:
        """Each layer leaf's local gather dim (-1: replicated), nested as
        one layer's param dict."""
        return self._fdims

    def _gathered(self, lp):
        """One layer's parameters, FSDP shards gathered."""
        return fsdp_gather(lp, self.fsdp_dims(), self.rt.fsdp_group) if self.fsdp > 1 else lp

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
        x = transformer.decoder_stack(self.layers, x, cfg, rt,
                                      self.fsdp_dims() if self.fsdp > 1 else None)
        x = layers.apply_norm(self.final_norm, x, cfg.norm)
        return layers.lm_head_logits(x, self._head(), rt)

    # --------------------------------------------------------- serving --

    def make_caches(self, batch: int, seq_len: int):
        """Empty caches stacked over layers: a ``KVCache`` of ``seq_len``
        slots, or for the SSM family an ``SSMState`` (no length to size)."""
        cfg = self.cfg
        if cfg.family == "ssm":
            return ssm.make_ssm_state(cfg, cfg.n_layers, batch, self.tp, self.device)
        return attention.make_cache(cfg, cfg.n_layers, batch, self.tp, seq_len,
                                    cfg.dtype, self.device)

    def _layer_prefill(self, lp, x: torch.Tensor, cache) -> torch.Tensor:
        """One layer over the prompt; writes the layer's cache views."""
        cfg, rt = self.cfg, self.rt
        lp = self._gathered(lp)
        if cfg.family == "ssm":
            h = layers.apply_norm(lp["norm_ssm"], x, cfg.norm)
            out, st = ssm.apply_ssm(lp["ssm"], h, cfg, rt)
            for dst, src in zip(cache, st):
                dst.copy_(src)
            return x + out
        h = layers.apply_norm(lp["norm_attn"], x, cfg.norm)
        a, _ = attention.attention_prefill(lp["attn"], h, cfg, rt, cache)
        x = x + a
        h = layers.apply_norm(lp["norm_mlp"], x, cfg.norm)
        return x + layers.apply_mlp(lp["mlp"], h, rt)

    def _layer_decode(self, lp, x: torch.Tensor, cache) -> torch.Tensor:
        """One layer, one token; updates the layer's cache views in place."""
        cfg, rt = self.cfg, self.rt
        lp = self._gathered(lp)
        if cfg.family == "ssm":
            h = layers.apply_norm(lp["norm_ssm"], x, cfg.norm)
            out, _ = ssm.apply_ssm_decode(lp["ssm"], h, cfg, rt, cache)
            return x + out
        h = layers.apply_norm(lp["norm_attn"], x, cfg.norm)
        a, _ = attention.attention_decode(lp["attn"], h, cfg, rt, cache)
        x = x + a
        h = layers.apply_norm(lp["norm_mlp"], x, cfg.norm)
        return x + layers.apply_mlp(lp["mlp"], h, rt)

    @torch.inference_mode()
    def apply_prefill(self, tokens: torch.Tensor, max_len: int | None = None):
        """tokens (B, S) -> (last-token logits (B, 1, V) f32, caches).
        ``max_len`` sizes the KV cache (>= S) to leave decode headroom."""
        cfg, rt = self.cfg, self.rt
        B, S = tokens.shape
        caches = self.make_caches(B, max_len or S)
        x = layers.embed_lookup(self.embed, tokens, rt)
        for i, lp in enumerate(self.layers):
            x = self._layer_prefill(lp, x, caches.layer(i))
        x = layers.apply_norm(self.final_norm, x[:, -1:], cfg.norm)
        return layers.lm_head_logits(x, self._head(), rt), caches

    @torch.inference_mode()
    def apply_decode(self, token: torch.Tensor, caches):
        """One decode step, token (B, 1) -> (logits (B, 1, V) f32, caches);
        ``caches`` is updated in place and returned."""
        cfg, rt = self.cfg, self.rt
        x = layers.embed_lookup(self.embed, token, rt)
        for i, lp in enumerate(self.layers):
            x = self._layer_decode(lp, x, caches.layer(i))
        x = layers.apply_norm(self.final_norm, x, cfg.norm)
        return layers.lm_head_logits(x, self._head(), rt), caches
