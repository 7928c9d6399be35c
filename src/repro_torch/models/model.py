"""Top-level model: init, training forward, caches, prefill and decode.

``Model`` is an ``nn.Module`` whose parameters mirror the JAX package's
param pytree: ``embed``, ``layers`` (one ``ModuleDict`` per layer where
the reference stacks a leading (L, ...) axis), ``final_norm`` and, when
embeddings are not tied, ``lm_head``; an encoder-decoder model adds
``enc_layers`` (stacked as ``layers`` are), ``enc_norm`` and the learned
decoder positions ``pos_emb`` (max_seq, d_model).  ``init(seed)`` draws them from a
``torch.Generator`` on the model's device; ``convert.params_from_jax``
loads the reference's arrays instead.  Caches are stacked per leaf, as
in the reference, so the transfer cuts the same int8 blocks: a
``KVCache`` of (L, B, W, kl, dh) k and v for the dense and MoE families, an
``SSMState`` of (L, B, W-1, ch) conv and (L, B, h, p, n) ssm leaves for
the SSM family, each with an (L,) length, for the hybrid family a
``HybridCache`` of both (the reference's (kv, ssm) pair), and for the
encoder-decoder family an ``EncDecCache`` of the decoder's self-attention
``KVCache`` and its cross-attention ``KVCache`` of the encoder's K/V.

Tensor parallelism (``rt.tp_group``): each rank keeps its slice of every
global parameter along the dim the reference's rules (``param_specs``)
shard over "model", and caches hold the local heads.  FSDP
(``with_fsdp(n)``, before ``init`` or ``set_params``): the layer
parameters are also sharded over ``rt.fsdp_group`` along the dim the
rules give "data" (never the TP dim or the stacked-layer dim), and each
layer gathers them before it runs (``fsdp_dims``).  Under sequence
parallelism (``rt.sp``) the decoder stack runs on this rank's shard of
the sequence.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.sharding import Runtime, fsdp_dim, fsdp_gather, gather_sp
from . import attention, layers, moe, ssm, transformer


class HybridCache(NamedTuple):
    """A hybrid model's cache: its attention's ``KVCache`` and its SSM's
    ``SSMState``, each stacked over layers."""
    kv: attention.KVCache
    ssm: ssm.SSMState

    def layer(self, i: int) -> "HybridCache":
        """Views of layer ``i`` of both parts."""
        return HybridCache(self.kv.layer(i), self.ssm.layer(i))


class EncDecCache(NamedTuple):
    """An encoder-decoder model's cache: the self-attention ``KVCache``
    and the cross-attention ``KVCache`` (the encoder's K/V, window and
    length ``enc_seq``), each stacked over the decoder layers."""
    kv: attention.KVCache
    cross: attention.KVCache

    def layer(self, i: int) -> "EncDecCache":
        """Views of layer ``i`` of both parts."""
        return EncDecCache(self.kv.layer(i), self.cross.layer(i))


# the stacked per-layer subtrees of the param tree
STACKED = ("enc_layers", "layers")


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
        if moe.strategy(cfg, tp) == "ep":
            if cfg.n_experts % tp:
                # fail here, not deep inside the layer
                raise ValueError(
                    f"MoE expert parallelism needs the tensor-parallel "
                    f"size to divide the expert count: "
                    f"n_experts={cfg.n_experts} % tp={tp} = "
                    f"{cfg.n_experts % tp}; pick a tp that divides "
                    f"{cfg.n_experts} or drop below n_experts to select "
                    f"the etp strategy")
            return off  # shard the expert dim
        # etp: shard d_ff (the last dim of gate and up, the middle of down)
        return nd - 1 if name in ("w_gate", "w_up") else off + 1
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
        if key in STACKED:
            n = len(params[key])
            for path, t in _paths(params[key][0], (key,)):
                specs[path] = _spec_for(path, (n,) + tuple(t.shape), cfg, tp, fsdp, True)
        elif isinstance(params[key], torch.Tensor):
            specs[(key,)] = _spec_for((key,), tuple(params[key].shape), cfg, tp, 1, False)
        else:
            for path, t in _paths(params[key], (key,)):
                specs[path] = _spec_for(path, tuple(t.shape), cfg, tp, 1, False)
    return specs


def pad_vocab(params: dict, cfg: ModelConfig, tp: int) -> dict:
    """A global param tree with the TP-1 vocabulary padded to TP ``tp``'s:
    the embedding (and the LM head) gain zero rows up to
    ``padded_vocab(tp)``, which every logit masks and no id looks up.  The
    layer leaves are left as they are: a tree whose heads pad at ``tp``
    must already hold them at ``tp``'s padded shapes."""
    rows = cfg.padded_vocab(tp)
    return {k: torch.nn.functional.pad(v, (0, 0, 0, rows - v.shape[0]))
            if k in _VOCAB and v.shape[0] < rows else v for k, v in params.items()}


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
        self.cfg = cfg
        self.rt = rt if rt is not None else Runtime()
        self.tp = self.rt.tp
        transformer.check_ported(cfg, self.tp)
        self.fsdp = 1
        self.init_device = resolve_device(device)

    def with_fsdp(self, fsdp_size: int) -> "Model":
        """Shard the layer parameters ``fsdp_size`` ways over
        ``rt.fsdp_group`` (no group: no sharding, as in the reference)."""
        self.fsdp = fsdp_size if self.rt.fsdp_group is not None else 1
        return self

    # ------------------------------------------------------------- init --

    def init(self, seed: int = 0) -> "Model":
        """Draw the global parameters from ``seed`` (``draw``) and keep
        this rank's shards."""
        return self.set_params(self.draw(seed))

    def draw(self, seed: int = 0) -> dict:
        """The global param tree of ``seed`` at this TP size.  The
        vocabulary is drawn at its TP-1 padding and padded with zero rows
        to this TP size's (``pad_vocab``), so where the heads do not pad a
        seed gives the same function at every TP size.  Where they pad
        (``cfg.padded_heads(tp)``), the layers are drawn at the padded
        shapes, as the reference draws them: the phantom columns of ``wq``
        and rows of ``wo`` are zero, phantom KV heads (sharded KV) are
        zero, and replicated KV is drawn at its true count; the draws
        after the first padded leaf then differ from the TP-1 tree's.
        Each leaf is drawn on the model's device in f32 and cast at once,
        so the tree is held once, in ``cfg.dtype``, plus one leaf's f32
        draw (chameleon-34b: 68.59 GB of bf16 leaves)."""
        cfg, tp, dtype = self.cfg, self.tp, self.cfg.dtype
        gen = torch.Generator(device=self.init_device)
        gen.manual_seed(seed)
        cross = cfg.n_enc_layers > 0
        params = {"embed": layers.init_embedding(gen, cfg.padded_vocab(1),
                                                 cfg.d_model, dtype),
                  "layers": [transformer.init_layer(gen, cfg, tp, dtype, cross=cross)
                             for _ in range(cfg.n_layers)],
                  "final_norm": layers.init_norm(cfg.norm, cfg.d_model, dtype,
                                                 self.init_device)}
        if cross:
            params["enc_layers"] = [transformer.init_encoder_layer(gen, cfg, tp, dtype)
                                    for _ in range(cfg.n_enc_layers)]
            params["enc_norm"] = layers.init_norm(cfg.norm, cfg.d_model, dtype,
                                                  self.init_device)
            params["pos_emb"] = (torch.randn((cfg.max_seq, cfg.d_model), generator=gen,
                                             dtype=torch.float32, device=self.init_device)
                                 * 0.01).to(dtype)
        if not cfg.tie_embeddings:
            params["lm_head"] = layers.init_embedding(
                gen, cfg.padded_vocab(1), cfg.d_model, dtype)
        return pad_vocab(params, cfg, tp)

    def set_params(self, params: dict) -> "Model":
        """Take a global param tree (dicts of tensors, ``layers`` a list of
        per-layer trees, shaped for this TP size) as the model's
        parameters: each rank keeps its TP slice and, with FSDP, its FSDP
        slice of that."""
        self._specs = param_specs(params, self.cfg, self.tp, self.fsdp)
        # the local gather dim of each layer leaf (its leading L consumed),
        # per stacked subtree
        self._fdims = {key: _nested({path[1:]: spec.index("data") - 1 if "data" in spec else -1
                                     for path, spec in self._specs.items() if path[0] == key})
                       for key in STACKED if key in params}
        ranks = {"model": (self.tp, self.rt.tp_rank),
                 "data": (self.fsdp, dist.get_rank(self.rt.fsdp_group) if self.fsdp > 1 else 0)}

        def local(spec: tuple, t: torch.Tensor, stacked: bool) -> torch.Tensor:
            out = t
            for axis, (n, r) in ranks.items():
                if axis in spec:
                    out = out.chunk(n, spec.index(axis) - stacked)[r]
            return t if out is t else out.clone(memory_format=torch.contiguous_format)

        def tree(node, prefix: tuple, stacked: bool):
            if isinstance(node, torch.Tensor):
                return local(self._specs[prefix], node, stacked)
            return {k: tree(v, prefix + (k,), stacked) for k, v in node.items()}

        for key, value in params.items():
            if key in STACKED:
                setattr(self, key, nn.ModuleList(_to_module(tree(lp, (key,), True))
                                                 for lp in value))
            elif isinstance(value, torch.Tensor):
                setattr(self, key, nn.Parameter(tree(value, (key,), False),
                                                requires_grad=False))
            else:
                setattr(self, key, _to_module(tree(value, (key,), False)))
        return self

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _head(self) -> torch.Tensor:
        return self.embed if self.cfg.tie_embeddings else self.lm_head

    def _top(self) -> dict:
        """The top-level parameters by the reference's keys, sorted: a
        tensor, a module of tensors, or (a stacked subtree) the list of
        per-layer modules."""
        top = {"embed": self.embed, "final_norm": self.final_norm, "layers": self.layers}
        if not self.cfg.tie_embeddings:
            top["lm_head"] = self.lm_head
        if self.cfg.n_enc_layers > 0:
            top.update(enc_layers=self.enc_layers, enc_norm=self.enc_norm,
                       pos_emb=self.pos_emb)
        return dict(sorted(top.items()))

    def param_tree(self) -> dict:
        """The parameters as the reference's param dict, keys sorted:
        ``layers`` (and ``enc_layers``) the list of per-layer dicts (this
        rank's shards under FSDP)."""
        def tree(m):
            return {k: v if isinstance(v, torch.Tensor) else tree(v) for k, v in m.items()}

        return {k: v if isinstance(v, torch.Tensor) else
                [tree(lp) for lp in v] if k in STACKED else tree(v)
                for k, v in self._top().items()}

    def param_specs(self) -> dict[tuple, tuple]:
        """``param_specs`` of the global parameters this model was given."""
        return self._specs

    def fsdp_dims(self, key: str = "layers") -> dict:
        """Each leaf's local gather dim (-1: replicated) of the stacked
        subtree ``key``, nested as one layer's param dict."""
        return self._fdims[key]

    def _gathered(self, lp):
        """One decoder layer's parameters, FSDP shards gathered."""
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

        top = self._top()
        leaves: list = []
        for key in top:
            if key in STACKED:
                per_layer = [list(walk(lp)) for lp in top[key]]
                leaves.extend(list(ts) for ts in zip(*per_layer))
            elif isinstance(top[key], torch.Tensor):
                leaves.append(top[key])
            else:
                leaves.extend(walk(top[key]))
        return leaves

    def _embed_in(self, tokens: torch.Tensor, pos: torch.Tensor | None = None) -> torch.Tensor:
        """The token embedding; an encoder-decoder model adds its learned
        position rows (from 0, or at ``pos``, a (1,) device tensor, for one
        decode token)."""
        x = layers.embed_lookup(self.embed, tokens, self.rt)
        if self.cfg.n_enc_layers > 0:
            rows = (self.pos_emb[:tokens.shape[1]] if pos is None
                    else self.pos_emb.index_select(0, pos))
            x = x + rows[None].to(x.dtype)
        return x

    def _encode(self, enc_input: torch.Tensor) -> torch.Tensor:
        """The encoder over the stub frontend's frame embeddings (B,
        S_enc, D): sinusoidal positions added in ``cfg.dtype``, the
        encoder stack, its final norm.  Every rank holds the whole
        sequence, under sequence parallelism too (ROADMAP R22)."""
        cfg = self.cfg
        posf = _sinusoidal(enc_input.shape[1], cfg.d_model, enc_input.device)
        x = enc_input.to(cfg.dtype) + posf.to(cfg.dtype)[None]
        x = transformer.encoder_stack(self.enc_layers, x, cfg, self.rt,
                                      self.fsdp_dims("enc_layers") if self.fsdp > 1 else None)
        return layers.apply_norm(self.enc_norm, x, cfg.norm)

    def _check_enc(self, enc_input) -> None:
        if (enc_input is not None) != (self.cfg.n_enc_layers > 0):
            raise ValueError(f"{self.cfg.name}: encoder input "
                             f"{'missing' if enc_input is None else 'given'}")

    def apply_train(self, tokens: torch.Tensor, enc_input: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, S) -> (vocab-sharded logits (B, S, Vl) f32, the MoE
        aux loss summed over the layers, f32), differentiable in the
        parameters, for every ported family (an SSM by its plain path);
        an encoder-decoder model takes the frame embeddings ``enc_input``
        (B, S_enc, D)."""
        cfg, rt = self.cfg, self.rt
        self._check_enc(enc_input)
        sp = rt.sp and rt.tp_group is not None
        x = self._embed_in(tokens)
        enc_out = None if enc_input is None else self._encode(enc_input)
        if sp:
            x = transformer.scatter_from_full(x, rt)
        x, aux = transformer.decoder_stack(self.layers, x, cfg, rt,
                                           self.fsdp_dims() if self.fsdp > 1 else None,
                                           enc_out=enc_out)
        x = layers.apply_norm(self.final_norm, x, cfg.norm)
        if sp:
            x = gather_sp(x, rt.tp_group)
        return layers.lm_head_logits(x, self._head(), rt), aux

    # --------------------------------------------------------- serving --

    def make_caches(self, batch: int, seq_len: int, enc_seq: int = 0):
        """Empty caches stacked over layers: a ``KVCache`` of ``seq_len``
        slots (at most the sliding window), for the SSM family an
        ``SSMState`` (no length to size), for the hybrid family a
        ``HybridCache`` of both, for the encoder-decoder family an
        ``EncDecCache`` whose cross cache has ``enc_seq`` slots."""
        cfg = self.cfg
        if cfg.family == "ssm":
            return ssm.make_ssm_state(cfg, cfg.n_layers, batch, self.tp, self.device)
        kv = attention.make_cache(cfg, cfg.n_layers, batch, self.tp, seq_len,
                                  cfg.dtype, self.device)
        if cfg.parallel_ssm:
            return HybridCache(kv, ssm.make_ssm_state(cfg, cfg.n_layers, batch, self.tp,
                                                      self.device))
        if cfg.n_enc_layers > 0:
            return EncDecCache(kv, attention.make_cache(
                cfg, cfg.n_layers, batch, self.tp, seq_len, cfg.dtype, self.device,
                cross=True, enc_seq=enc_seq))
        return kv

    def _layer_prefill(self, lp, x: torch.Tensor, cache,
                       enc_out: torch.Tensor | None = None) -> torch.Tensor:
        """One layer over the prompt; writes the layer's cache views.  With
        ``enc_out`` the cross-attention sublayer follows the self-attention
        and writes the cross cache."""
        cfg, rt = self.cfg, self.rt
        lp = self._gathered(lp)
        if cfg.family == "ssm":
            h = layers.apply_norm(lp["norm_ssm"], x, cfg.norm)
            return x + _ssm_prefill(lp, h, cfg, rt, cache)
        h = layers.apply_norm(lp["norm_attn"], x, cfg.norm)
        if cfg.parallel_ssm:      # one norm feeds attention and the SSM heads
            a, _ = attention.attention_prefill(lp["attn"], h, cfg, rt, cache.kv)
            x = x + (a + _ssm_prefill(lp, h, cfg, rt, cache.ssm)) * 0.5
        elif enc_out is not None:
            a, _ = attention.attention_prefill(lp["attn"], h, cfg, rt, cache.kv)
            x = x + a
            h = layers.apply_norm(lp["norm_cross"], x, cfg.norm)
            c, _ = attention.attention_prefill(lp["cross"], h, cfg, rt, cache.cross,
                                               x_cross=enc_out)
            x = x + c
        else:
            a, _ = attention.attention_prefill(lp["attn"], h, cfg, rt, cache)
            x = x + a
        return x + self._ffn(lp, layers.apply_norm(lp["norm_mlp"], x, cfg.norm))

    def _layer_decode(self, lp, x: torch.Tensor, cache) -> torch.Tensor:
        """One layer, one token; updates the layer's cache views in place."""
        cfg, rt = self.cfg, self.rt
        lp = self._gathered(lp)
        if cfg.family == "ssm":
            h = layers.apply_norm(lp["norm_ssm"], x, cfg.norm)
            out, _ = ssm.apply_ssm_decode(lp["ssm"], h, cfg, rt, cache)
            return x + out
        h = layers.apply_norm(lp["norm_attn"], x, cfg.norm)
        if cfg.parallel_ssm:
            a, _ = attention.attention_decode(lp["attn"], h, cfg, rt, cache.kv)
            s, _ = ssm.apply_ssm_decode(lp["ssm"], h, cfg, rt, cache.ssm)
            x = x + (a + s) * 0.5
        elif isinstance(cache, EncDecCache):
            a, _ = attention.attention_decode(lp["attn"], h, cfg, rt, cache.kv)
            x = x + a
            h = layers.apply_norm(lp["norm_cross"], x, cfg.norm)
            c, _ = attention.attention_decode(lp["cross"], h, cfg, rt, cache.cross,
                                              cross=True)
            x = x + c
        else:
            a, _ = attention.attention_decode(lp["attn"], h, cfg, rt, cache)
            x = x + a
        return x + self._ffn(lp, layers.apply_norm(lp["norm_mlp"], x, cfg.norm))

    def _ffn(self, lp, h: torch.Tensor) -> torch.Tensor:
        """The feed-forward sublayer of serving: the MoE layer (its aux loss
        dropped) or the MLP (GELU for the encoder-decoder family)."""
        if self.cfg.family == "moe":
            return moe.apply_moe(lp["moe"], h, self.cfg, self.rt)[0]
        if transformer._mlp_kind(self.cfg) == "gelu":
            return transformer.apply_gelu_mlp(lp["mlp"], h, self.rt)
        return layers.apply_mlp(lp["mlp"], h, self.rt)

    @torch.inference_mode()
    def apply_prefill(self, tokens: torch.Tensor, enc_input: torch.Tensor | None = None,
                      max_len: int | None = None):
        """tokens (B, S) -> (last-token vocab-sharded logits (B, 1, Vl) f32,
        caches); an encoder-decoder model takes the frame embeddings
        ``enc_input`` (B, S_enc, D) and runs its encoder first.
        ``max_len`` sizes the KV cache (>= S) to leave decode headroom."""
        cfg, rt = self.cfg, self.rt
        self._check_enc(enc_input)
        B, S = tokens.shape
        x = self._embed_in(tokens)
        enc_out = None
        if enc_input is not None:
            enc_out = self._encode(enc_input)
        caches = self.make_caches(B, max_len or S,
                                  0 if enc_out is None else enc_out.shape[1])
        for i, lp in enumerate(self.layers):
            x = self._layer_prefill(lp, x, caches.layer(i), enc_out)
        x = layers.apply_norm(self.final_norm, x[:, -1:], cfg.norm)
        return layers.lm_head_logits(x, self._head(), rt), caches

    @torch.inference_mode()
    def apply_decode(self, token: torch.Tensor, caches):
        """One decode step, token (B, 1) -> (logits (B, 1, Vl) f32, caches);
        ``caches`` is updated in place and returned."""
        cfg, rt = self.cfg, self.rt
        # an encoder-decoder model's position: its self-attention cache's
        # length, read on the device
        x = self._embed_in(token, caches.kv.length[:1].long()
                           if isinstance(caches, EncDecCache) else None)
        for i, lp in enumerate(self.layers):
            x = self._layer_decode(lp, x, caches.layer(i))
        x = layers.apply_norm(self.final_norm, x, cfg.norm)
        return layers.lm_head_logits(x, self._head(), rt), caches


def _sinusoidal(S: int, d: int, device) -> torch.Tensor:
    """The encoder's sinusoidal positions (S, d) f32: [sin | cos] of
    pos / 10000^(2i/d), computed in f64 as the reference's numpy does."""
    pos = torch.arange(S, dtype=torch.float64)[:, None]
    i = torch.arange(d // 2, dtype=torch.float64)[None, :]
    ang = pos / torch.pow(10000.0, 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(device, torch.float32)


def _ssm_prefill(lp, h: torch.Tensor, cfg: ModelConfig, rt: Runtime, state) -> torch.Tensor:
    """The SSM sublayer over the prompt; writes its final state into
    ``state``, one layer's views."""
    out, st = ssm.apply_ssm(lp["ssm"], h, cfg, rt)
    for dst, src in zip(state, st):
        dst.copy_(src)
    return out
