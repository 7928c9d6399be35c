"""Per-layer init, the training layer and the layer stacks, for all six
families of the reference: dense decoders, MoE (by expert parallelism or
expert-tensor parallelism, ``models/moe.py``), SSM (Mamba2), hybrid
(Hymba: attention and SSM heads side by side on one norm), the
encoder-decoder (whisper: a non-causal encoder stack of attention and
GELU MLP, and decoder layers with cross-attention over its output) and
the VLM (chameleon: a dense decoder with QK-norm, its image tokens in
the shared vocabulary).  Each serves and trains at any tensor-parallel
size, its heads padded to it as the reference pads them (but R17), with
sequence parallelism."""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.sharding import (Runtime, copy_to_tp, fsdp_gather, gather_sp,
                                           reduce_from_tp, remat_policy_for, scatter_sp,
                                           tp_entry_group)
from . import attention, layers, moe, ssm

PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def check_ported(cfg: ModelConfig, tp: int) -> None:
    """Raise for a family the port lacks, and for a hybrid model whose
    local Q heads are no multiple of its local KV heads at ``tp``: the
    reference's GQA repeat (``_repeat_kv(k, H // K)``) would give fewer KV
    rows than Q heads there (ROADMAP R17; hymba-1.5b's 25 Q / 5 KV are
    13 / 3 per rank at TP 2 and 7 / 2 at TP 4; at TP 8 the KV heads are
    replicated and gathered per Q head, which pairs).  Every other
    configuration whose heads pad at ``tp`` runs at the padded shapes."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported; "
            f"{PORTED_FAMILIES} are")
    if cfg.family != "hybrid":
        return
    # replicated KV is gathered per local Q head: one KV row per Q head
    hl = cfg.local_q_heads(tp)
    kl = hl if cfg.kv_replicated(tp) else cfg.local_kv_heads(tp)
    if hl % kl:
        raise ValueError(
            f"{cfg.name} at a tensor-parallel size of {tp}: {hl} local Q heads are no "
            f"multiple of {kl} local KV heads (heads padded to {cfg.padded_heads(tp)} / "
            f"{cfg.padded_kv_heads(tp)}), so the reference's GQA repeat cannot pair them")


def _mlp_kind(cfg: ModelConfig) -> str:
    return "gelu" if cfg.family == "encdec" else "swiglu"


def init_gelu_mlp(gen: torch.Generator, d: int, d_ff: int, dtype) -> dict:
    return {"w1": layers.init_dense(gen, d, d_ff, dtype),
            "b1": torch.zeros((d_ff,), dtype=dtype, device=gen.device),
            "w2": layers.init_dense(gen, d_ff, d, dtype),
            "b2": torch.zeros((d,), dtype=dtype, device=gen.device)}


def apply_gelu_mlp(p, x: torch.Tensor, rt: Runtime, reduce: bool = True,
                   last: bool = False) -> torch.Tensor:
    """Whisper's MLP: column-parallel ``w1``/``b1``, GELU in its tanh form
    (``jax.nn.gelu``'s default), row-parallel ``w2``.  The replicated
    ``b2`` is added after the reduce, once; the partial sums of
    ``reduce=False`` (sequence parallelism) leave it out, as the
    reference's do.  ``last``: the layer's last sum (``reduce_from_tp``)."""
    x = copy_to_tp(x, tp_entry_group(rt))
    h = F.gelu(x @ p["w1"] + p["b1"], approximate="tanh")
    out = h @ p["w2"]
    return reduce_from_tp(out, rt.tp_group, last) + p["b2"] if reduce else out


def init_layer(gen: torch.Generator, cfg: ModelConfig, tp: int, dtype,
               cross: bool = False) -> dict:
    """One decoder layer's params, the reference's pytree leaf for leaf;
    ``cross`` adds the cross-attention block and its norm (whisper)."""
    check_ported(cfg, tp)
    if cfg.family == "ssm":
        return {"norm_ssm": layers.init_norm(cfg.norm, cfg.d_model, dtype, gen.device),
                "ssm": ssm.init_ssm(gen, cfg, tp, dtype)}
    p = {
        "norm_attn": layers.init_norm(cfg.norm, cfg.d_model, dtype, gen.device),
        "attn": attention.init_attention(gen, cfg, tp, dtype),
        "norm_mlp": layers.init_norm(cfg.norm, cfg.d_model, dtype, gen.device),
    }
    if cfg.parallel_ssm:        # hymba: SSM heads beside the attention heads
        p["ssm"] = ssm.init_ssm(gen, cfg, tp, dtype)
    if cross:
        p["norm_cross"] = layers.init_norm(cfg.norm, cfg.d_model, dtype, gen.device)
        p["cross"] = attention.init_attention(gen, cfg, tp, dtype, cross=True)
    if cfg.family == "moe":
        p["moe"] = moe.init_moe(gen, cfg, tp, dtype)
    elif _mlp_kind(cfg) == "gelu":
        p["mlp"] = init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, dtype)
    else:
        p["mlp"] = layers.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype)
    return p


def init_encoder_layer(gen: torch.Generator, cfg: ModelConfig, tp: int, dtype) -> dict:
    return {"norm_attn": layers.init_norm(cfg.norm, cfg.d_model, dtype, gen.device),
            "attn": attention.init_attention(gen, cfg, tp, dtype),
            "norm_mlp": layers.init_norm(cfg.norm, cfg.d_model, dtype, gen.device),
            "mlp": init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, dtype)}


def _sub(x_res: torch.Tensor, fn, rt: Runtime) -> torch.Tensor:
    """A TP sublayer on the residual stream.  Under sequence parallelism
    the stream is sharded on the sequence: gather it, take the sublayer's
    partial sums (``fn(x, False)``) and reduce-scatter them; otherwise the
    sublayer sums over the TP group itself (``fn(x, True)``)."""
    if rt.sp and rt.tp_group is not None:
        return scatter_sp(fn(gather_sp(x_res, rt.tp_group), False), rt.tp_group)
    return fn(x_res, True)


def _sub_reduced(x_res: torch.Tensor, fn_full, rt: Runtime) -> torch.Tensor:
    """A sublayer that sums over the TP group itself (SSM, hybrid, MoE): under sequence
    parallelism gather the sequence, run it, and keep this rank's shard of
    the reduced output."""
    if rt.sp and rt.tp_group is not None:
        return scatter_from_full(fn_full(gather_sp(x_res, rt.tp_group)), rt)
    return fn_full(x_res)


def scatter_from_full(out_full: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """This rank's sequence shard of an already reduced full output."""
    shard = out_full.shape[1] // rt.tp
    return out_full.narrow(1, rt.tp_rank * shard, shard)


def apply_layer(p, x: torch.Tensor, cfg: ModelConfig, rt: Runtime, *,
                enc_out: torch.Tensor | None = None,
                causal: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer for training, x: (B, S, D) -> (B, S, D), or
    (B, S/tp, D) under sequence parallelism; returns (x, aux), the MoE
    load-balance loss (0 for any other layer).  The SSM runs its plain,
    differentiable path (``apply_ssm(train=True)``).  ``enc_out`` (the
    encoder's whole output on every rank) adds the cross-attention
    sublayer.  The last sublayer (the MLP, the MoE block or the SSM) sums
    with ``last=True``: the remat policy keeps none of its TP sums."""
    aux0 = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        h = layers.apply_norm(p["norm_ssm"], x, cfg.norm)
        return x + _sub_reduced(h, lambda xg: ssm.apply_ssm(p["ssm"], xg, cfg, rt, train=True,
                                                            last=True)[0], rt), aux0
    h = layers.apply_norm(p["norm_attn"], x, cfg.norm)
    if cfg.parallel_ssm:        # hymba: attention and SSM heads on the same input
        def both(xg):
            a = attention.attention_train(p["attn"], xg, cfg, rt, causal=causal)
            s = ssm.apply_ssm(p["ssm"], xg, cfg, rt, train=True)[0]
            return (a + s) * 0.5

        x = x + _sub_reduced(h, both, rt)
    else:
        x = x + _sub(h, lambda xg, red: attention.attention_train(
            p["attn"], xg, cfg, rt, causal=causal, reduce=red), rt)
    if enc_out is not None:
        h = layers.apply_norm(p["norm_cross"], x, cfg.norm)
        x = x + _sub(h, lambda xg, red: attention.attention_train(
            p["cross"], xg, cfg, rt, x_cross=enc_out, reduce=red), rt)
    h = layers.apply_norm(p["norm_mlp"], x, cfg.norm)
    if cfg.family == "moe":
        aux = []

        def moe_full(xg):
            out, a = moe.apply_moe(p["moe"], xg, cfg, rt, last=True)
            aux.append(a)
            return out

        return x + _sub_reduced(h, moe_full, rt), aux[0]
    mlp = apply_gelu_mlp if _mlp_kind(cfg) == "gelu" else layers.apply_mlp
    return x + _sub(h, lambda xg, red: mlp(p["mlp"], xg, rt, red, last=True), rt), aux0


def apply_encoder_layer(p, x: torch.Tensor, cfg: ModelConfig, rt: Runtime) -> torch.Tensor:
    """One encoder layer, x: (B, S_enc, D), the whole sequence on every
    rank: non-causal self-attention (with RoPE) and the GELU MLP, each
    through ``_sub`` as the reference's ``encoder_stack`` has them.  Under
    sequence parallelism that gathers the already whole sequence tp times
    over (ROADMAP R22).  In training the attention is plain; in serving
    (``torch.inference_mode``) it takes the flash kernel's path."""
    h = layers.apply_norm(p["norm_attn"], x, cfg.norm)
    x = x + _sub(h, lambda xg, red: attention.attention_train(
        p["attn"], xg, cfg, rt, causal=False, reduce=red), rt)
    h = layers.apply_norm(p["norm_mlp"], x, cfg.norm)
    return x + _sub(h, lambda xg, red: apply_gelu_mlp(p["mlp"], xg, rt, red), rt)


def _gathered_layer(lp, fsdp_dims, x: torch.Tensor, enc_out: torch.Tensor | None = None, *,
                    cfg: ModelConfig, rt: Runtime,
                    causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    if fsdp_dims is not None:
        lp = fsdp_gather(lp, fsdp_dims, rt.fsdp_group)
    return apply_layer(lp, x, cfg, rt, enc_out=enc_out, causal=causal)


def _gathered_encoder_layer(lp, fsdp_dims, x: torch.Tensor, *, cfg: ModelConfig,
                            rt: Runtime) -> torch.Tensor:
    if fsdp_dims is not None:
        lp = fsdp_gather(lp, fsdp_dims, rt.fsdp_group)
    return apply_encoder_layer(lp, x, cfg, rt)


def encoder_stack(stack, x: torch.Tensor, cfg: ModelConfig, rt: Runtime,
                  fsdp_dims=None) -> torch.Tensor:
    """The encoder layers in order; in training each is checkpointed, as
    ``decoder_stack``'s are, with its FSDP gather (``fsdp_dims``) inside,
    and recomputed whole whatever ``rt.remat_policy`` says, as the
    reference's encoder scan is."""
    for lp in stack:
        fn = functools.partial(_gathered_encoder_layer, lp, fsdp_dims, cfg=cfg, rt=rt)
        x = checkpoint(fn, x, use_reentrant=False) if torch.is_grad_enabled() else fn(x)
    return x


def decoder_stack(stack, x: torch.Tensor, cfg: ModelConfig, rt: Runtime,
                  fsdp_dims=None, *, enc_out: torch.Tensor | None = None,
                  causal: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """The layers in order, each checkpointed (its activations are
    recomputed in the backward pass), as the reference checkpoints its
    scan body; returns (x, the aux losses summed over the layers in f32,
    as the reference's scan carries them).  Each layer's aux leaves the
    checkpoint as part of its output, so the recompute adds nothing.
    With ``fsdp_dims`` each layer first gathers its FSDP shards over
    ``rt.fsdp_group``, inside the checkpoint, so the gather runs again in
    the recompute and its reduce-scatter in the backward.  ``enc_out``
    feeds every layer's cross-attention.  ``rt.remat_policy`` picks what
    the checkpoint keeps (``remat_policy_for``)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    policy = remat_policy_for(rt)
    kw = {} if policy is None else {"context_fn": policy}
    for lp in stack:
        fn = functools.partial(_gathered_layer, lp, fsdp_dims, cfg=cfg, rt=rt,
                               causal=causal)
        x, a = checkpoint(fn, x, enc_out, use_reentrant=False, **kw)
        aux = aux + a
    return x, aux
