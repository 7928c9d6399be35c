"""Per-layer init, the training layer and the layer stack.  The dense
decoder family is ported for serving and training, at any tensor-parallel
size and with sequence parallelism; the SSM family (Mamba2) for serving
at a TP group of one; the other families (MoE, hybrid, encoder-decoder,
VLM), SSM training and Mamba2 under TP come with their slices."""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.sharding import Runtime, fsdp_gather, gather_sp, scatter_sp
from . import attention, layers, ssm

PORTED_FAMILIES = ("dense", "ssm")


def check_ported(cfg: ModelConfig, tp: int) -> None:
    """Raise for a family, or a family at a TP size, the port lacks."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet; "
            f"{PORTED_FAMILIES} are")
    if cfg.family == "ssm" and tp > 1:
        # its projections are not split by head yet: a sum over the TP group
        # would add up whole outputs
        raise NotImplementedError(
            f"the SSM family ({cfg.name}) at a tensor-parallel size of {tp} is not "
            f"ported yet: it comes with the slice 'Mamba2 serving under TP' "
            f"(ssm_heads(tp), the sharded conv and state)")


def init_layer(gen: torch.Generator, cfg: ModelConfig, tp: int, dtype) -> dict:
    """One decoder layer's params, the reference's pytree leaf for leaf."""
    check_ported(cfg, tp)
    if cfg.family == "ssm":
        return {"norm_ssm": layers.init_norm(cfg.norm, cfg.d_model, dtype, gen.device),
                "ssm": ssm.init_ssm(gen, cfg, tp, dtype)}
    return {
        "norm_attn": layers.init_norm(cfg.norm, cfg.d_model, dtype, gen.device),
        "attn": attention.init_attention(gen, cfg, tp, dtype),
        "norm_mlp": layers.init_norm(cfg.norm, cfg.d_model, dtype, gen.device),
        "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype),
    }


def _sub(x_res: torch.Tensor, fn, rt: Runtime) -> torch.Tensor:
    """A TP sublayer on the residual stream.  Under sequence parallelism
    the stream is sharded on the sequence: gather it, take the sublayer's
    partial sums (``fn(x, False)``) and reduce-scatter them; otherwise the
    sublayer sums over the TP group itself (``fn(x, True)``)."""
    if rt.sp and rt.tp_group is not None:
        return scatter_sp(fn(gather_sp(x_res, rt.tp_group), False), rt.tp_group)
    return fn(x_res, True)


def scatter_from_full(out_full: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """This rank's sequence shard of an already reduced full output."""
    shard = out_full.shape[1] // rt.tp
    return out_full.narrow(1, rt.tp_rank * shard, shard)


def apply_layer(p, x: torch.Tensor, cfg: ModelConfig, rt: Runtime, *,
                causal: bool = True) -> torch.Tensor:
    """One dense decoder layer for training, x: (B, S, D) -> (B, S, D), or
    (B, S/tp, D) under sequence parallelism.  The dense family has no
    auxiliary loss; it comes with MoE."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"training the {cfg.family!r} family ({cfg.name}) is not ported "
            f"yet: it comes with the SSM training slice (the SSD kernel has "
            f"no backward)")
    h = layers.apply_norm(p["norm_attn"], x, cfg.norm)
    x = x + _sub(h, lambda xg, red: attention.attention_train(
        p["attn"], xg, cfg, rt, causal=causal, reduce=red), rt)
    h = layers.apply_norm(p["norm_mlp"], x, cfg.norm)
    return x + _sub(h, lambda xg, red: layers.apply_mlp(p["mlp"], xg, rt, red), rt)


def _gathered_layer(lp, fsdp_dims, x: torch.Tensor, *, cfg: ModelConfig, rt: Runtime,
                    causal: bool) -> torch.Tensor:
    if fsdp_dims is not None:
        lp = fsdp_gather(lp, fsdp_dims, rt.fsdp_group)
    return apply_layer(lp, x, cfg, rt, causal=causal)


def decoder_stack(stack, x: torch.Tensor, cfg: ModelConfig, rt: Runtime,
                  fsdp_dims=None, *, causal: bool = True) -> torch.Tensor:
    """The layers in order, each checkpointed (its activations are
    recomputed in the backward pass), as the reference checkpoints its
    scan body.  With ``fsdp_dims`` each layer first gathers its FSDP
    shards over ``rt.fsdp_group``, inside the checkpoint, so the gather
    runs again in the recompute and its reduce-scatter in the backward."""
    for lp in stack:
        fn = functools.partial(_gathered_layer, lp, fsdp_dims, cfg=cfg, rt=rt,
                               causal=causal)
        x = checkpoint(fn, x, use_reentrant=False)
    return x
