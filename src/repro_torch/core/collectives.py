"""Heterogeneous collectives: Algorithm 1 + Table 7 over process groups.

The counterpart of the JAX package's ``core/collectives.py``: every
global all-reduce is the hierarchical breakdown

    start homColl (intra-cluster)  ->  C2C (pod group)  ->  end homColl

beside the ``flat`` single-collective baseline.  This module is the
execution interpreter of the schedule IR (``core/schedule.py``, a copy
of the reference's): ``hier_psum`` builds the schedule of its
``CommConfig.mode`` and runs it step by step through ``primitives.py``.

Where the reference names mesh axes, ``CommConfig`` holds groups; a
``pod_group`` of ``None`` means one cluster and skips the C2C steps (and
their codec), while a real pod group of one member runs them, as an
axis of size one does in the reference.

Ported: the ``flat``, ``hier``, ``hier_pipelined`` (the chunk loop of
``core/pipelined.py``) and ``hier_border_rs`` (the border-communicator
legs: a combining reduce-scatter, then an all-gather, over the pod
group) schedules of the all-reduce, with the bf16 and int8 codecs (int8
not with ``hier_border_rs``, as in the reference) and cluster weights,
and the packed pytree entry point.  Every entry point consumes its
input: buffers are reduced in place where the collective allows it.
The raw-shard copy ring of the all-gather and the All2All steps raise
``NotImplementedError`` naming the slice that brings them.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from . import compression, packing, pipelined, primitives
from . import schedule as schedule_ir


@dataclasses.dataclass(frozen=True)
class CommConfig:
    """How the gradient all-reduce is scheduled (see the reference's
    ``CommConfig``).

    mode — a registered schedule mode; ``flat``, ``hier``,
      ``hier_pipelined`` and ``hier_border_rs`` run here.
    pod_group — the cluster group the C2C hop runs over (``None``: one
      cluster, no C2C hop).
    intra_group — the intra-cluster group of the start and end homColl
      (``None``: a group of one).
    dp_group — the group of every data-parallel rank (pods x intra), over
      which ``flat`` makes its one all-reduce (``None``: a group of one).
    compression — optional codec for the pod hop only: ``bf16`` or ``int8``.
    cluster_weights — per-pod gradient weights (mean 1 over pods), one
      entry per pod-group rank; ``None`` is the even split.
    """

    mode: str = "hier"
    pod_group: Any = None
    intra_group: Any = None
    dp_group: Any = None
    n_chunks: int = 4                   # pod-hop chunks of hier_pipelined
    compression: str | None = None
    cluster_weights: tuple[float, ...] | None = None


def _cluster_weight_scalar(cfg: CommConfig) -> torch.Tensor:
    """This rank's per-cluster gradient weight as an f32 0-d tensor."""
    w = torch.tensor(cfg.cluster_weights, dtype=torch.float32)
    if cfg.pod_group is None:
        if w.shape[0] != 1:
            raise ValueError(
                f"cluster_weights has {w.shape[0]} entries but the config "
                "has no pod group (single cluster)")
        return w[0]
    psize = primitives.axis_size(cfg.pod_group)
    if w.shape[0] != psize:
        raise ValueError(f"cluster_weights has {w.shape[0]} entries but the "
                         f"pod group has {psize} pods")
    return w[dist.get_rank(cfg.pod_group)]


def _apply_cluster_weight(x: torch.Tensor, cfg: CommConfig) -> torch.Tensor:
    """Scale by this rank's cluster weight (the full-payload form, only on
    the flat and single-cluster paths; the interpreter defers it)."""
    if cfg.cluster_weights is None:
        return x
    return x * _cluster_weight_scalar(cfg).to(device=x.device, dtype=x.dtype)


def _pad_to(x: torch.Tensor, multiple: int) -> tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % multiple
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat, pad


def _flat_psum(x: torch.Tensor, cfg: CommConfig) -> torch.Tensor:
    """The flat baseline: one all-reduce over every data-parallel rank
    (the reference's single ``psum`` over its data-parallel axes)."""
    dp = primitives.axis_size(cfg.dp_group)
    ranks = primitives.axis_size(cfg.pod_group) * primitives.axis_size(cfg.intra_group)
    if dp != ranks:
        raise ValueError(f"flat: dp_group has {dp} ranks, pod x intra has {ranks}")
    x = primitives.apply_inject(_apply_cluster_weight(x, cfg), "flat")
    return primitives.hom_psum(x, cfg.dp_group)


# ---------------------------------------------------------------------------
# The execution interpreter of the schedule IR
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _ExecCtx:
    """Walk state: the pending wire codec (set by Compress, cleared by
    Decompress), the pod-alignment padding the border exchange's two
    legs round-trip, and the deferred cluster weight (set by Scale,
    consumed by the combining C2C step on the shard or inside the
    codec)."""
    codec: str | None = None
    pod_pad: int = 0
    weight: torch.Tensor | None = None


def _wire_cast(buf: torch.Tensor, codec: str | None, fn) -> torch.Tensor:
    """Run collective ``fn`` with the payload cast to the wire codec: only
    bf16 composes with a native collective (int8 rides its own ring in
    ``compression.compressed_psum``)."""
    if codec == "bf16":
        return fn(buf.to(torch.bfloat16)).to(buf.dtype)
    return fn(buf)


def _not_ported(what: str, slice_: str):
    return NotImplementedError(f"{what} is not ported yet (the {slice_} slice)")


def _exec_step(step: schedule_ir.Step, buf: torch.Tensor, cfg: CommConfig,
               ctx: _ExecCtx) -> torch.Tensor:
    intra, pod = cfg.intra_group, cfg.pod_group
    if isinstance(step, schedule_ir.Scale):
        if cfg.cluster_weights is None:
            return buf
        if pod is None:
            return _apply_cluster_weight(buf, cfg)
        # deferred to the combining C2C step: w·RS(x) == RS(w·x)
        ctx.weight = _cluster_weight_scalar(cfg)
        return buf
    if isinstance(step, (schedule_ir.Pack, schedule_ir.Unpack)):
        # done at the pytree entry point; the buffer arrives packed
        return buf
    if isinstance(step, schedule_ir.Compress):
        ctx.codec = step.codec
        return buf
    if isinstance(step, schedule_ir.Decompress):
        ctx.codec = None
        return buf
    if isinstance(step, schedule_ir.BorderGather):
        # the Fig. 8 bounce is model-only: priced, never run
        return buf
    if isinstance(step, schedule_ir.IntraReduceScatter):
        if step.model_only:
            return buf
        buf = primitives.apply_inject(buf, "intra_rs")
        return primitives.hom_reduce_scatter(buf, intra)
    if isinstance(step, (schedule_ir.IntraAllGather, schedule_ir.IntraBcast)):
        if getattr(step, "model_only", False):
            return buf
        return primitives.hom_all_gather(buf, intra)
    if isinstance(step, schedule_ir.C2CRed):
        if pod is None:
            return buf
        buf = primitives.apply_inject(buf, "c2c")
        w, ctx.weight = ctx.weight, None
        if step.scatter:
            # border-communicator leg 1: a combining reduce-scatter over the
            # pod group leaves each cluster owning 1/P of the shard
            ctx.pod_pad = (-buf.numel()) % primitives.axis_size(pod)
            if ctx.pod_pad:
                buf = torch.cat([buf, buf.new_zeros(ctx.pod_pad)])
            if w is not None:
                buf = buf * w.to(device=buf.device, dtype=buf.dtype)
            return _wire_cast(buf, ctx.codec,
                              lambda b: primitives.hom_reduce_scatter(b, pod))
        if ctx.codec is not None:
            # the weight folds into the codec's nb-sized scale vector
            return compression.compressed_psum(buf, pod, ctx.codec, weight=w)
        if w is not None:
            buf = buf * w.to(device=buf.device, dtype=buf.dtype)
        return primitives.c2c_red(buf, pod)
    if isinstance(step, schedule_ir.C2CCpy):
        if pod is None:
            return buf
        buf = primitives.apply_inject(buf, "c2c")
        if not step.gather:
            raise _not_ported("the raw-shard C2C copy ring (AllGatherH)",
                              "ZeRO-1 / FSDP")
        # border-communicator leg 2: gather the owned, fully reduced shards
        # (already codec-rounded, so the wire cast is lossless here)
        out = _wire_cast(buf, ctx.codec, lambda b: primitives.hom_all_gather(b, pod))
        if ctx.pod_pad:
            out = out[:-ctx.pod_pad]
            ctx.pod_pad = 0
        return out
    if isinstance(step, schedule_ir.ChunkLoop):
        w, ctx.weight = ctx.weight, None
        return pipelined.execute_chunk_loop(step, buf, cfg, weight=w)
    if isinstance(step, schedule_ir.Flat):
        raise ValueError("Flat steps are handled by the entry points")
    if isinstance(step, (schedule_ir.IntraAll2All, schedule_ir.BorderExchange)):
        raise _not_ported("All2All", "MoE")
    raise NotImplementedError(f"no executor for step {step!r}")


def _exec_steps(steps, buf: torch.Tensor, cfg: CommConfig) -> torch.Tensor:
    ctx = _ExecCtx()
    for step in steps:
        buf = _exec_step(step, buf, cfg, ctx)
    return buf


# ---------------------------------------------------------------------------
# AllReduceH on one tensor
# ---------------------------------------------------------------------------

def hier_psum(x: torch.Tensor, cfg: CommConfig) -> torch.Tensor:
    """Global all-reduce over (pod, intra): build the mode's schedule and
    execute it.  ``x`` is consumed: it may be reduced in place, and the
    result may share its memory."""
    sched = schedule_ir.build_schedule("all_reduce", cfg.mode, cfg.n_chunks,
                                       cfg.compression)
    if cfg.cluster_weights is not None:
        sched = schedule_ir.with_cluster_scale(sched)
    if any(isinstance(s, schedule_ir.Flat) for s in sched.steps):
        return _flat_psum(x, cfg)
    shape = x.shape
    flat, pad = _pad_to(x, primitives.axis_size(cfg.intra_group))
    del x
    out = _exec_steps(sched.steps, flat, cfg)
    if pad:
        out = out[:-pad]
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# Pytree entry points (packed data path)
# ---------------------------------------------------------------------------

def _dp_world(cfg) -> int:
    world = primitives.axis_size(cfg.intra_group)
    if cfg.pod_group is not None:
        world *= primitives.axis_size(cfg.pod_group)
    return world


def wire_block(compression_codec: str | None) -> int:
    """Block alignment the wire codec needs: the int8 codec quantizes in
    ``compression.BLOCK``-element blocks; everything else is block-free."""
    return compression.BLOCK if compression_codec == "int8" else 1


def comm_layout(leaves, cfg: CommConfig, world: int | None = None
                ) -> packing.PackedLayout:
    """The persistent packed layout of one gradient sync: one segment per
    wire dtype, aligned for the schedule it will run."""
    if world is None:
        world = _dp_world(cfg)
    align = packing.comm_alignment(world, cfg.n_chunks, wire_block(cfg.compression))
    return packing.plan_layout(packing.tree_metas(leaves), world=world,
                               align_for=lambda dt, used: align)


def tree_hier_psum(leaves: list, cfg: CommConfig) -> list[torch.Tensor]:
    """Gradient sync: AllReduceH over a list of leaves (each a tensor, or
    a list of tensors standing for their stack), written into the
    persistent layout of ``core/packing.py``.  Returns one view of the
    synced segments per leaf, a list leaf as its (L, ...) stack.
    ``leaves`` is emptied once the buffers are built, so a caller holding
    no other reference frees the gradients before the sync runs."""
    layout = comm_layout(leaves, cfg)
    bufs = packing.pack(layout, leaves)
    leaves.clear()
    out = {dt: hier_psum(bufs.pop(dt), cfg) for dt in list(bufs)}
    return packing.unpack(layout, out)
