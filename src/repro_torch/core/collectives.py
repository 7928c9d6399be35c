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
and the packed pytree entry point (``resolve_config`` takes a
per-bucket plan as the reference does); ReduceScatterH
(``hier_psum_scatter``) and AllGatherH (``hier_all_gather``, the
raw-shard copy ring then the intra broadcast); and the ZeRO-1 flat-shard
layer (``zero1_local_shard``, ``tree_hier_psum_scatter``,
``tree_hier_unscatter``).  Every entry point consumes its input:
buffers are reduced in place where the collective allows it, and the
interpreter holds the payload in a list of one that the int8 codec
empties, so the payload is freed once it is quantized.  The All2All
steps raise ``NotImplementedError`` naming the slice that brings them.
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
      ``hier_pipelined`` and ``hier_border_rs`` run here (``hier_zero1``
      runs ``hier``'s reduce-scatter and all-gather schedules).
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


def resolve_config(cfg, nbytes: int) -> CommConfig:
    """Per-bucket planner support: every collective entry point accepts
    either a plain ``CommConfig`` (one schedule for everything) or any
    object with a ``config_for(nbytes) -> CommConfig`` method — in
    practice a ``planner.CommPlan`` — which picks the schedule by the
    bucket's local payload size.  Duck-typed so core.collectives never
    imports core.planner (which imports this module)."""
    fn = getattr(cfg, "config_for", None)
    return cfg if fn is None else fn(int(nbytes))


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


def _pad_to(x: torch.Tensor, multiple: int) -> torch.Tensor:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % multiple
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat


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


def _exec_step(step: schedule_ir.Step, payload: list, cfg: CommConfig,
               ctx: _ExecCtx) -> torch.Tensor:
    """Run one step on ``payload[0]``, taking it out of the list, and return
    the result."""
    intra, pod = cfg.intra_group, cfg.pod_group
    if (isinstance(step, schedule_ir.C2CRed) and pod is not None and not step.scatter
            and ctx.codec is not None):
        # handed to the codec straight from the list, so that no frame here
        # holds the payload: the int8 codec frees it once quantized.  The
        # weight folds into the codec's nb-sized scale vector.
        w, ctx.weight = ctx.weight, None
        return compression.compressed_psum(
            primitives.apply_inject(payload.pop(), "c2c"), pod, ctx.codec, weight=w)
    buf = payload.pop()
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
        if w is not None:
            buf = buf * w.to(device=buf.device, dtype=buf.dtype)
        return primitives.c2c_red(buf, pod)
    if isinstance(step, schedule_ir.C2CCpy):
        if pod is None:
            return buf
        buf = primitives.apply_inject(buf, "c2c")
        if not step.gather:
            # AllGatherH's raw-shard pod ring: stacks pods on a leading dim
            return primitives.c2c_cpy(buf, pod)
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


def _exec_steps(steps, payload: list, cfg: CommConfig) -> torch.Tensor:
    """Run ``steps`` on the payload in ``payload``, a list of one tensor
    that the walk empties: only the list holds the payload between steps,
    so a step that consumes it can free it."""
    ctx = _ExecCtx()
    for step in steps:
        payload.append(_exec_step(step, payload, cfg, ctx))
    return payload.pop()


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
    shape, n = x.shape, x.numel()
    payload = [_pad_to(x, primitives.axis_size(cfg.intra_group))]
    del x
    return _exec_steps(sched.steps, payload, cfg)[:n].reshape(shape)


def hier_psum_scatter(x: torch.Tensor, cfg: CommConfig) -> torch.Tensor:
    """ReduceScatterH: ReduceScatter over the intra group, then c2cRed over
    the pods.  Returns this rank's 1/intra_size flat shard (``x`` padded to
    a multiple of the intra group's size), globally summed.  This is the
    ZeRO-1 entry: the end AllGather is deferred to the parameter
    reconstruction.  ``x`` is consumed."""
    intra = cfg.intra_group
    isize = primitives.axis_size(intra)
    sched = schedule_ir.build_schedule("reduce_scatter", cfg.mode, cfg.n_chunks,
                                       cfg.compression)
    if cfg.cluster_weights is not None:
        sched = schedule_ir.with_cluster_scale(sched)
    payload = [_pad_to(x, isize)]
    del x
    if any(isinstance(s, schedule_ir.Flat) for s in sched.steps):
        shard = primitives.hom_reduce_scatter(_apply_cluster_weight(payload.pop(), cfg),
                                              intra)
        if cfg.pod_group is not None:
            shard = primitives.hom_psum(shard, cfg.pod_group)
        return shard
    # the scattered sync is not chunk-pipelined (there is no end phase to
    # overlap): interpret a ChunkLoop body sequentially
    steps, _ = sched.unrolled()
    return _exec_steps(steps, payload, cfg)


def hier_all_gather_flat(shard: torch.Tensor, cfg: CommConfig,
                         orig_size: int) -> torch.Tensor:
    """Inverse of ``hier_psum_scatter``: AllGather the flat shard over the
    intra group and trim the padding (the deferred end homColl)."""
    return primitives.hom_all_gather(shard, cfg.intra_group)[:orig_size]


# ---------------------------------------------------------------------------
# AllGatherH (Table 7 row 2): c2cCpy of raw shards, then intra Bcast
# ---------------------------------------------------------------------------

def hier_all_gather(x: torch.Tensor, cfg: CommConfig, gather_dim: int = 0) -> torch.Tensor:
    """Gather every data-parallel rank's ``x`` along ``gather_dim``, in rank
    order (pod-major), through the mode's schedule.  For the hier family
    the raw shard crosses the pods first (C2CCpy: one copy crosses
    between clusters, Table-7 optimal), then the intra AllGather doubles
    as the end Bcast (IntraBcast)."""
    sched = schedule_ir.build_schedule("all_gather", cfg.mode, cfg.n_chunks,
                                       cfg.compression)
    if cfg.pod_group is None:
        return primitives.hom_all_gather(x, cfg.intra_group, gather_dim)
    if any(isinstance(s, schedule_ir.Flat) for s in sched.steps):
        return primitives.hom_all_gather(x, cfg.dp_group, gather_dim)
    g = gather_dim
    steps, _ = sched.unrolled()          # the gather path is not chunk-pipelined
    pods = x[None]
    for step in steps:
        if isinstance(step, schedule_ir.C2CCpy):
            pods = primitives.c2c_cpy(x, cfg.pod_group)                # (P, *x)
        elif isinstance(step, schedule_ir.IntraBcast):
            n_pods = pods.shape[0]
            pods = primitives.hom_all_gather(pods, cfg.intra_group)   # (D*P, *x)
            pods = pods.reshape((-1, n_pods) + tuple(x.shape)).transpose(0, 1)
    alld = torch.movedim(pods, (0, 1), (g, g + 1))                     # x[:g], P, D, x[g:]
    new_shape = x.shape[:g] + (pods.shape[0] * pods.shape[1] * x.shape[g],) + x.shape[g + 1:]
    return alld.reshape(new_shape)


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


# ---------------------------------------------------------------------------
# ZeRO-1 flat-shard view
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FlatShardMeta:
    """Static metadata of the packed flat f32 master of a list of leaves
    (ZeRO-1).  The master is the concatenation of per-wire-dtype segments
    (the ``core/packing.py`` layout, each segment aligned to
    ``intra_size * BLOCK``), sharded per segment over the intra group, so
    that the parameter reconstruction's AllGather runs in each segment's
    own wire dtype.  The leaves are a list, so there is no treedef."""
    layout: packing.PackedLayout
    total: int           # unpadded total elements across segments
    padded: int          # master length (sum of padded segments)


def _zero1_layout(leaves, intra_size: int) -> packing.PackedLayout:
    """The persistent master layout shared by the bootstrap, the scattered
    gradient sync and the parameter reconstruction: one segment per wire
    dtype, aligned so that every segment's intra shard is whole and the
    int8 codec never re-pads."""
    return packing.plan_layout(packing.tree_metas(leaves),
                               world=max(1, int(intra_size)),
                               block=packing.DEFAULT_BLOCK)


def _meta(layout: packing.PackedLayout) -> FlatShardMeta:
    return FlatShardMeta(layout, layout.used_total, layout.padded_total)


def _cat(parts: list[torch.Tensor]) -> torch.Tensor:
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def zero1_local_shard(leaves, cfg: CommConfig) -> tuple[torch.Tensor, FlatShardMeta]:
    """Bootstrap the ZeRO-1 f32 master shard from this rank's parameters:
    pack per segment, take this rank's slice of each segment by its rank
    in the intra group, cast to f32 (a new buffer), concatenate once."""
    intra = cfg.intra_group
    isize = primitives.axis_size(intra)
    rank = 0 if intra is None else dist.get_rank(intra)
    layout = _zero1_layout(leaves, isize)
    bufs = packing.pack(layout, leaves)
    parts = []
    for seg in layout.segments:
        ssz = seg.padded // isize
        parts.append(bufs.pop(seg.dtype)[rank * ssz:(rank + 1) * ssz]
                     .to(torch.float32, copy=True))
    return _cat(parts), _meta(layout)


def tree_hier_psum_scatter(leaves: list, cfg: CommConfig
                           ) -> tuple[torch.Tensor, FlatShardMeta]:
    """Gradient sync of ZeRO-1: the summed flat f32 master shard (length
    padded / intra_size) and the metadata to rebuild the parameters.

    Segments are laid out per wire dtype, but the gradient reduction runs
    in f32 for every segment, as in the reference; the 2-byte wire of a
    bf16 segment lands on the reconstruction's AllGather.  ``leaves`` is
    emptied once packed, and each packed segment is released once cast
    to f32."""
    isize = primitives.axis_size(cfg.intra_group)
    layout = _zero1_layout(leaves, isize)
    bufs = packing.pack(layout, leaves)
    leaves.clear()
    shards = [hier_psum_scatter(bufs.pop(seg.dtype).float(), cfg)
              for seg in layout.segments]
    return _cat(shards), _meta(layout)


def tree_hier_unscatter(shard: torch.Tensor, fmeta: FlatShardMeta,
                        cfg: CommConfig) -> list[torch.Tensor]:
    """Inverse of ``tree_hier_psum_scatter``: gather each segment's slice
    of the shard over the intra group in the segment's wire dtype, and
    return one view per leaf (a list leaf as its (L, ...) stack).  An f32
    segment's views may share the shard's memory."""
    intra = cfg.intra_group
    isize = primitives.axis_size(intra)
    gathered: dict[str, torch.Tensor] = {}
    off = 0
    for seg in fmeta.layout.segments:
        ssz = seg.padded // isize
        piece = shard[off:off + ssz].to(packing.torch_dtype(seg.dtype))
        off += ssz
        gathered[seg.dtype] = primitives.hom_all_gather(piece, intra)
    return packing.unpack(fmeta.layout, gathered)
