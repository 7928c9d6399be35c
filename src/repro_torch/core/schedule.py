"""Cluster-level primitive schedule IR (paper §4.2–4.4; DESIGN.md §9).

HetCCL's central abstraction — dissecting a global collective into
cluster-level primitives — is represented here as an explicit, inert
*schedule*: a tuple of primitive steps.  One decomposition, three
interpreters:

  * **execute** (`collectives.execute`) runs the steps via
    `primitives.py` inside shard_map;
  * **price**   (`cost_model.estimate_schedule`) walks the same steps
    through the α–β closed form;
  * **simulate** (`transport_sim.simulate_schedule`) walks them through
    the discrete-event transport queue.

New schedules are added in one place — a builder registered with
`@register_builder("<mode>")` — and are executed, priced, and simulated
for free.  `tools/check_schedule_cover.py` gates CI on every
`CommConfig.mode` string having a registered builder, so the
triple-maintenance drift this module removed cannot re-grow.

This module is pure data + stdlib: it imports no JAX and no sibling
module, so every interpreter (and the CI gate) can import it freely.

Step volumes are *symbolic* (``FULL``, ``INTRA_SHARD``, …): the
builders don't know the payload or the topology; each interpreter
evaluates them per cluster via :func:`eval_volume`.  A few steps are
``model_only`` — they price the general border-rank case (e.g. the
Fig. 8 bounce hop) that the all-border TPU execution mapping absorbs
into native collectives; the executor skips them, the pricer and the
simulator charge them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

# ---------------------------------------------------------------------------
# Wire codecs (DCN hop only).  int8 carries one byte per element plus one
# f32 scale per 1024-element block (compression._CHUNK).
# ---------------------------------------------------------------------------

CODEC_WIRE_RATIO: dict[str | None, float] = {
    None: 1.0, "bf16": 0.5, "int8": 0.25 + 1.0 / 1024.0,
}

# TrainConfig.comm_mode values that wrap *optimizer structure* around an
# executable schedule rather than naming a decomposition of their own —
# the value is the CommConfig.mode their collectives actually run.
# (hier_overlap chains per-bucket hier syncs; hier_zero1 fuses the end
# AllGather into the param update; fsdp gets its start phase from
# autodiff.)  tools/check_schedule_cover.py accepts these as covered.
STRUCTURAL_MODES: dict[str, str] = {
    "hier_overlap": "hier", "hier_zero1": "hier", "fsdp": "hier",
}

# ---------------------------------------------------------------------------
# Symbolic per-cluster step volumes (bytes, given per-rank payload n)
# ---------------------------------------------------------------------------

FULL = "full"                    # n
INTRA_SHARD = "intra_shard"      # n / cluster ranks
CLUSTER_SHARD = "cluster_shard"  # n / n_clusters
REMOTE = "remote"                # (G - N) * n / N   (other clusters' data)


def eval_volume(vol: str, n: float, topo, cluster) -> float:
    """Bytes of a symbolic step volume for per-rank payload ``n`` on one
    cluster of ``topo`` (both are topology.py objects; this module never
    imports them — duck-typed on n_ranks/n_clusters)."""
    if vol == FULL:
        return float(n)
    if vol == INTRA_SHARD:
        return n / max(1, cluster.n_ranks)
    if vol == CLUSTER_SHARD:
        return n / max(1, topo.n_clusters)
    if vol == REMOTE:
        return (topo.n_ranks - cluster.n_ranks) * n / max(1, cluster.n_ranks)
    raise ValueError(f"unknown step volume {vol!r}")


# ---------------------------------------------------------------------------
# Steps.  ``phase`` places a step in the 3-stage pipeline of Algorithm 1
# ("start" homColl | "c2c" | "end" homColl) — the unit the pipelined
# estimate and the chunk-loop executor overlap.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Step:
    phase: str          # "start" | "c2c" | "end" | "all" (ChunkLoop)


@dataclasses.dataclass(frozen=True)
class IntraReduceScatter(Step):
    """Intra-cluster ring ReduceScatter of ``vol`` bytes per rank."""
    vol: str = FULL
    model_only: bool = False


@dataclasses.dataclass(frozen=True)
class IntraAllGather(Step):
    """Intra-cluster ring AllGather; ``vol`` is the per-rank shard."""
    vol: str = INTRA_SHARD
    model_only: bool = False


@dataclasses.dataclass(frozen=True)
class IntraBcast(Step):
    """End broadcast of received remote data over the intra ring
    (priced as an AllGather of ``vol``; on the all-border execution
    mapping the intra AllGather doubles as this step)."""
    vol: str = INTRA_SHARD


@dataclasses.dataclass(frozen=True)
class IntraAll2All(Step):
    """Intra-cluster All2All of ``vol`` bytes per rank (the local
    dispatch/redistribute phases of the hierarchical All2All, §5).  The
    ``end`` redistribute moves only the remotely received tokens
    (``REMOTE``) and is ``model_only`` on the all-border execution
    mapping, where every rank already holds its final shard after the
    border exchange."""
    vol: str = FULL
    model_only: bool = False


@dataclasses.dataclass(frozen=True)
class BorderExchange(Step):
    """Cross-cluster pairwise exchange over the border communicators
    (§5): each cluster ships its destination-sorted remote tokens
    straight to the owning cluster's border ranks — every byte crosses
    exactly one border, unlike the copy ring where remote shards transit
    intermediate clusters.  Volume is the Table-7 All2All row
    ((G-N)·n per cluster, n keyed by tokens×hidden×dtype) scaled by
    ``vol_ratio``; ``wire_ratio`` scales the wire bytes (codec)."""
    coll: str = "all_to_all"
    wire_ratio: float = 1.0
    vol_ratio: float = 1.0


@dataclasses.dataclass(frozen=True)
class BorderGather(Step):
    """Fig. 8 bounce: C2C partials land on free offsets of the border
    ranks and take one extra intra-cluster combining hop to their
    target.  Always model-only in execution (the native combining
    collective absorbs it); priced as a ReduceScatter of the cluster's
    Table-7 recv volume spread over its border ranks."""
    coll: str = "all_reduce"


@dataclasses.dataclass(frozen=True)
class C2CRed(Step):
    """Combining cross-cluster exchange of the Table-7 volume for
    ``coll``.  ``wire_ratio`` scales the wire bytes (codec);
    ``vol_ratio`` scales the Table-7 volume (multi-leg exchanges);
    ``scatter=True`` is the border-communicator leg that leaves each
    cluster owning 1/C of the shard (executed as a pod-axis
    ReduceScatter)."""
    coll: str = "all_reduce"
    wire_ratio: float = 1.0
    vol_ratio: float = 1.0
    scatter: bool = False


@dataclasses.dataclass(frozen=True)
class C2CCpy(Step):
    """Non-combining cross-cluster copy of the Table-7 volume.
    ``gather=True`` is the border-communicator leg redistributing the
    owned shards (executed as a pod-axis AllGather); otherwise it is
    the raw-shard pod ring of AllGatherH (`primitives.c2c_cpy`)."""
    coll: str = "all_gather"
    wire_ratio: float = 1.0
    vol_ratio: float = 1.0
    gather: bool = False


@dataclasses.dataclass(frozen=True)
class Compress(Step):
    """Encode the payload into the wire codec before the C2C steps that
    follow (until the matching Decompress).  The executor fuses it into
    the combining exchange (`compression.compressed_psum`, or the
    encode half of the double-buffered chunk loop); the pricer and the
    simulator charge one launch α plus an HBM pass of ``vol`` bytes
    (the post-ReduceScatter shard) through the on-device copy
    bandwidth.  In a pipelined schedule the charge lands in the
    ``codec_s`` pipeline stage, which the chunk loop's double-buffered
    carry hides behind the bottleneck stage
    (``cost_model.CollectiveEstimate.pipelined_s``)."""
    codec: str = "bf16"
    vol: str = INTRA_SHARD


@dataclasses.dataclass(frozen=True)
class Decompress(Step):
    codec: str = "bf16"
    vol: str = INTRA_SHARD


@dataclasses.dataclass(frozen=True)
class Scale(Step):
    """Local pre-scale of the payload by this cluster's gradient weight
    (``CommConfig.cluster_weights`` — the uneven-shard weighted
    reduction of the skew-aware partitioner, DESIGN.md §10).  The weight
    is constant within a cluster, so one pointwise multiply before the
    first combining step makes every downstream reduction a plain
    *intrinsic vendor* collective — no custom weighted reduce-op crosses
    any fabric.  Free for the pricer and the simulator (it is a local
    FLOP, not traffic)."""


@dataclasses.dataclass(frozen=True)
class Pack(Step):
    """Local data-path step writing every gradient leaf into the
    persistent dtype-bucketed comm buffer (``core/packing.py``): a
    scatter of static-offset in-place leaf writes at the pytree
    boundary (zero concatenates).  The executor's pytree entry points
    perform it (the array-level interpreter sees an already-packed
    buffer and treats the step as identity); the pricer and the
    simulator charge one launch α plus one HBM pass of ``vol`` bytes
    through the cluster's on-device copy bandwidth — the cost the
    planner amortizes when choosing bucket granularity (DESIGN.md §11).

    ``wire_ratio`` is the Pack/Compress fusion factor set by
    :func:`with_packing` on codec schedules: the fused pack+quantize
    kernel (``kernels.quant.fused_pack_quant_call``) writes wire-dtype
    blocks straight into the comm buffer, so the pack pass reads the
    full leaves but writes only ``wire_ratio`` of the bytes — priced as
    ``vol · (1 + wire_ratio) / 2`` through the copy bandwidth."""
    vol: str = FULL
    wire_ratio: float = 1.0


@dataclasses.dataclass(frozen=True)
class Unpack(Step):
    """Inverse of :class:`Pack`: static-slice every leaf back out of
    the synced buffer.  Same pricing model as Pack."""
    vol: str = FULL


@dataclasses.dataclass(frozen=True)
class Flat(Step):
    """The non-hierarchical baseline: one native collective spanning
    every data-parallel axis (the homogeneous-library emulation).
    Priced per *mechanism* (host forwarding vs native fabric) by the
    planner, not by the α–β phase pricer."""
    coll: str = "all_reduce"


@dataclasses.dataclass(frozen=True)
class ChunkLoop(Step):
    """Software pipeline (paper §4.3.2, Fig. 9): split the payload into
    ``n_chunks`` and overlap the body's start/c2c/end phases with a
    1-stage skew."""
    n_chunks: int = 1
    body: tuple[Step, ...] = ()


# ---------------------------------------------------------------------------
# Schedule
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Schedule:
    """One decomposition of global collective ``coll`` — the IR value
    the three interpreters share.  ``mode`` is the CommConfig mode
    string that selects it; ``n_chunks``/``compression`` are recorded
    for round-tripping into planner candidates."""

    coll: str
    mode: str
    n_chunks: int
    compression: str | None
    steps: tuple[Step, ...]

    @property
    def pipelined(self) -> bool:
        return any(isinstance(s, ChunkLoop) for s in self.steps)

    def unrolled(self) -> tuple[tuple[Step, ...], int]:
        """(steps with ChunkLoop bodies inlined, chunk count) — the form
        the pricing and simulation interpreters walk."""
        out: list[Step] = []
        k = 1
        for s in self.steps:
            if isinstance(s, ChunkLoop):
                out.extend(s.body)
                k = max(k, s.n_chunks)
            else:
                out.append(s)
        return tuple(out), k


def with_packing(sched: Schedule) -> Schedule:
    """Packed-data-path variant of ``sched``: wrap the steps in one
    :class:`Pack` and one :class:`Unpack`.  A schedule-level wrapper
    like :func:`with_cluster_scale` — the packed layout is a runtime
    value (``core/packing.py``), not schedule structure, so every
    registered mode gains a packed variant with no new builder
    (``tools/check_schedule_cover.py`` asserts exactly that).
    Idempotent; the Pack sits first so its cost lands in the start
    phase, the Unpack last (end phase).

    Pack/Compress fusion: when the schedule carries a wire codec
    (a :class:`Compress` step, possibly inside a ChunkLoop body), the
    Pack gets the codec's wire ratio — the fused pack+quantize kernel
    writes wire-dtype blocks straight into the comm buffer instead of
    staging a full-precision copy (see :class:`Pack`)."""
    if any(isinstance(s, (Pack, Unpack)) for s in sched.steps):
        return sched
    unrolled, _ = sched.unrolled()
    fused_ratio = (CODEC_WIRE_RATIO[sched.compression]
                   if any(isinstance(s, Compress) for s in unrolled)
                   else 1.0)
    return dataclasses.replace(
        sched, steps=(Pack("start", wire_ratio=fused_ratio),) + sched.steps
        + (Unpack("end"),))


def with_cluster_scale(sched: Schedule) -> Schedule:
    """Weighted-reduction variant of ``sched``: prepend the
    :class:`Scale` step.  A schedule-level wrapper rather than a builder
    — the weights themselves are runtime values carried by the
    ``CommConfig``, not schedule structure, so every registered mode
    gains a weighted variant with no new builder (the
    ``tools/check_schedule_cover.py`` skew matrix asserts exactly
    that)."""
    if any(isinstance(s, Scale) for s in sched.steps):
        return sched
    return dataclasses.replace(sched, steps=(Scale("start"),) + sched.steps)


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------

_BUILDERS: dict[str, Callable[..., Schedule]] = {}


def register_builder(mode: str):
    """Register ``fn(coll, n_chunks, compression, topo) -> Schedule`` as
    the decomposition behind CommConfig mode string ``mode``."""
    def deco(fn: Callable[..., Schedule]):
        _BUILDERS[mode] = fn
        return fn
    return deco


def registered_modes() -> tuple[str, ...]:
    return tuple(sorted(_BUILDERS))


def build_schedule(coll: str, mode: str, n_chunks: int = 1,
                   compression: str | None = None, topo=None) -> Schedule:
    """The single entry point every layer resolves decompositions
    through.  ``topo`` is accepted for builders that specialize on the
    topology; the shipped builders emit topology-independent steps with
    symbolic volumes."""
    if mode not in _BUILDERS:
        raise ValueError(
            f"no schedule builder registered for mode {mode!r}; "
            f"known modes: {registered_modes()}")
    if compression not in CODEC_WIRE_RATIO:
        raise ValueError(f"unknown wire codec {compression!r}; "
                         f"known: {tuple(CODEC_WIRE_RATIO)}")
    return _BUILDERS[mode](coll, max(1, int(n_chunks)), compression, topo)


def _wrap_codec(c2c_steps: tuple[Step, ...],
                compression: str | None) -> tuple[Step, ...]:
    if compression is None:
        return c2c_steps
    return (Compress("c2c", compression), *c2c_steps,
            Decompress("c2c", compression))


def _hier_steps(coll: str, compression: str | None) -> tuple[Step, ...]:
    """Algorithm 1 / Table 7: the 3-phase hierarchical decomposition of
    each collective — previously hardwired three separate times in
    collectives.py, cost_model.estimate_hier_collective, and the
    transport-sim stage lists."""
    r = CODEC_WIRE_RATIO[compression]
    if coll == "all_reduce":
        return (IntraReduceScatter("start", FULL),
                *_wrap_codec((C2CRed("c2c", coll, r),), compression),
                BorderGather("end", coll),
                IntraAllGather("end", INTRA_SHARD))
    if coll == "reduce_scatter":
        return (IntraReduceScatter("start", FULL),
                *_wrap_codec((C2CRed("c2c", coll, r),), compression),
                BorderGather("end", coll),
                # general-case end scatter of the received cluster
                # shards; the all-border execution mapping keeps the
                # intra-scattered layout, so this is model-only
                IntraReduceScatter("end", CLUSTER_SHARD, model_only=True))
    if coll == "all_gather":
        return (# general-case intra AllGather before the pod ring; on
                # the all-border mapping the end step doubles as it
                IntraAllGather("start", FULL, model_only=True),
                C2CCpy("c2c", coll, r),
                IntraBcast("end", REMOTE))
    if coll in ("broadcast", "scatter"):
        return (C2CCpy("c2c", coll, r), IntraBcast("end", INTRA_SHARD))
    if coll == "reduce":
        return (BorderGather("start", coll),
                IntraReduceScatter("start", FULL),
                *_wrap_codec((C2CRed("c2c", coll, r),), compression))
    if coll == "gather":
        return (IntraReduceScatter("start", FULL), C2CCpy("c2c", coll, r))
    if coll in ("all_to_all", "send_recv"):
        return (C2CCpy("c2c", coll, r),)
    raise ValueError(f"unknown collective {coll!r}")


@register_builder("flat")
def _build_flat(coll: str, n_chunks: int, compression: str | None,
                topo) -> Schedule:
    # the flat baseline has no DCN-only hop to compress and no chunk
    # pipeline — one native collective over all data-parallel axes
    return Schedule(coll, "flat", 1, None, (Flat("c2c", coll),))


@register_builder("hier")
def _build_hier(coll: str, n_chunks: int, compression: str | None,
                topo) -> Schedule:
    return Schedule(coll, "hier", n_chunks, compression,
                    _hier_steps(coll, compression))


@register_builder("hier_pipelined")
def _build_hier_pipelined(coll: str, n_chunks: int,
                          compression: str | None, topo) -> Schedule:
    body = _hier_steps(coll, compression)
    if n_chunks <= 1:
        return Schedule(coll, "hier_pipelined", 1, compression, body)
    return Schedule(coll, "hier_pipelined", n_chunks, compression,
                    (ChunkLoop("all", n_chunks, body),))


@register_builder("hier_border_rs")
def _build_hier_border_rs(coll: str, n_chunks: int,
                          compression: str | None, topo) -> Schedule:
    """§4.3 border-communicator ReduceScatter schedule for the global
    all-reduce: intra-RS, then a border-only C2C exchange — a combining
    reduce-scatter over the cluster ring (each cluster ends owning 1/C
    of the shard, the volume split proportionally over its border NICs)
    followed by the copy ring redistributing the owned shards — then the
    intra AllGather of the owned shard.  Against plain ``hier`` this
    pays one extra exchange α but the incoming partials are combined by
    the owning cluster's *native* collective — no Fig. 8 bounce hop, the
    term that dominates ``hier``'s end phase on border-scarce clusters
    (e.g. paper_testbed's vendor1: 2 NICs for 32 ranks)."""
    if coll != "all_reduce":
        # the border exchange is defined for the gradient all-reduce;
        # other collectives keep the plain hier decomposition so the
        # mode string stays usable end to end (e.g. the ZeRO-1
        # reduce_scatter path of a border-mode CommConfig)
        return Schedule(coll, "hier_border_rs", 1, compression,
                        _hier_steps(coll, compression))
    if compression == "int8":
        raise ValueError(
            "hier_border_rs supports only lossless/bf16 wire codecs: the "
            "int8 ring accumulator does not compose with the border "
            "reduce-scatter exchange")
    r = CODEC_WIRE_RATIO[compression]
    steps = (IntraReduceScatter("start", FULL),
             *_wrap_codec((
                 # Table-7 all_reduce volume 2n(C-1)/C splits evenly
                 # over the two border legs
                 C2CRed("c2c", coll, r, vol_ratio=0.5, scatter=True),
                 C2CCpy("c2c", coll, r, vol_ratio=0.5, gather=True),
             ), compression),
             IntraAllGather("end", INTRA_SHARD))
    return Schedule(coll, "hier_border_rs", 1, compression, steps)


@register_builder("hier_a2a")
def _build_hier_a2a(coll: str, n_chunks: int,
                    compression: str | None, topo) -> Schedule:
    """§5 hierarchical All2All: intra-a2a sorts each rank's tokens into
    per-destination-cluster contiguous blocks on the border ranks, the
    border communicators exchange each block pairwise with its owning
    cluster (one border crossing per byte — the optimal cross-cluster
    volume), and a final intra-a2a redistributes the received remote
    tokens to their destination ranks.  Against ``flat_a2a`` this pays
    two local exchanges but halves the border traffic: the copy ring
    drains every remote byte through intermediate clusters (vol_ratio
    1.0 of the Table-7 row) while the pairwise exchange ships it direct
    (vol_ratio 0.5 — a conservative C/2 bound on the ring-transit
    multiplier)."""
    if coll != "all_to_all":
        # the pairwise border exchange is defined for All2All; other
        # collectives keep the plain hier decomposition so the mode
        # string stays usable end to end (e.g. the gradient all-reduce
        # of a CommConfig whose MoE layers run hier_a2a)
        return Schedule(coll, "hier_a2a", 1, compression,
                        _hier_steps(coll, compression))
    if compression == "int8":
        raise ValueError(
            "hier_a2a supports only lossless/bf16 wire codecs: token "
            "activations have no error-feedback step to absorb the int8 "
            "block quantization")
    r = CODEC_WIRE_RATIO[compression]
    body = (IntraAll2All("start", FULL),
            *_wrap_codec((BorderExchange("c2c", coll, r, vol_ratio=0.5),),
                         compression),
            # redistribute only the remotely received tokens; on the
            # all-border mapping the pairwise exchange already lands
            # them on their destination ranks
            IntraAll2All("end", REMOTE, model_only=True))
    if n_chunks <= 1:
        return Schedule(coll, "hier_a2a", 1, compression, body)
    return Schedule(coll, "hier_a2a", n_chunks, compression,
                    (ChunkLoop("all", n_chunks, body),))


@register_builder("flat_a2a")
def _build_flat_a2a(coll: str, n_chunks: int,
                    compression: str | None, topo) -> Schedule:
    """Reference flat All2All: one global exchange whose remote bytes
    drain around the cluster copy ring (vol_ratio 1.0 of the Table-7
    row) — the baseline ``hier_a2a`` halves.  Emitted as a
    :class:`BorderExchange` rather than a :class:`Flat` step so the α–β
    pricer and the event sim charge it through the same Table-7 volume
    path as ``hier_a2a`` (like-for-like cross-cluster byte accounting).
    Like ``flat``, it takes no wire codec and no chunk pipeline."""
    if coll != "all_to_all":
        return Schedule(coll, "flat_a2a", 1, None, (Flat("c2c", coll),))
    return Schedule(coll, "flat_a2a", 1, None,
                    (BorderExchange("c2c", coll, 1.0, vol_ratio=1.0),))
