"""Cost-model-driven communication planner (paper §4.4; DESIGN.md §6).

The hierarchical schedule only pays off when the chunk count, the
pipelining mode, and the balanced-subgroup split are chosen per topology
and payload size — hand-tuning ``CommConfig`` flags per cell does not
scale past a handful of shapes.  This module turns the two existing
models into a decision procedure:

  * the closed-form α–β model (``cost_model.estimate_hier_collective``)
    *scores* every candidate schedule — cheap enough to enumerate the
    full search space per gradient bucket;
  * the discrete-event transport simulator
    (``transport_sim.simulate_c2c_cpy``) *cross-validates* the winning
    candidates — a candidate whose modeled C2C time diverges from the
    event-driven time by more than ``tol`` is refused and the search
    falls through to the next-best schedule.  This guards against the
    closed form being trusted exactly where it is least accurate (the
    α-dominated small-payload regime, where per-chunk WR posting and
    buffer-pool back-pressure are invisible to α–β).

Search space per bucket: the planner enumerates *schedules* — every
decomposition `core.schedule` can build from the §4.4 knobs:

    mode         ∈ {flat, hier, hier_pipelined, hier_border_rs}
    n_chunks     ∈ {1..max_chunks}           (hier_pipelined only)
    compression  ∈ {None, bf16, int8}        (DCN hop only;
                                              border takes None/bf16)
    topology     ∈ {as-given, balanced_subgroups()}

A new mode registered in ``core.schedule`` joins the search with no
planner change: its schedule is priced by ``cost_model.estimate_schedule``
and cross-validated like every other candidate.

The planner returns a ``CommPlan``: one chosen ``CommConfig`` per
gradient bucket plus the predicted and simulated times that justified
it.  ``CommPlan`` duck-types as a ``CommConfig`` provider
(``config_for(nbytes)``), so the collectives layer resolves the right
schedule per bucket with no import cycle (see
``collectives.resolve_config``).

With ``backward_compute_s`` given, the objective switches from total to
*exposed* comm time: the readiness-ordered buckets (``core.overlap``)
are scheduled on a serial comm channel against the backward-compute
timeline, only the part sticking out past the end of backward counts,
and the plan carries the resulting ``OverlapReport`` (DESIGN.md §8).

Units follow cost_model conventions: payload sizes in **bytes per
rank**, bandwidths in **bytes/second**, times in **seconds**.

The PyTorch port copies the JAX package's planner with one seam: the
reference's ``CommPlan.config_for`` builds a ``CommConfig`` on mesh axis
names, while the port's ``CommConfig`` holds process groups.  The plan
stays group-free here (it is pickled by the plan cache and compared with
the reference's), and ``BoundPlan.of(plan, rt)`` is the view on one
process's groups that the collectives resolve per bucket.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Sequence

from . import cost_model, transport_sim
from . import schedule as schedule_ir
from .collectives import CommConfig
from .plan_cache import PlanCache
from .topology import HetTopology

# Wire-byte ratio of each DCN codec relative to the f32 payload — the
# IR owns the table (int8: one byte per element plus one f32 scale per
# 1024-element compression._CHUNK block); kept under the old name for
# callers that imported it from here.
_CODEC_WIRE_RATIO = schedule_ir.CODEC_WIRE_RATIO


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the search space (topology choice tracked on the
    plan): the (mode, n_chunks, compression) key of a schedule the IR
    can rebuild on demand via ``schedule()``."""

    mode: str                      # any registered schedule-builder mode
    n_chunks: int = 1
    compression: str | None = None

    @classmethod
    def of(cls, sched: schedule_ir.Schedule) -> "Candidate":
        return cls(sched.mode, sched.n_chunks, sched.compression)

    def schedule(self, coll: str) -> schedule_ir.Schedule:
        return schedule_ir.build_schedule(coll, self.mode, self.n_chunks,
                                          self.compression)


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """The chosen schedule for one gradient bucket.

    ``predicted_c2c_s`` is the closed-form k=1 drain of the schedule's
    C2C wire volume; ``simulated_c2c_s`` is the event-driven time for
    the same transfer (same mechanism, same bytes); ``divergence`` is
    their relative gap.  ``validated`` is False only when *every*
    candidate's transfer diverged beyond tolerance and the planner fell
    back to the least-divergent one.
    """

    nbytes: int                    # per-rank payload, bytes
    candidate: Candidate
    predicted_s: float             # full 3-phase time, seconds
    predicted_c2c_s: float
    simulated_c2c_s: float
    validated: bool

    @property
    def divergence(self) -> float:
        if self.simulated_c2c_s <= 0.0:
            return 0.0
        return abs(self.predicted_c2c_s - self.simulated_c2c_s) / self.simulated_c2c_s


@dataclasses.dataclass(frozen=True)
class OverlapBucket:
    """Timeline of one bucket's sync against the backward pass.

    ``ready_s`` is when the backward compute has produced this bucket's
    gradients; ``start_s``/``end_s`` are the sync's slot on the (serial)
    comm channel; ``exposed_s`` is this bucket's contribution to the
    time sticking out past the end of the backward pass."""

    nbytes: int
    ready_s: float
    start_s: float
    end_s: float
    comm_s: float
    exposed_s: float


@dataclasses.dataclass(frozen=True)
class OverlapReport:
    """Exposed-vs-total accounting for a readiness-ordered bucket
    schedule overlapped with backward compute (core/overlap.py).

    ``monolithic_comm_s`` prices the alternative the chain must beat:
    the whole volume synced as one collective (which can never start
    before backward ends, so its exposure is its full time)."""

    backward_compute_s: float
    total_comm_s: float
    exposed_comm_s: float
    buckets: tuple[OverlapBucket, ...]
    monolithic_comm_s: float = 0.0

    @property
    def hidden_frac(self) -> float:
        if self.total_comm_s <= 0.0:
            return 0.0
        # exposed accumulates in a different order than total; clamp the
        # ±1-ulp noise of the fully-exposed case
        return max(0.0, 1.0 - self.exposed_comm_s / self.total_comm_s)

    def summary(self) -> dict:
        return {
            "backward_compute_s": self.backward_compute_s,
            "total_comm_s": self.total_comm_s,
            "exposed_comm_s": self.exposed_comm_s,
            "monolithic_comm_s": self.monolithic_comm_s,
            "hidden_frac": round(self.hidden_frac, 4),
            "buckets": [
                {"nbytes": b.nbytes, "ready_s": b.ready_s,
                 "start_s": b.start_s, "end_s": b.end_s,
                 "comm_s": b.comm_s, "exposed_s": b.exposed_s}
                for b in self.buckets],
        }


@dataclasses.dataclass(frozen=True)
class CommPlan:
    """Per-bucket communication schedule for one topology.

    Duck-types as a per-bucket ``CommConfig`` provider: anything with a
    ``config_for(nbytes)`` method is accepted by the collectives layer
    (``collectives.resolve_config``), so a ``CommPlan`` can be passed
    wherever a ``CommConfig`` is expected by ``tree_hier_psum`` /
    ``tree_hier_psum_scatter`` and each dtype bucket picks its own
    schedule by flat-buffer size.

    When planned with ``backward_compute_s`` the buckets are in
    *readiness order* (``bucket_order`` is the execution order over
    ``buckets``) and ``overlap`` carries the exposed-time report the
    schedule was optimized for.

    When planned with ``skew=`` (a ``core.skew.SkewSplit``) the plan
    carries the uneven batch split it was scored under: ``compute_s``
    holds the per-cluster compute times, ``predicted_straggler_s`` is
    the straggler objective the candidates were ranked by, and
    ``cluster_weights`` are the per-pod gradient weights every emitted
    ``CommConfig`` threads into the weighted reduction (DESIGN.md §10).
    """

    topology: HetTopology          # the topology the times were priced on
    balanced: bool                 # True if balanced_subgroups() won
    coll: str
    pod_axis: str | None
    intra_axis: str
    buckets: tuple[BucketPlan, ...]
    bucket_order: tuple[int, ...] = ()
    overlap: OverlapReport | None = None
    skew: Any = None               # core.skew.SkewSplit (duck-typed)
    compute_s: tuple[float, ...] = ()
    cluster_weights: tuple[float, ...] | None = None
    # Data-path decision (plan(packed=True, n_leaves=...)): "packed"
    # unless the modeled pack+unpack overhead exceeds what packing saves
    # over syncing the n_leaves tree leaves individually — then
    # "per_leaf" and the launcher must run the unpacked tree sync.
    data_path: str = "packed"
    per_leaf_s: float | None = None   # predicted per-leaf alternative, s
    # The *reason* behind ``validated``: which event-sim level
    # cross-validated this plan — "device_sim" (per-border-rank event
    # queues) or "cluster_sim" (the cluster-aggregated queues large
    # topologies downgrade to, DESIGN.md §14).  Never "skipped":
    # plan() always cross-validates, downgrading instead of disabling.
    validated_via: str = "device_sim"

    @property
    def dp_axes(self) -> tuple[str, ...]:
        """Mirror of CommConfig.dp_axes so a plan can stand in for a
        config in axis-size bookkeeping (e.g. tree_hier_psum_mean)."""
        return ((self.pod_axis,) if self.pod_axis else ()) + (self.intra_axis,)

    @property
    def predicted_step_s(self) -> float:
        """Sum of per-bucket predicted times (buckets sync sequentially)."""
        return sum(b.predicted_s for b in self.buckets)

    @property
    def exposed_comm_s(self) -> float:
        """Comm time not hidden behind backward compute.  Without an
        overlap report nothing is hidden — the whole sequential sync is
        exposed."""
        if self.overlap is not None:
            return self.overlap.exposed_comm_s
        return self.predicted_step_s

    @property
    def predicted_straggler_s(self) -> float:
        """The skew objective ``max_c(compute_c) + exposed comm``
        (cost_model.straggler_step_time with this plan's comm term);
        without per-cluster compute times it degenerates to the exposed
        comm time alone."""
        comp = max(self.compute_s) if self.compute_s else 0.0
        return comp + self.exposed_comm_s

    @property
    def validated(self) -> bool:
        return all(b.validated for b in self.buckets)

    def recommended_mode(self) -> str:
        """The ``TrainConfig.comm_mode`` this plan asks for: the chained
        bucket executor when its exposed time beats both the sequential
        bucket sync AND the monolithic single-collective alternative
        (the chain pays one α set per bucket — with a short backward
        pass that overhead can exceed what overlapping saves), else the
        biggest bucket's schedule mode."""
        if self.overlap is not None and len(self.buckets) > 1:
            bar = self.overlap.total_comm_s
            if self.overlap.monolithic_comm_s > 0.0:
                bar = min(bar, self.overlap.monolithic_comm_s)
            if self.overlap.exposed_comm_s < bar * (1.0 - 1e-6):
                return "hier_overlap"
        return max(self.buckets, key=lambda b: b.nbytes).candidate.mode

    def bucket_for(self, nbytes: int) -> BucketPlan:
        """Nearest planned bucket by log-size distance (gradient buckets
        arrive at slightly different sizes than planned: padding,
        dtype-bucket aggregation)."""
        if not self.buckets:
            raise ValueError("empty plan")
        n = max(1, int(nbytes))
        return min(self.buckets,
                   key=lambda b: abs(math.log(max(1, b.nbytes)) - math.log(n)))

    def config_for(self, nbytes: int) -> CommConfig:
        # the plan names mesh axes; a CommConfig holds process groups
        raise TypeError("a CommPlan holds no process groups: bind it to a "
                        "Runtime first (planner.BoundPlan.of(plan, rt))")

    def summary(self) -> dict:
        """JSON-serializable description (dryrun/hillclimb result logs)."""
        return {
            "balanced": self.balanced,
            "coll": self.coll,
            "predicted_step_s": self.predicted_step_s,
            "exposed_comm_s": self.exposed_comm_s,
            "recommended_mode": self.recommended_mode(),
            "data_path": self.data_path,
            "per_leaf_s": self.per_leaf_s,
            "bucket_order": list(self.bucket_order),
            "overlap": (self.overlap.summary()
                        if self.overlap is not None else None),
            "validated": self.validated,
            "validated_via": self.validated_via,
            "n_clusters": self.topology.n_clusters,
            "skew": (None if not self.compute_s else {
                "microbatches": (list(self.skew.microbatches)
                                 if self.skew is not None else None),
                "cluster_weights": (list(self.cluster_weights)
                                    if self.cluster_weights else None),
                "compute_s": list(self.compute_s),
                "predicted_straggler_s": self.predicted_straggler_s,
            }),
            "buckets": [
                {"nbytes": b.nbytes, "mode": b.candidate.mode,
                 "n_chunks": b.candidate.n_chunks,
                 "compression": b.candidate.compression,
                 "predicted_s": b.predicted_s,
                 "predicted_c2c_s": b.predicted_c2c_s,
                 "simulated_c2c_s": b.simulated_c2c_s,
                 "divergence": round(b.divergence, 4),
                 "validated": b.validated}
                for b in self.buckets],
        }

    def describe(self) -> str:
        """Human-readable per-bucket table (what ``launch/dryrun --plan
        auto`` prints instead of the raw summary dict): one row per
        bucket in execution order with the chosen schedule and the
        predicted vs event-simulated times that justified it."""
        head = (f"CommPlan[{self.coll}] over {self.topology.n_clusters} "
                f"cluster(s){' (balanced subgroups)' if self.balanced else ''}"
                f" — recommended mode: {self.recommended_mode()}, predicted "
                f"{self.predicted_step_s * 1e3:.2f} ms/sync"
                + ("" if self.validated_via == "device_sim"
                   else f"  [{self.validated_via}]")
                + ("" if self.validated else "  [NOT fully validated]"))
        cols = (f"{'bucket':>6}  {'MiB':>9}  {'mode':<15} {'chunks':>6}  "
                f"{'codec':<5}  {'pred ms':>9}  {'pred c2c':>9}  "
                f"{'sim c2c':>9}  ok")
        lines = [head, cols, "-" * len(cols)]
        order = self.bucket_order or tuple(range(len(self.buckets)))
        for i in order:
            b = self.buckets[i]
            c = b.candidate
            lines.append(
                f"{i:>6}  {b.nbytes / (1 << 20):>9.2f}  {c.mode:<15} "
                f"{c.n_chunks:>6}  {str(c.compression or '-'):<5}  "
                f"{b.predicted_s * 1e3:>9.3f}  "
                f"{b.predicted_c2c_s * 1e3:>9.3f}  "
                f"{b.simulated_c2c_s * 1e3:>9.3f}  "
                f"{'y' if b.validated else 'N'}")
        if self.overlap is not None:
            o = self.overlap
            lines.append(
                f"overlap: backward {o.backward_compute_s * 1e3:.2f} ms, "
                f"total comm {o.total_comm_s * 1e3:.2f} ms, exposed "
                f"{o.exposed_comm_s * 1e3:.2f} ms "
                f"({o.hidden_frac * 100:.0f}% hidden)")
        if self.compute_s:
            mbs = (self.skew.describe() if self.skew is not None else "-")
            comp = "/".join(f"{c * 1e3:.1f}" for c in self.compute_s)
            lines.append(
                f"skew: microbatches {mbs}, compute {comp} ms/cluster, "
                f"straggler step {self.predicted_straggler_s * 1e3:.2f} ms")
        if self.per_leaf_s is not None:
            if self.data_path == "per_leaf":
                lines.append(
                    f"data path: PER-LEAF fallback — modeled pack overhead "
                    f"exceeds the per-message alpha saving "
                    f"(serial per-leaf bound {self.per_leaf_s * 1e3:.2f} "
                    f"ms/sync, packed {self.predicted_step_s * 1e3:.2f} ms)")
            else:
                lines.append(
                    f"data path: packed (serial per-leaf bound "
                    f"{self.per_leaf_s * 1e3:.2f} ms/sync)")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Candidate pricing
# ---------------------------------------------------------------------------

def _hetccl_alpha(topo: HetTopology) -> float:
    return max(c.alpha_hetccl_s for c in topo.clusters)


def _price_schedule(topo: HetTopology, sched: schedule_ir.Schedule,
                    nbytes: int,
                    flat_mechanism: str = "host",
                    packed: bool = False) -> tuple[float, float]:
    """(full seconds, C2C leg seconds) of one candidate schedule.
    Hierarchical schedules are priced step by step by the IR's pricing
    interpreter (codec wire ratios and multi-leg exchanges ride the
    steps themselves); flat schedules are priced per mechanism.

    With ``packed`` the schedule is priced through its packed-data-path
    variant (``schedule.with_packing``): one Pack in the start phase,
    one Unpack in the end phase — every candidate pays the same
    per-sync packing cost (flat included), so the planner's *relative*
    ranking within a bucket is codec/pipeline-driven while bucket-count
    decisions (overlap vs monolithic) see the per-bucket pack α it must
    amortize."""
    if any(isinstance(s, schedule_ir.Flat) for s in sched.steps):
        t, c2c = _price_flat(topo, sched.coll, nbytes, flat_mechanism)
        if packed:
            t += cost_model.packed_overhead_time(topo, nbytes)
        return t, c2c
    if packed:
        sched = schedule_ir.with_packing(sched)
    est = cost_model.estimate_schedule(topo, sched, nbytes)
    t = est.pipelined_s if sched.pipelined else est.sequential_s
    return t, est.c2c_s


def _price_hier(topo: HetTopology, coll: str, nbytes: int,
                n_chunks: int, compression: str | None,
                pipelined: bool) -> tuple[float, float]:
    """(full 3-phase seconds, C2C leg seconds) for a hier/hier_pipelined
    candidate.  Compression shrinks only the DCN wire bytes — the
    lossless ICI phases are priced on the full payload."""
    mode = "hier_pipelined" if pipelined else "hier"
    sched = schedule_ir.build_schedule(coll, mode, n_chunks, compression)
    return _price_schedule(topo, sched, nbytes)


def _price_flat(topo: HetTopology, coll: str, nbytes: int,
                mechanism: str) -> tuple[float, float]:
    """(full seconds, C2C leg seconds) for the flat baseline.

    mechanism='host': Gloo-style CPU forwarding (the only flat option
    across vendors, Fig. 2(b)).  mechanism='native': a flat collective
    over one uniform fabric (the TPU multi-pod DCN case) — priced as
    the Table-7 border volume draining through each cluster's NICs at
    native latency.
    """
    if topo.n_clusters <= 1:
        c = topo.clusters[0]
        if coll == "all_reduce":
            t = cost_model.ring_all_reduce_time(c, nbytes)
        elif coll == "all_gather":
            t = cost_model.ring_all_gather_time(c, nbytes)
        else:
            t = cost_model.ring_reduce_scatter_time(c, nbytes)
        return t, 0.0
    if mechanism == "native":
        alpha = max(c.alpha_native_s for c in topo.clusters)
        # folded walks: exact for the root-free collectives priced here
        # (cost_model._fold_cluster_indices), and the flat candidate is
        # priced identically by the vectorized and scalar planner paths
        c2c = cost_model.c2c_step_time(topo, coll, nbytes, alpha, 1,
                                       fold=True)
        est = cost_model.estimate_hier_collective(topo, coll, nbytes, 1,
                                                  fold=True)
        return est.start_s + c2c + est.end_s, c2c
    full = cost_model.flat_host_forwarding_time(topo, coll, nbytes)
    # the host C2C leg alone (mirrors flat_host_forwarding_time's inner loop)
    c2c = 0.0
    for ci, c in enumerate(topo.clusters):
        send, recv = cost_model.c2c_volume(coll, nbytes, topo, ci)
        vol = max(send, recv)
        c2c = max(c2c, vol / c.cross_Bps + max(c.alpha_host_s, 0.0)
                  + vol / c.h2d_Bps * 2.0)
    return full, c2c


# ---------------------------------------------------------------------------
# Event-driven cross-validation
# ---------------------------------------------------------------------------

# Above this rank count plan(sim_level="auto") downgrades the
# cross-validation from per-border-rank event queues to the
# cluster-aggregated simulator: the device-level sim walks every border
# pair (256 per pod pair on a TPU multipod), which is O(n_ranks) per
# validated transfer and dominates plan() wall-clock past a few hundred
# devices, while the cluster level is exact for the symmetric intra
# phases (transport_sim.simulate_schedule docstring) and prices ≤2
# distinct NIC shares per pair instead of all of them.
_DEVICE_SIM_MAX_RANKS = 512


def _resolve_sim_level(topo: HetTopology, sim_level: str) -> str:
    """'auto' picks the per-device event sim up to
    ``_DEVICE_SIM_MAX_RANKS`` total ranks and the cluster-aggregated sim
    beyond; explicit 'device'/'cluster' are honored as given."""
    if sim_level == "auto":
        return "device" if topo.n_ranks <= _DEVICE_SIM_MAX_RANKS else "cluster"
    if sim_level not in ("device", "cluster"):
        raise ValueError(f"unknown sim_level: {sim_level!r}")
    return sim_level


def _simulate_c2c(topo: HetTopology, coll: str, wire_nbytes: int,
                  mechanism: str, chunk_bytes: int,
                  _cache: dict | None = None,
                  level: str = "device") -> float:
    """Event-driven time of the synchronous C2C step: each cluster
    drains its Table-7 border volume to its ring successor through
    ``simulate_c2c_cpy``; the step ends when the slowest cluster does
    (the same completion rule as ``cost_model.c2c_step_time``).

    ``level='cluster'`` folds the ring walk over symmetry: two ring
    edges whose (cluster, successor) fingerprints match are identical
    exchanges (c2c_volume depends only on per-cluster NIC capacity, and
    the pair simulation only on the two endpoint specs), so each
    distinct fingerprint pair is simulated once and the per-pair
    simulation itself dedups its identical NIC-share pipelines — exact,
    not approximate, per DESIGN.md §14.  The memo key is the topology
    *fingerprint* (not ``id()``), so fingerprint-equal topologies share
    entries and recycled ids can never alias stale times."""
    key = (topo.fingerprint(), coll, wire_nbytes, mechanism, level)
    if _cache is not None and key in _cache:
        return _cache[key]
    C = topo.n_clusters
    folded = level == "cluster"
    seen_pairs: set[tuple] = set()
    t = 0.0
    for ci, c in enumerate(topo.clusters):
        nxt = topo.clusters[(ci + 1) % C]
        if folded:
            pair = (c.fingerprint(), nxt.fingerprint())
            if pair in seen_pairs:
                continue
            seen_pairs.add(pair)
        send, recv = cost_model.c2c_volume(coll, wire_nbytes, topo, ci)
        vol = max(send, recv)
        if vol == 0:
            continue
        t = max(t, transport_sim.simulate_c2c_cpy(c, nxt, vol, mechanism,
                                                  chunk_bytes, level=level))
    if _cache is not None:
        _cache[key] = t
    return t


# ---------------------------------------------------------------------------
# The planner
# ---------------------------------------------------------------------------

def _chunk_candidates(max_chunks: int) -> tuple[int, ...]:
    """1..max_chunks, thinned to powers of two plus midpoints above 8 —
    the pipelined-time landscape is unimodal and flat near the optimum
    (Fig. 9), so the thinning loses nothing measurable."""
    ks = sorted({k for k in range(1, max_chunks + 1)
                 if k <= 8 or k % 4 == 0})
    return tuple(ks)


def _candidate_schedules(coll: str, max_chunks: int,
                         compressions) -> list[schedule_ir.Schedule]:
    """Every schedule the planner searches for one bucket: the flat
    baseline plus, per wire codec, the sequential hier decomposition,
    the §4.3 border-communicator exchange (all_reduce; lossless/bf16
    wire only), and the chunk-pipelined family.  All2All buckets (the
    MoE dispatch/combine payload) search their own family instead: the
    flat native baseline, the ``flat_a2a`` reference (one global
    exchange, priced through the same Table-7 volume path as the
    hierarchical schedule), and the §5 ``hier_a2a`` decomposition per
    lossless/bf16 codec, chunk-pipelined.

    The grid is deduplicated structurally before pricing: candidates
    whose ``(coll, steps)`` tuples are equal price identically on every
    topology (the step tuple is everything the interpreters see), so
    only the first is kept — e.g. ``hier_pipelined`` at k=1 emits the
    same steps as ``hier`` and is dropped, one per codec.  Keeping the
    first occurrence matches the scalar oracle's stable tie-break.
    Memoized: the grid depends only on ``(coll, max_chunks,
    compressions)`` and is re-enumerated per bucket otherwise."""
    return list(_candidate_schedules_cached(coll, int(max_chunks),
                                            tuple(compressions)))


@functools.lru_cache(maxsize=128)
def _candidate_schedules_cached(
        coll: str, max_chunks: int,
        compressions: tuple) -> tuple[schedule_ir.Schedule, ...]:
    if coll == "all_to_all":
        out = [schedule_ir.build_schedule(coll, "flat"),
               schedule_ir.build_schedule(coll, "flat_a2a")]
        for comp in compressions:
            if comp == "int8":
                continue  # token activations take no error feedback
            for k in _chunk_candidates(max_chunks):
                out.append(schedule_ir.build_schedule(coll, "hier_a2a",
                                                      k, comp))
        return _dedup_structural(out)
    out = [schedule_ir.build_schedule(coll, "flat")]
    for comp in compressions:
        out.append(schedule_ir.build_schedule(coll, "hier", 1, comp))
        if coll == "all_reduce" and comp != "int8":
            out.append(schedule_ir.build_schedule(coll, "hier_border_rs",
                                                  1, comp))
        for k in _chunk_candidates(max_chunks):
            out.append(schedule_ir.build_schedule(coll, "hier_pipelined",
                                                  k, comp))
    return _dedup_structural(out)


def _dedup_structural(
        scheds: list[schedule_ir.Schedule]
) -> tuple[schedule_ir.Schedule, ...]:
    seen: set[tuple] = set()
    out = []
    for s in scheds:
        key = (s.coll, s.steps)
        if key in seen:
            continue
        seen.add(key)
        out.append(s)
    return tuple(out)


_COMP_RANK = {None: 0, "bf16": 1, "int8": 2}   # wire-codec aggressiveness


def _transfer_leg(cand: Candidate, nbytes: int,
                  flat_mechanism: str) -> tuple[str, int]:
    """(mechanism, wire bytes) of the candidate's C2C transfer — the
    quantity the event simulator can actually check.  Validation is
    schedule-independent: it prices the k=1 drain of the same volume,
    so the α–β *transfer* model is what gets cross-checked, not the
    phase-pipelining α bookkeeping (which the byte-chunked simulator
    has no notion of)."""
    if cand.mode == "flat":
        return ("native" if flat_mechanism == "native" else "host", nbytes)
    return "hetccl", max(1, int(nbytes * _CODEC_WIRE_RATIO[cand.compression]))


def _model_leg(topo: HetTopology, coll: str, mech: str, wire: int) -> float:
    if mech == "host":
        return _price_flat(topo, coll, wire, "host")[1]
    alpha = (max(c.alpha_native_s for c in topo.clusters)
             if mech == "native" else _hetccl_alpha(topo))
    return cost_model.c2c_step_time(topo, coll, wire, alpha, 1, fold=True)


def _price_candidates(topo: HetTopology, coll: str, nbytes: int,
                      max_chunks: int, compressions,
                      flat_mechanism: str,
                      packed: bool = False,
                      vectorized: bool = True) -> list[tuple[float, Candidate]]:
    """Price the full candidate grid for one bucket.

    ``vectorized=True`` (default) routes every non-flat candidate
    through ``cost_model.price_schedule_grid`` — one batched numpy
    evaluation over the (mode × chunks × codec) grid with symmetry
    folding over ``topo.fold_groups()`` — instead of one
    ``estimate_schedule`` Python loop per candidate.  The grid path
    replicates the scalar path's IEEE operation order exactly, so the
    two modes return bit-identical prices (differentially tested in
    tests/test_planner.py); ``vectorized=False`` is kept as the oracle.
    Flat candidates (1–2 per grid) are priced scalar in both modes —
    their mechanism-specific pricing is O(n_clusters) and does not
    belong in the α–β grid."""
    scheds = _candidate_schedules(coll, max_chunks, compressions)
    if not vectorized:
        priced: list[tuple[float, Candidate]] = []
        for sched in scheds:
            t, _ = _price_schedule(topo, sched, nbytes, flat_mechanism,
                                   packed=packed)
            priced.append((t, Candidate.of(sched)))
        return priced
    out: list[tuple[float, Candidate] | None] = [None] * len(scheds)
    grid_idx: list[int] = []
    grid_scheds: list[schedule_ir.Schedule] = []
    pack_extra = (cost_model.packed_overhead_time(topo, nbytes)
                  if packed else 0.0)
    for i, sched in enumerate(scheds):
        if any(isinstance(s, schedule_ir.Flat) for s in sched.steps):
            t, _ = _price_flat(topo, sched.coll, nbytes, flat_mechanism)
            out[i] = (t + pack_extra, Candidate.of(sched))
        else:
            grid_idx.append(i)
            grid_scheds.append(schedule_ir.with_packing(sched) if packed
                               else sched)
    if grid_scheds:
        grid = cost_model.price_schedule_grid(topo, grid_scheds, nbytes)
        for i, sched, (t, _c2c) in zip(grid_idx,
                                       (scheds[j] for j in grid_idx), grid):
            # Candidate.of the ORIGINAL schedule — with_packing preserves
            # (mode, n_chunks, compression) but the original is what the
            # scalar path hands to Candidate.of too
            out[i] = (t, Candidate.of(sched))
    return [p for p in out if p is not None]


def _first_validated(topo: HetTopology, coll: str, nbytes: int,
                     ranked: list[tuple[float, Candidate]], tol: float,
                     flat_mechanism: str, chunk_bytes: int,
                     _sim_cache: dict | None,
                     sim_level: str = "device") -> BucketPlan:
    """Walk candidates in rank order, cross-validating each against the
    event simulator; the first within ``tol`` wins.  If none agrees
    (e.g. an α-dominated tiny bucket), the least-divergent candidate is
    returned with ``validated=False`` so callers can see the model was
    out of its depth."""
    fallback: BucketPlan | None = None
    for t, cand in ranked:
        mech, wire = _transfer_leg(cand, nbytes, flat_mechanism)
        c2c = _model_leg(topo, coll, mech, wire)
        sim = _simulate_c2c(topo, coll, wire, mech, chunk_bytes, _sim_cache,
                            level=sim_level)
        bp = BucketPlan(nbytes, cand, t, c2c, sim,
                        validated=(sim <= 0.0
                                   or abs(c2c - sim) / sim <= tol))
        if bp.validated:
            return bp
        if fallback is None or bp.divergence < fallback.divergence:
            fallback = bp
    assert fallback is not None
    return fallback


def plan_bucket(topo: HetTopology, coll: str, nbytes: int, *,
                max_chunks: int = 32,
                compressions=(None, "bf16", "int8"),
                tol: float = 0.25,
                flat_mechanism: str = "host",
                chunk_bytes: int = 4 << 20,
                packed: bool = False,
                vectorized: bool = True,
                sim_level: str = "auto",
                _sim_cache: dict | None = None) -> BucketPlan:
    """Choose the best validated schedule for one bucket on one topology
    (sequential objective: minimize the bucket's own sync time)."""
    level = _resolve_sim_level(topo, sim_level)
    priced = _price_candidates(topo, coll, nbytes, max_chunks, compressions,
                               flat_mechanism, packed=packed,
                               vectorized=vectorized)
    priced.sort(key=lambda x: x[0])
    return _first_validated(topo, coll, nbytes, priced, tol, flat_mechanism,
                            chunk_bytes, _sim_cache, sim_level=level)


def plan_bucket_overlap(topo: HetTopology, coll: str, nbytes: int, *,
                        ready_s: float, free_s: float, backward_s: float,
                        max_chunks: int = 32,
                        compressions=(None, "bf16", "int8"),
                        tol: float = 0.25,
                        flat_mechanism: str = "host",
                        chunk_bytes: int = 4 << 20,
                        packed: bool = False,
                        vectorized: bool = True,
                        sim_level: str = "auto",
                        _sim_cache: dict | None = None) -> BucketPlan:
    """Choose the schedule minimizing the bucket's *exposed* time.

    The bucket's sync occupies the serial comm channel from
    ``max(ready_s, free_s)``; its exposure is however much of that slot
    sticks out past the backward pass.  Among candidates that are fully
    hidden the ranking prefers the least aggressive wire codec (a lossy
    codec buys nothing when the comm is already free) and then the
    shortest occupancy, which frees the channel for later buckets.
    """
    level = _resolve_sim_level(topo, sim_level)
    start = max(ready_s, free_s)
    prev_exposed = max(0.0, free_s - backward_s)

    def key(tc):
        t, cand = tc
        inc = max(0.0, start + t - backward_s) - prev_exposed
        return (inc, _COMP_RANK[cand.compression], t)

    priced = _price_candidates(topo, coll, nbytes, max_chunks, compressions,
                               flat_mechanism, packed=packed,
                               vectorized=vectorized)
    priced.sort(key=key)
    return _first_validated(topo, coll, nbytes, priced, tol, flat_mechanism,
                            chunk_bytes, _sim_cache, sim_level=level)


# The margin the modeled per-message α saving must clear over the
# modeled pack overhead before plan() switches the data path to packed
# (see the fallback block at the end of plan()).  α–β constants carry
# real error against any concrete fabric, so a sub-20% differential is
# a coin flip — and losing the flip costs more on the packed side
# (pack/unpack passes, pinned comm buffer, layout coupling) than on
# the per-leaf side.  Fabrics where packing actually matters
# (per-message α × hundreds of leaves) clear this bar by 10-100x, so
# the margin only changes the call where the paths genuinely tie.
PACKED_WIN_MARGIN = 1.2


def _per_leaf_time(topo: HetTopology, coll: str, sizes: Sequence[int],
                   n_leaves: int, kw: dict,
                   sim_cache: dict | None) -> float:
    """Predicted total sync time of the *unpacked* alternative: each
    bucket's payload synced as its share of the tree's ``n_leaves``
    leaves, one collective per leaf (α per leaf, no Pack/Unpack).  Each
    leaf is priced at the bucket's mean leaf size through the same
    candidate search the packed plan used, so the comparison is
    schedule-for-schedule: packed pays 2 pack passes + pack α once, the
    per-leaf path pays the per-collective α ``n_leaves`` times on
    α-dominated payload slivers."""
    total = max(1, sum(int(s) for s in sizes))
    kw = dict(kw)
    kw["packed"] = False
    t = 0.0
    for n in sizes:
        leaves = max(1, round(n_leaves * int(n) / total))
        leaf = max(1, int(n) // leaves)
        bp = plan_bucket(topo, coll, leaf, _sim_cache=sim_cache, **kw)
        t += bp.predicted_s * leaves
    return t


@dataclasses.dataclass(frozen=True)
class BoundPlan:
    """A ``CommPlan`` bound to one process's groups: what the collectives
    take where the reference passes the plan itself.  ``config_for``
    resolves a bucket as ``CommPlan.config_for`` does, on the groups.  The
    plan stays group-free, since groups cannot be pickled and the plan is
    the value that is cached and compared."""

    plan: CommPlan
    pod_group: Any                 # None when the plan has no pod axis
    intra_group: Any
    dp_group: Any

    @classmethod
    def of(cls, plan: CommPlan, rt) -> "BoundPlan":
        """The plan on ``rt``'s groups (a ``parallel.sharding.Runtime``):
        the pod leg runs only where the plan names a pod axis."""
        return cls(plan, rt.pod_group if plan.pod_axis else None,
                   rt.data_group, rt.dp_group)

    @property
    def cluster_weights(self) -> tuple[float, ...] | None:
        return self.plan.cluster_weights

    def config_for(self, nbytes: int) -> CommConfig:
        c = self.plan.bucket_for(nbytes).candidate
        return CommConfig(mode=c.mode, pod_group=self.pod_group,
                          intra_group=self.intra_group, dp_group=self.dp_group,
                          n_chunks=c.n_chunks, compression=c.compression,
                          cluster_weights=self.plan.cluster_weights)


# Default process-wide plan memo (plan(cache="default")).  Launchers
# needing persistence across processes (hillclimb's dryrun subprocesses)
# construct their own PlanCache(path=...) and pass it explicitly;
# cache=None disables memoization (benchmarks measuring cold planning).
_PLAN_CACHE = PlanCache()


def default_plan_cache() -> PlanCache:
    """The process-wide cache behind ``plan(cache='default')``."""
    return _PLAN_CACHE


def invalidate_plan_cache(fingerprint: Any | None = None) -> int:
    """Drop memoized plans — all of them, or only the given topology
    fingerprint's (the elastic-replanning hook: when a pod departs, the
    departed topology's plans are garbage but every other line is still
    valid).  Returns the number of entries dropped."""
    return _PLAN_CACHE.invalidate(fingerprint)


def _plan_key(topo: HetTopology, sizes, coll, pod_axis, intra_axis,
              max_chunks, compressions, tol, flat_mechanism, try_balanced,
              chunk_bytes, backward_compute_s, packed, n_leaves,
              vectorized, level) -> tuple:
    """Cache key: topology fingerprint + grad layout + every knob that
    changes the candidate search.  Skew fields (``skew`` /
    ``skew_compute_s``) are deliberately EXCLUDED: the split shifts every
    candidate's straggler score by the same per-topology constant
    ``max(compute_s)``, so it never changes which candidate (or which of
    as-given vs balanced) wins — the planner strips them from the stored
    plan and re-attaches the caller's values on hit, which is what lets
    ``skew.optimize``'s per-split re-plans collapse onto one cache line.
    ``backward_compute_s`` stays IN the key: it genuinely reshapes the
    overlap timeline and the chosen schedules."""
    return (topo.fingerprint(), tuple(sizes), coll, pod_axis, intra_axis,
            int(max_chunks), tuple(compressions), float(tol),
            flat_mechanism, bool(try_balanced), int(chunk_bytes),
            (None if backward_compute_s is None else float(backward_compute_s)),
            bool(packed), (None if n_leaves is None else int(n_leaves)),
            bool(vectorized), level)


def plan(topo: HetTopology, bucket_sizes, *,
         coll: str = "all_reduce",
         pod_axis: str | None = "pod", intra_axis: str = "data",
         max_chunks: int = 32,
         compressions=(None, "bf16", "int8"),
         tol: float = 0.25,
         flat_mechanism: str = "host",
         try_balanced: bool = True,
         chunk_bytes: int = 4 << 20,
         backward_compute_s: float | None = None,
         skew: Any = None,
         skew_compute_s: Sequence[float] | None = None,
         packed: bool = False,
         n_leaves: int | None = None,
         vectorized: bool = True,
         sim_level: str = "auto",
         cache: Any = "default",
         _sim_cache: dict | None = None) -> CommPlan:
    """Plan the communication schedule for a list of gradient buckets.

    Arguments:
      topo: the physical heterogeneous topology.
      bucket_sizes: per-rank payload of each gradient bucket, in bytes.
        With ``backward_compute_s`` set they must be in *readiness
        order* (``overlap.partition_tree`` / ``bucket_sizes_for_volume``
        produce exactly that).
      coll: the global collective the buckets ride ('all_reduce' for DP
        gradient sync, 'reduce_scatter' for the ZeRO-1 path).
      compressions: DCN codecs the caller is willing to accept; pass
        ``(None,)`` to forbid lossy wire formats, ``(None, 'bf16')`` to
        stay effectively lossless for bf16-scaled gradients.
      tol: maximum relative divergence between the closed-form and the
        event-driven C2C time before a candidate is refused.
      flat_mechanism: how the flat baseline crosses clusters — 'host'
        (Gloo CPU forwarding; the only option across vendors) or
        'native' (one uniform fabric, e.g. TPU DCN).
      try_balanced: also price every bucket on
        ``topo.balanced_subgroups()`` and keep whichever topology gives
        the lower total predicted step time (§4.4).  NOTE: the balanced
        topology is *advisory* — ``config_for`` emits plain
        ``CommConfig``s on the caller's mesh axes, which cannot
        subdivide pods, so a balanced-won plan's predicted times
        describe the recommended re-grouping, not what the unmodified
        mesh will run.  Launchers that execute the plan pass
        ``try_balanced=False``; analysis/benchmark callers keep it on.
      backward_compute_s: wall time of the backward pass producing the
        buckets (``cost_model.backward_compute_time``).  When set, the
        planner schedules each readiness-ordered bucket on the serial
        comm channel against the compute timeline, optimizes *exposed*
        rather than total comm time (``plan_bucket_overlap``), and
        attaches an ``OverlapReport`` to the returned plan.
      packed: price every candidate through the packed data path
        (``schedule.with_packing``) — one Pack + one Unpack per bucket
        sync, charged at launch-α + one on-device-copy pass.  Launchers
        executing ``TrainConfig.packed`` pass True so the overlap-vs-
        monolithic decision sees the per-bucket pack α it must amortize
        (DESIGN.md §11); analytical callers comparing against raw
        ``estimate_schedule`` output keep the default.
      n_leaves: leaf count of the gradient tree the buckets come from.
        With ``packed=True`` it arms the per-leaf fallback: the planner
        prices the unpacked alternative (one collective per leaf, no
        Pack/Unpack; reported as ``per_leaf_s``) and decides
        ``CommPlan.data_path`` by the differential rule — packed only
        when the per-message launch-α saving of (n_leaves - 1) syncs
        clears the modeled pack overhead by ``PACKED_WIN_MARGIN`` — so
        no reachable configuration regresses by packing.  Launchers
        read ``data_path`` and override ``TrainConfig.packed``
        accordingly.
      skew / skew_compute_s: the uneven batch split the plan executes
        under (``core.skew.SkewSplit``) and its per-cluster compute
        times (``skew.compute_times``).  Candidates are then scored by
        the *straggler* step time — max per-cluster compute plus the
        exposed comm term (DESIGN.md §10) — and the plan carries the
        split's per-pod gradient weights so every ``config_for`` result
        executes the weighted reduction.
      vectorized: price candidate grids through the batched numpy
        evaluator (``cost_model.price_schedule_grid``); False falls back
        to the per-candidate scalar loop.  Bit-identical results either
        way (DESIGN.md §14) — the flag exists for differential testing
        and benchmarking, not for accuracy trade-offs.
      sim_level: which event simulator cross-validates the winning
        candidates — 'device' (per-border-rank queues), 'cluster' (the
        aggregated queues; exact for symmetric intra phases), or 'auto'
        (device up to ``_DEVICE_SIM_MAX_RANKS`` total ranks, cluster
        beyond).  Validation is never skipped: large topologies
        downgrade to the cluster sim instead, and the plan records
        which level ran in ``validated_via``.
      cache: 'default' memoizes through the process-wide ``PlanCache``,
        an explicit ``PlanCache`` uses that instance (hillclimb passes a
        disk-backed one so its subprocesses share plans), None disables.
        Cached plans are stored skew-stripped and the caller's skew
        fields re-attached on hit (see ``_plan_key``); a hit planned on
        a fingerprint-equal topology returns that plan's (price-
        identical) topology object.
      _sim_cache: event-simulator memo shared across calls — launchers
        that plan twice (overlap buckets, then a monolithic fallback)
        pass one dict so identical C2C transfers are simulated once.

    Returns a ``CommPlan``; see class docstring for how it plugs into
    the collectives layer.
    """
    sizes = [int(s) for s in bucket_sizes]
    if not sizes:
        raise ValueError("bucket_sizes must be non-empty")
    level = _resolve_sim_level(topo, sim_level)
    skew_fields = dict(
        skew=skew,
        compute_s=tuple(float(x) for x in (skew_compute_s or ())),
        cluster_weights=(tuple(skew.weights) if skew is not None else None))
    use_cache: PlanCache | None = (_PLAN_CACHE if cache == "default"
                                   else cache)
    key = None
    if use_cache is not None:
        key = _plan_key(topo, sizes, coll, pod_axis, intra_axis, max_chunks,
                        compressions, tol, flat_mechanism, try_balanced,
                        chunk_bytes, backward_compute_s, packed, n_leaves,
                        vectorized, level)
        hit = use_cache.get(key)
        if hit is not None:
            return dataclasses.replace(hit, **skew_fields)
    topologies = [(topo, False)]
    if try_balanced:
        bal = topo.balanced_subgroups()
        # fingerprint comparison, not cluster count: a re-grouping that
        # lands on a fingerprint-equal topology prices identically and
        # would only double the search
        if bal.fingerprint() != topo.fingerprint():
            topologies.append((bal, True))

    kw = dict(max_chunks=max_chunks, compressions=compressions, tol=tol,
              flat_mechanism=flat_mechanism, chunk_bytes=chunk_bytes,
              packed=packed, vectorized=vectorized, sim_level=level)
    best: CommPlan | None = None
    best_score: tuple | None = None
    sim_cache: dict = {} if _sim_cache is None else _sim_cache
    for t, balanced in topologies:
        order = tuple(range(len(sizes)))
        if backward_compute_s is None:
            buckets = tuple(
                plan_bucket(t, coll, n, _sim_cache=sim_cache, **kw)
                for n in sizes)
            cand = CommPlan(t, balanced, coll, pod_axis, intra_axis, buckets,
                            bucket_order=order, validated_via=level + "_sim",
                            **skew_fields)
            # prefer fully validated plans; break ties on the straggler
            # objective (== predicted time when no skew compute is given)
            score = (cand.validated, -cand.predicted_straggler_s,
                     -cand.predicted_step_s)
        else:
            # readiness times: backward FLOPs are proportional to the
            # parameter bytes being differentiated, so bucket i's grads
            # land once the compute for buckets 0..i has run.
            total_b = max(1, sum(sizes))
            acc = 0
            buckets_l: list[BucketPlan] = []
            timeline: list[OverlapBucket] = []
            free = 0.0
            # the packed overlap chain packs the WHOLE tree once and
            # syncs slices (check_packed.py asserts one pack), so the
            # per-bucket candidates are priced unpacked and the chain's
            # single pack+unpack is charged once on the report below —
            # charging Pack/Unpack per bucket would bias the
            # overlap-vs-monolithic decision by 2(N-1) launch αs the
            # execution never pays
            bucket_kw = dict(kw)
            bucket_kw["packed"] = False
            for n in sizes:
                acc += n
                ready = backward_compute_s * acc / total_b
                bp = plan_bucket_overlap(
                    t, coll, n, ready_s=ready, free_s=free,
                    backward_s=backward_compute_s,
                    _sim_cache=sim_cache, **bucket_kw)
                start = max(ready, free)
                end = start + bp.predicted_s
                exposed = (max(0.0, end - backward_compute_s)
                           - max(0.0, free - backward_compute_s))
                timeline.append(OverlapBucket(n, ready, start, end,
                                              bp.predicted_s, exposed))
                buckets_l.append(bp)
                free = end
            mono = plan_bucket(t, coll, sum(sizes), _sim_cache=sim_cache,
                               **kw)
            # the chain's one pack + one unpack: charged conservatively
            # as fully exposed (the unpack runs after the last bucket)
            chain_pack = (cost_model.packed_overhead_time(t, sum(sizes))
                          if packed else 0.0)
            report = OverlapReport(
                backward_compute_s,
                sum(b.predicted_s for b in buckets_l) + chain_pack,
                max(0.0, free - backward_compute_s) + chain_pack,
                tuple(timeline),
                monolithic_comm_s=mono.predicted_s)
            cand = CommPlan(t, balanced, coll, pod_axis, intra_axis,
                            tuple(buckets_l), bucket_order=order,
                            overlap=report, validated_via=level + "_sim",
                            **skew_fields)
            # the straggler objective (= exposed time + any per-cluster
            # compute) drives the choice; total time breaks ties
            score = (cand.validated, -cand.predicted_straggler_s,
                     -cand.predicted_step_s)
        if best_score is None or score > best_score:
            best, best_score = cand, score
    assert best is not None
    if packed and n_leaves is not None and n_leaves > 0:
        alt = _per_leaf_time(best.topology, coll, sizes, n_leaves, kw,
                             sim_cache)
        # The decision is DIFFERENTIAL, not plan-total vs plan-total:
        # both paths move identical payload bytes through identical
        # collective phases, so those β terms cancel exactly and
        # comparing full plans would decide on the *noise* of two large
        # nearly-equal totals.  What packing buys is the per-message
        # launch α of the (n_leaves - 1) extra syncs (times the phases
        # each sync runs); what it costs is the pack passes (zero-init
        # + scatter-write) plus the slice unpack on the copy engine.
        # Packed wins only when the α saving clears that overhead by
        # PACKED_WIN_MARGIN — on per-message-α fabrics (real DCN,
        # hundreds of leaves) by 10-100x, while on β-bound fabrics
        # (or a 1-leaf tree) the pack pass can never pay for itself.
        c = max(best.topology.clusters, key=lambda cl: cl.alpha_native_s)
        n_phases = 3 if pod_axis is not None else 1   # RS / C2C / AG
        alpha_saving = (n_leaves - 1) * n_phases * c.alpha_native_s
        pack_overhead = cost_model.packed_overhead_time(
            best.topology, float(sum(sizes)))
        best = dataclasses.replace(
            best, per_leaf_s=alt,
            data_path=("packed"
                       if alpha_saving >= pack_overhead * PACKED_WIN_MARGIN
                       else "per_leaf"))
    if use_cache is not None and key is not None:
        # stored skew-stripped: the split never changes the choice (see
        # _plan_key), so one line serves every SkewSplit the optimizer
        # prices on this topology/knob combination
        use_cache.put(key, dataclasses.replace(
            best, skew=None, compute_s=(), cluster_weights=None))
    return best


def plan_for_param_bytes(topo: HetTopology, total_grad_bytes: int, *,
                         n_buckets: int = 4, **kw) -> CommPlan:
    """Convenience wrapper for launchers: split one flat gradient volume
    into ``n_buckets`` equal buckets (the dtype-bucketed tree sync has
    one bucket per dtype, but launchers usually know only the total)."""
    per = max(1, total_grad_bytes // max(1, n_buckets))
    return plan(topo, [per] * max(1, n_buckets), **kw)
