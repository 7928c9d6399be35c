"""α–β cost model for heterogeneous collectives (paper §4.4, Table 7).

Every collective is priced as the 3-step breakdown of Algorithm 1:

    start homColl (intra-cluster)  ->  C2C transfers  ->  end homColl

The decomposition itself is no longer hardwired here: this module is
the *pricing interpreter* of the cluster-level schedule IR
(``core/schedule.py``, DESIGN.md §9).  ``estimate_schedule`` walks a
schedule's steps through the α–β closed form; ``estimate_hier_collective``
is a thin wrapper that builds the hier schedule for a collective and
prices it, so pricing and execution can never drift.

The C2C step is synchronous across clusters and bounded by the minimum
total cross-cluster bandwidth (§4.4).  Table 7 gives, per collective,
the total C2C send/recv volume as a function of ``n`` (per-rank send
count), ``C`` (#clusters), ``G`` (total ranks), ``N`` (ranks in current
cluster).  The model exposes both *sequential* and *pipelined* times so
the pipelining win (Fig. 9) can be quantified, and an optimal chunk
count for the pipelined ring.

Unit conventions, used consistently by every function in this module
(and by ``transport_sim`` and ``planner``):

  * payload / volume arguments (``nbytes``, ``n``, ``shard_bytes``):
    **bytes** — always per-rank unless the name says otherwise;
  * bandwidths (anything ``*_Bps`` or returned by ``ring_rank_bw`` /
    ``bandwidth``): **bytes per second**;
  * latencies/α and all returned times: **seconds**.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from . import schedule as schedule_ir
from .topology import Cluster, HetTopology


# ---------------------------------------------------------------------------
# Table 7: C2C volumes (bytes leaving/entering one cluster, per collective)
# ---------------------------------------------------------------------------

def c2c_volume(coll: str, n: int, topo: HetTopology, cluster_idx: int,
               root_cluster: int = 0) -> tuple[int, int]:
    """(send_bytes, recv_bytes) crossing this cluster's border for one
    global collective with per-rank payload ``n`` bytes (Table 7).

    Both returned values are aggregate bytes over all of the cluster's
    border links for the whole collective — divide by ``Cluster.
    cross_Bps`` (bytes/s) for the drain time of that cluster."""
    C = topo.n_clusters
    G = topo.n_ranks
    N = topo.clusters[cluster_idx].n_ranks
    is_root = cluster_idx == root_cluster
    if coll == "all_reduce":
        v = 2 * n * (C - 1) // C
        return v, v
    if coll == "all_gather":
        # every other cluster's aggregate must come in once; ours goes out once
        send = (G - N) * n if C > 2 else N * n
        recv = (G - N) * n
        return min(send, (C - 1) * N * n), recv
    if coll == "reduce_scatter":
        return (G - N) * n, (C - 1) * N * n
    if coll == "broadcast":
        return (n if is_root else 0), (0 if is_root else n)
    if coll == "reduce":
        return (0 if is_root else n), (n if is_root else 0)
    if coll == "gather":
        return (0 if is_root else N * n), ((G - N) * n if is_root else 0)
    if coll == "scatter":
        return ((G - N) * n if is_root else 0), (0 if is_root else N * n)
    if coll == "all_to_all":
        return (G - N) * n, (G - N) * n
    if coll == "send_recv":
        return n, n
    raise ValueError(f"unknown collective {coll!r}")


# Collectives whose Table-7 volumes do not depend on a root cluster:
# for these, c2c_volume is a function of the cluster's fingerprint alone
# (its rank count vs the global total), so per-cluster maxes may be
# folded to the distinct-fingerprint representatives without changing a
# single float.  Root-ed collectives (broadcast/reduce/gather/scatter)
# price the root differently from fingerprint-equal non-roots and are
# never folded.
_ROOT_FREE_COLLS = frozenset({"all_reduce", "all_gather", "reduce_scatter",
                              "all_to_all", "send_recv"})


def _fold_cluster_indices(topo: HetTopology, fold: bool):
    """Cluster indices a max-aggregated walk must visit: all of them,
    or — when folding is sound — one representative per distinct
    cluster fingerprint (``HetTopology.fold_groups``)."""
    if fold:
        return [rep for rep, _ in topo.fold_groups()]
    return range(topo.n_clusters)


# ---------------------------------------------------------------------------
# Homogeneous (intra-cluster) collective times: standard ring formulas
# ---------------------------------------------------------------------------

def ring_rank_bw(c: Cluster) -> float:
    """Effective per-rank ring bandwidth (bytes/s) of the homogeneous
    collective: the scale-up fabric inside a node, but bounded by each
    rank's share of the node's NICs once the ring crosses nodes."""
    if c.n_nodes <= 1:
        return c.intra_Bps
    nic_share = c.nics_per_node * c.nic_Bps / c.devs_per_node
    return min(c.intra_Bps, nic_share)


def ring_all_reduce_time(c: Cluster, nbytes: float, alpha: float | None = None) -> float:
    p = c.n_ranks
    if p <= 1 or nbytes == 0:
        return 0.0
    a = c.alpha_native_s if alpha is None else alpha
    return 2 * (p - 1) * a + 2 * nbytes * (p - 1) / (p * ring_rank_bw(c))


def ring_all_gather_time(c: Cluster, shard_bytes: float, alpha: float | None = None) -> float:
    p = c.n_ranks
    if p <= 1 or shard_bytes == 0:
        return 0.0
    a = c.alpha_native_s if alpha is None else alpha
    return (p - 1) * a + shard_bytes * (p - 1) / ring_rank_bw(c)


def ring_reduce_scatter_time(c: Cluster, nbytes: float, alpha: float | None = None) -> float:
    p = c.n_ranks
    if p <= 1 or nbytes == 0:
        return 0.0
    a = c.alpha_native_s if alpha is None else alpha
    return (p - 1) * a + nbytes * (p - 1) / (p * ring_rank_bw(c))


# ---------------------------------------------------------------------------
# Heterogeneous collective model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CollectiveEstimate:
    """Priced 3-phase breakdown of one hierarchical collective.

    ``start_s`` / ``c2c_s`` / ``end_s`` are the full-payload times
    (seconds) of the intra start phase, the synchronous cross-cluster
    exchange, and the intra end phase; ``codec_s`` is the wire-codec
    encode+decode time (the Compress/Decompress HBM passes on the
    post-RS shard); ``n_chunks`` is the chunk count the phases would be
    split into when pipelined.
    """

    start_s: float
    c2c_s: float
    end_s: float
    n_chunks: int
    codec_s: float = 0.0

    @property
    def sequential_s(self) -> float:
        """Phases executed back to back (seconds):
        start + codec + c2c + end."""
        return self.start_s + self.codec_s + self.c2c_s + self.end_s

    @property
    def pipelined_s(self) -> float:
        """Perfect chunked overlap of the pipeline stages (Fig. 9).

        With the payload in ``k`` chunks, the steady state drains at the
        bottleneck stage while the other stages hide behind it, and the
        pipeline additionally pays fill/flush: one chunk traversing all
        stages minus the bottleneck's share already counted.

            pipelined = bott + max(0, sum(stages)/k - bott/k)

        Worked example — stages (start, c2c, end) = (3 ms, 6 ms, 3 ms),
        k = 4: bottleneck 6 ms; one chunk through the whole pipe is
        (3+6+3)/4 = 3 ms, of which 6/4 = 1.5 ms is the bottleneck's own
        chunk (already inside the 6 ms), so fill/flush adds 1.5 ms:
        7.5 ms total vs 12 ms sequential — a 1.6× win.  As k→∞ the
        time approaches the bottleneck stage alone; small k leaves the
        fill term, and k=1 degenerates to ``sequential_s``.

        ``codec_s`` rides as a fourth stage: the chunk loop's
        double-buffered carry (``core/pipelined.py``) traces
        compress(i) with no data dependency on C2C(i-1), so the codec
        passes hide behind the bottleneck exactly like the intra
        phases do — the "hidden compress" this estimate prices.
        """
        k = max(1, self.n_chunks)
        stages = (self.start_s, self.codec_s, self.c2c_s, self.end_s)
        bott = max(stages)
        fill = sum(stages) / k  # one chunk through the non-bottleneck stages
        return bott + max(0.0, fill - bott / k)

    def bandwidth(self, nbytes: float, pipelined: bool = True) -> float:
        """Effective collective bandwidth (bytes/s) for a per-rank
        payload of ``nbytes`` bytes."""
        t = self.pipelined_s if pipelined else self.sequential_s
        return nbytes / t if t > 0 else float("inf")


def c2c_step_time(topo: HetTopology, coll: str, n: int, alpha: float,
                  n_chunks: int = 1, fold: bool = False) -> float:
    """Time (seconds) for the synchronous C2C exchange: each cluster
    drains its Table-7 volume (bytes) through its aggregate NIC
    bandwidth (bytes/s); the step completes when the slowest cluster
    finishes (paper §4.4).  ``alpha`` (seconds) is charged once per
    chunk — pipelining trades α for overlap.  ``fold=True`` maxes over
    the distinct-fingerprint representatives only (exact for root-free
    collectives; see ``_fold_cluster_indices``)."""
    t = 0.0
    for ci in _fold_cluster_indices(topo, fold and coll in _ROOT_FREE_COLLS):
        c = topo.clusters[ci]
        send, recv = c2c_volume(coll, n, topo, ci)
        vol = max(send, recv)
        t = max(t, alpha * n_chunks + vol / c.cross_Bps)
    return t


def _intra_step_time(step: schedule_ir.Step, topo: HetTopology, ci: int,
                     n: float) -> float:
    """Seconds one cluster spends in one intra-phase step."""
    c = topo.clusters[ci]
    if isinstance(step, schedule_ir.IntraReduceScatter):
        return ring_reduce_scatter_time(
            c, schedule_ir.eval_volume(step.vol, n, topo, c))
    if isinstance(step, (schedule_ir.IntraAllGather, schedule_ir.IntraBcast)):
        return ring_all_gather_time(
            c, schedule_ir.eval_volume(step.vol, n, topo, c))
    if isinstance(step, schedule_ir.IntraAll2All):
        # intra dispatch/redistribute of the hierarchical All2All (§5):
        # each rank keeps 1/N of ``vol`` and exchanges the rest — the
        # same (N-1)/N per-rank traffic profile as a ReduceScatter of
        # ``vol``, on the same ring fabric
        return ring_reduce_scatter_time(
            c, schedule_ir.eval_volume(step.vol, n, topo, c))
    if isinstance(step, schedule_ir.BorderGather):
        # c2cRed bounce (Fig. 8): received partials land on free offsets
        # of the border ranks and take one extra intra-cluster native
        # Reduce hop to the target — charge its volume for combiners.
        _, recv_vol = c2c_volume(step.coll, int(n), topo, ci)
        return ring_reduce_scatter_time(c, recv_vol / max(1, c.n_border))
    if isinstance(step, (schedule_ir.Pack, schedule_ir.Unpack)):
        # local data-path cost of the packed comm buffer (DESIGN.md
        # §11): one launch α plus one pass of the payload through the
        # on-device copy engine (d2d_Bps ≈ HBM-bound memcpy) — the cost
        # the packed layout pays once per sync instead of once per
        # bucket/chunk/codec re-pad.  A Pack carrying the fused
        # pack+quantize (wire_ratio < 1, schedule.with_packing) reads
        # the full leaves but writes only wire-sized blocks, so the
        # pass shrinks to (1 + wire_ratio) / 2 of the payload.  A Pack
        # additionally zero-initialises the segment buffer before the
        # leaf scatter-writes land (the alignment gaps must read as
        # zeros on the wire) — one more payload-sized pass on the same
        # engine; an Unpack is slice-reads only and skips it.
        vol = schedule_ir.eval_volume(step.vol, n, topo, c)
        passes = (1.0 + getattr(step, "wire_ratio", 1.0)) / 2.0
        if isinstance(step, schedule_ir.Pack):
            passes += 1.0
        return c.alpha_native_s + vol * passes / c.d2d_Bps
    if isinstance(step, (schedule_ir.Compress, schedule_ir.Decompress)):
        # wire-codec encode/decode: one launch α plus one HBM pass of
        # the post-RS shard (amax+quant read+write for int8, the cast
        # for bf16).  Charged into ``codec_s`` by estimate_schedule so
        # the pipelined estimate can hide it behind the bottleneck
        # stage (the double-buffered chunk loop provides that overlap).
        vol = schedule_ir.eval_volume(step.vol, n, topo, c)
        return c.alpha_native_s + vol / c.d2d_Bps
    return 0.0  # Scale: a local pointwise multiply, free in α–β


def estimate_schedule(topo: HetTopology, sched: schedule_ir.Schedule,
                      nbytes_per_rank: int,
                      hetccl_alpha: float | None = None,
                      fold: bool = False) -> CollectiveEstimate:
    """Pricing interpreter of the schedule IR: walk ``sched``'s steps
    through the α–β closed form.  Intra steps accumulate per cluster and
    each phase completes when the slowest cluster does; every C2C step
    drains its (codec- and leg-scaled) Table-7 volume through each
    cluster's aggregate NIC bandwidth, paying one α per chunk (§4.4).
    Returns a ``CollectiveEstimate`` — ``pipelined_s`` reflects the
    schedule's ChunkLoop depth.

    ``fold=True`` walks only the distinct-fingerprint representatives
    (``HetTopology.fold_groups``) instead of every cluster — exact for
    the root-free collectives the planner prices (every aggregation here
    is a ``max``, and fingerprint-equal clusters produce identical
    floats); it falls back to the full walk when any step's collective
    is root-dependent.  The default stays the full per-cluster walk: it
    is the differential-tested scalar oracle for
    :func:`price_schedule_grid`."""
    alpha = (hetccl_alpha if hetccl_alpha is not None
             else max(c.alpha_hetccl_s for c in topo.clusters))
    n = nbytes_per_rank
    steps, k = sched.unrolled()
    cis = _fold_cluster_indices(topo, fold and all(
        getattr(st, "coll", sched.coll) in _ROOT_FREE_COLLS
        for st in steps))
    start = end = codec = 0.0
    for ci in cis:
        s = sum(_intra_step_time(st, topo, ci, n)
                for st in steps if st.phase == "start")
        e = sum(_intra_step_time(st, topo, ci, n)
                for st in steps if st.phase == "end")
        # Compress/Decompress carry phase "c2c" but are local HBM
        # passes, not wire traffic: they form their own pipeline stage
        # (codec_s) that the double-buffered chunk loop overlaps with
        # the C2C transfer
        cd = sum(_intra_step_time(st, topo, ci, n)
                 for st in steps
                 if isinstance(st, (schedule_ir.Compress,
                                    schedule_ir.Decompress)))
        start = max(start, s)
        end = max(end, e)
        codec = max(codec, cd)
    c2c = 0.0
    for st in steps:
        if isinstance(st, schedule_ir.Flat):
            raise ValueError(
                "flat schedules are priced per mechanism — use "
                "flat_host_forwarding_time or planner._price_flat")
        if not isinstance(st, (schedule_ir.C2CRed, schedule_ir.C2CCpy,
                               schedule_ir.BorderExchange)):
            continue
        wire = max(1, int(n * st.wire_ratio))
        t = 0.0
        for ci in cis:
            c = topo.clusters[ci]
            send, recv = c2c_volume(st.coll, wire, topo, ci)
            vol = max(send, recv) * st.vol_ratio
            t = max(t, alpha * k + vol / c.cross_Bps)
        c2c += t
    return CollectiveEstimate(start, c2c, end, k, codec)


def price_schedule_grid(topo: HetTopology,
                        scheds: list[schedule_ir.Schedule],
                        nbytes_per_rank: int,
                        hetccl_alpha: float | None = None
                        ) -> list[tuple[float, float]]:
    """Batched pricing of a candidate grid of *non-flat* schedules —
    the planner's vectorized hot path (DESIGN.md §14).  Returns, per
    schedule, the same ``(full seconds, C2C leg seconds)`` pair that
    ``planner._price_schedule`` computes one candidate at a time
    through :func:`estimate_schedule`.

    Two structural facts make the batch cheap without changing a single
    float:

      * **Symmetry folding** — every per-cluster quantity is aggregated
        with ``max``, so only the *distinct* cluster fingerprints
        (``HetTopology.fold_groups``) are evaluated: a homogeneous
        100k-device multipod prices one representative pod.  ``max``
        over representatives equals ``max`` over all clusters exactly
        (identical specs produce identical floats), so this is
        bit-identical to the scalar walk, not an approximation.

      * **Chunk-axis sharing** — the chunk-pipelined family of a (mode,
        codec) shares one unrolled step tuple (``ChunkLoop`` bodies are
        chunk-count-independent), so its intra/codec phase times are
        computed once and only the per-chunk α term and the
        fill/bottleneck combination vary — evaluated for the whole
        chunk vector in one numpy expression that replicates
        ``CollectiveEstimate``'s operation order exactly (same IEEE
        double ops in the same association), keeping the grid
        bit-identical to the scalar oracle.

    Flat schedules are priced per mechanism by the planner and must not
    appear here (same contract as :func:`estimate_schedule`).
    """
    alpha = (hetccl_alpha if hetccl_alpha is not None
             else max(c.alpha_hetccl_s for c in topo.clusters))
    n = nbytes_per_rank
    reps = [rep for rep, _ in topo.fold_groups()]
    # group the grid by unrolled step tuple; members carry (index, k,
    # pipelined) — everything that still differs inside a group
    groups: dict[tuple, list[tuple[int, int, bool]]] = {}
    for si, sched in enumerate(scheds):
        steps, k = sched.unrolled()
        groups.setdefault(steps, []).append((si, k, sched.pipelined))
    out: list[tuple[float, float] | None] = [None] * len(scheds)
    for steps, members in groups.items():
        start = end = codec = 0.0
        for ci in reps:
            s = sum(_intra_step_time(st, topo, ci, n)
                    for st in steps if st.phase == "start")
            e = sum(_intra_step_time(st, topo, ci, n)
                    for st in steps if st.phase == "end")
            cd = sum(_intra_step_time(st, topo, ci, n)
                     for st in steps
                     if isinstance(st, (schedule_ir.Compress,
                                        schedule_ir.Decompress)))
            start = max(start, s)
            end = max(end, e)
            codec = max(codec, cd)
        ks = np.array([float(k) for _, k, _ in members])
        c2c = np.zeros(len(members))
        for st in steps:
            if isinstance(st, schedule_ir.Flat):
                raise ValueError(
                    "flat schedules are priced per mechanism — use "
                    "planner._price_flat")
            if not isinstance(st, (schedule_ir.C2CRed, schedule_ir.C2CCpy,
                                   schedule_ir.BorderExchange)):
                continue
            wire = max(1, int(n * st.wire_ratio))
            drain = np.array([
                max(*c2c_volume(st.coll, wire, topo, ci)) * st.vol_ratio
                / topo.clusters[ci].cross_Bps for ci in reps])
            # scalar loop: t = max(0, max_c(alpha·k + vol_c/bw_c))
            c2c = c2c + np.maximum(
                0.0, np.max(alpha * ks[:, None] + drain[None, :], axis=1))
        # CollectiveEstimate.sequential_s / .pipelined_s, same op order
        seq = ((start + codec) + c2c) + end
        bott = np.maximum(max(start, codec, end), c2c)
        pip = bott + np.maximum(0.0, seq / ks - bott / ks)
        for (si, _, pipelined), s_t, p_t, c_t in zip(members, seq, pip, c2c):
            out[si] = (float(p_t) if pipelined else float(s_t), float(c_t))
    return out  # type: ignore[return-value]


def estimate_hier_collective(topo: HetTopology, coll: str, nbytes_per_rank: int,
                             n_chunks: int = 1,
                             hetccl_alpha: float | None = None,
                             fold: bool = False) -> CollectiveEstimate:
    """Price Algorithm 1 for collective ``coll`` with per-rank payload
    ``nbytes_per_rank`` bytes.  Thin wrapper: builds the hier schedule
    (chunk-pipelined when ``n_chunks`` > 1) from ``core.schedule`` and
    prices it step by step — the decomposition lives in one place.
    Returns a ``CollectiveEstimate`` (all phase times in seconds);
    ``hetccl_alpha`` defaults to the slowest cluster's host-proxy
    control latency; ``fold`` as in :func:`estimate_schedule`."""
    mode = "hier_pipelined" if n_chunks > 1 else "hier"
    sched = schedule_ir.build_schedule(coll, mode, n_chunks)
    return estimate_schedule(topo, sched, nbytes_per_rank, hetccl_alpha,
                             fold=fold)


def pack_pass_time(topo: HetTopology, nbytes: float) -> float:
    """Seconds for ONE payload pass (plus launch α) of ``nbytes`` on the
    slowest cluster — the unit the packed-path charges are built from.
    The Unpack charge is exactly one pass (slice reads); Pack is two
    (slot writes + the zero-init of the segment buffer) — use
    ``packed_overhead_time`` for the full per-sync Pack+Unpack total."""
    return max(c.alpha_native_s + nbytes / c.d2d_Bps for c in topo.clusters)


def packed_overhead_time(topo: HetTopology, nbytes: float) -> float:
    """Pack + Unpack total for one sync of ``nbytes``: 2α + 3 payload
    passes on the slowest cluster (pack slot writes + segment zero-init
    + unpack slice reads).  The same charge the IR pricing folds into
    the start/end phases (``_intra_step_time``) and the planner's
    differential per-leaf fallback weighs against the α saving — kept
    in one place so flat candidates, packed IR schedules, and the
    fallback all price packing identically."""
    return max(2.0 * c.alpha_native_s + 3.0 * nbytes / c.d2d_Bps
               for c in topo.clusters)


def flat_host_forwarding_time(topo: HetTopology, coll: str, nbytes_per_rank: int) -> float:
    """Gloo-style baseline time (seconds): every byte crossing any
    boundary pays d2h + host RDMA + h2d, serialized (Fig. 2(b));
    ``nbytes_per_rank`` in bytes."""
    n = nbytes_per_rank
    t = 0.0
    for ci, c in enumerate(topo.clusters):
        send, recv = c2c_volume(coll, n, topo, ci)
        vol = max(send, recv)
        host_leg = vol / c.cross_Bps + max(c.alpha_host_s, 0.0)
        pcie_leg = vol / c.h2d_Bps * 2.0  # d2h on sender + h2d on receiver
        t = max(t, host_leg + pcie_leg)
        # intra part still via native collectives
    est = estimate_hier_collective(topo, coll, n)
    return est.start_s + t + est.end_s


def optimal_chunks(topo: HetTopology, coll: str, nbytes_per_rank: int,
                   max_chunks: int = 64) -> int:
    """Pick the chunk count (power of two ≤ ``max_chunks``) minimizing
    pipelined time: more chunks -> better overlap but one more α per
    chunk; standard bandwidth/latency tradeoff.  The planner
    (``core.planner``) searches this axis jointly with mode and
    compression instead."""
    best_k, best_t = 1, estimate_hier_collective(topo, coll, nbytes_per_rank, 1).pipelined_s
    k = 2
    while k <= max_chunks:
        t = estimate_hier_collective(topo, coll, nbytes_per_rank, k).pipelined_s
        if t < best_t:
            best_k, best_t = k, t
        k *= 2
    return best_k


# ---------------------------------------------------------------------------
# Compute-side roofline (overlap scheduling support)
# ---------------------------------------------------------------------------

def aggregate_flops(topo: HetTopology, mfu: float = 0.4) -> float:
    """Deliverable FLOP/s of the whole fleet at the given MFU — the
    compute-side roofline term used throughout the figure models
    (fig16/fig17 price compute as flops / (Σ ranks·tflops·MFU)).

    NOTE: *optimistic* on skewed fleets.  Summing throughputs assumes
    the workload is split proportionally to each cluster's speed; with
    the even per-rank batch split the weakest vendor group is the
    straggler and the real step time is bounded by
    :func:`straggler_step_time` (DESIGN.md §10), which this aggregate
    can undershoot by the fleet's tflops spread."""
    return sum(c.n_ranks * c.tflops * 1e12 for c in topo.clusters) * mfu


def cluster_compute_time(c: Cluster, flops: float, mfu: float = 0.4) -> float:
    """Wall seconds one cluster needs for ``flops`` at the given MFU."""
    agg = c.n_ranks * c.tflops * 1e12 * mfu
    if agg <= 0.0 or flops <= 0.0:
        return 0.0
    return flops / agg


def straggler_step_time(topo: HetTopology, step_flops: float,
                        shares=None, comm_s=0.0,
                        mfu: float = 0.4) -> float:
    """Per-cluster step-time roofline ``max_c(compute_c + comm_c)``
    (DESIGN.md §10) — the model that replaces the aggregate-flops
    optimism for end-to-end step pricing.

    ``shares`` is each cluster's fraction of the global batch; the
    default is the even per-rank split (``share_c = N_c / G`` — every
    device the same number of samples), under which the weakest vendor
    group paces the step.  ``comm_s`` is the exposed communication time
    — a scalar for the synchronous collective case or a per-cluster
    sequence.  The skew-aware partitioner (``core.skew``) minimizes this
    quantity over integer microbatch splits."""
    G = max(1, topo.n_ranks)
    if shares is None:
        shares = [c.n_ranks / G for c in topo.clusters]
    if isinstance(comm_s, (int, float)):
        comm = [float(comm_s)] * topo.n_clusters
    else:
        comm = [float(x) for x in comm_s]
    if len(shares) != topo.n_clusters or len(comm) != topo.n_clusters:
        raise ValueError(
            f"straggler_step_time: need one share and one comm term per "
            f"cluster ({topo.n_clusters}); got {len(list(shares))} shares, "
            f"{len(comm)} comm terms")
    t = 0.0
    for c, s, cm in zip(topo.clusters, shares, comm):
        t = max(t, cluster_compute_time(c, step_flops * float(s), mfu) + cm)
    return t


def backward_compute_time(topo: HetTopology, step_flops: float,
                          mfu: float = 0.4,
                          backward_frac: float = 2.0 / 3.0) -> float:
    """Wall time (seconds) of the backward pass on this fleet.

    ``step_flops`` follows the MODEL_FLOPS convention (6·N·D for one
    training step, ``launch/dryrun.py:model_flops_for``); the backward
    pass owns 4 of those 6·N·D — ``backward_frac`` defaults to 2/3.
    This is the compute budget the overlap scheduler
    (``planner.plan(..., backward_compute_s=...)``) hides gradient
    communication behind.
    """
    agg = aggregate_flops(topo, mfu)
    if agg <= 0.0 or step_flops <= 0.0:
        return 0.0
    return step_flops * backward_frac / agg


# ---------------------------------------------------------------------------
# P2P transport model (paper §6.1.1, Fig. 11): α–β per mechanism
# ---------------------------------------------------------------------------

def p2p_time(src: Cluster, dst: Cluster, nbytes: float, mechanism: str,
             chunk_bytes: int = 4 << 20) -> float:
    """SendRecv time (seconds) between a rank of ``src`` and a rank of
    ``dst`` for ``nbytes`` bytes.

    mechanisms: 'native' (vendor GDR, homogeneous only), 'hetccl'
    (host-driven device-buffer RDMA, chunk-pipelined at ``chunk_bytes``
    granularity), 'host' (CPU-forwarding with bounce buffers).
    """
    wire_bw = min(src.nic_Bps, dst.nic_Bps)
    if mechanism == "native":
        return src.alpha_native_s + nbytes / wire_bw
    if mechanism == "hetccl":
        # pipeline d2d copy-in, wire, d2d copy-out at chunk granularity:
        # steady state is bound by the slowest stage (§4.1, Fig. 5).
        stages = (nbytes / src.d2d_Bps, nbytes / wire_bw, nbytes / dst.d2d_Bps)
        n_chunks = max(1, math.ceil(nbytes / chunk_bytes))
        fill = sum(s / n_chunks for s in stages)
        return src.alpha_hetccl_s + max(max(stages), fill)
    if mechanism == "host":
        # serialized d2h -> TCP wire -> h2d (Fig. 2(b)) at pageable-copy
        # and TCP-stack efficiencies (see topology.Cluster docs).
        return (src.alpha_host_s + nbytes / src.h2d_pageable_Bps
                + nbytes / (wire_bw * src.tcp_wire_eff)
                + nbytes / dst.h2d_pageable_Bps)
    raise ValueError(mechanism)


def p2p_bandwidth(src: Cluster, dst: Cluster, nbytes: float, mechanism: str) -> float:
    """Effective SendRecv bandwidth (bytes/s) for an ``nbytes`` transfer."""
    return nbytes / p2p_time(src, dst, nbytes, mechanism)
