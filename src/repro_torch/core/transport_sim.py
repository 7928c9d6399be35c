"""Discrete-event simulator of the HetCCL P2P transport (paper §4.1).

The container has no RDMA NICs and one CPU device, so the paper's
*mechanism* — host-driven control plane + on-device data path, chunked
through a pre-registered RDMA buffer pool — is reproduced as an
event-driven model with three pipelined resources per transfer:

    sender d2d engine  ->  RNIC wire  ->  receiver d2d engine

CPU-forwarding (Gloo, Fig. 2(b)) replaces the d2d engines with PCIe
d2h/h2d legs; vendor-native GDR (Fig. 2(a)) skips the staging copies.
Buffer-pool back-pressure is modeled: a chunk may only start its d2d
copy-in when one of the ``pool_chunks`` RDMA buffers is free, and a
buffer frees only when the receiver's copy-out completes (the proxy
polls the CQ and releases the slot, Fig. 5).

This simulator drives the Fig. 3 / Fig. 5 / Fig. 11 / Fig. 15
benchmarks; the closed-form α–β model in ``cost_model`` is validated
against it in tests.
"""

from __future__ import annotations

import dataclasses
import heapq
import math

from . import schedule as schedule_ir
from .topology import Cluster, HetTopology, proportional_split


@dataclasses.dataclass
class TransferTrace:
    mechanism: str
    nbytes: int
    time_s: float
    per_chunk_events: list[tuple[str, int, float, float]]  # (stage, chunk, start, end)

    @property
    def bandwidth_Bps(self) -> float:
        return self.nbytes / self.time_s if self.time_s > 0 else float("inf")

    def stage_busy_s(self, stage: str) -> float:
        return sum(e - s for st, _, s, e in self.per_chunk_events if st == stage)


def _pipeline(nbytes: int, chunk_bytes: int, pool_chunks: int,
              stage_rates: list[float], stage_alphas: list[float],
              mechanism: str, control_alpha: float,
              serialize_all: bool = False) -> TransferTrace:
    """Event-driven 3-stage chunk pipeline with buffer-pool back-pressure.

    stage_rates: bytes/s of each stage.  stage_alphas: per-chunk fixed
    overhead of each stage (WR post / CQ poll / proxy wakeups).  If
    ``serialize_all`` the stages of one chunk and across chunks are fully
    serialized (naive non-pipelined host path)."""
    n_chunks = max(1, math.ceil(nbytes / chunk_bytes))
    sizes = [chunk_bytes] * (n_chunks - 1) + [nbytes - chunk_bytes * (n_chunks - 1)]
    n_stages = len(stage_rates)
    stage_free = [control_alpha] * n_stages       # resource availability time
    chunk_done = [0.0] * n_chunks                 # completion per chunk (last stage)
    # buffer slot release times (min-heap): slot frees when copy-out ends
    slots = [control_alpha] * max(1, pool_chunks)
    heapq.heapify(slots)
    events: list[tuple[str, int, float, float]] = []
    stage_names = {3: ("copy_in", "wire", "copy_out"), 2: ("wire", "copy_out"), 1: ("wire",)}[n_stages] \
        if n_stages in (1, 2, 3) else tuple(f"s{i}" for i in range(n_stages))
    prev_end = control_alpha
    for ci, sz in enumerate(sizes):
        slot_ready = heapq.heappop(slots)
        t = max(slot_ready, control_alpha) if not serialize_all else max(slot_ready, prev_end)
        for si in range(n_stages):
            start = max(t, stage_free[si])
            dur = stage_alphas[si] + sz / stage_rates[si]
            end = start + dur
            stage_free[si] = end
            events.append((stage_names[si], ci, start, end))
            t = end
        chunk_done[ci] = t
        prev_end = t
        heapq.heappush(slots, t)  # slot frees at copy-out completion
    total = max(chunk_done)
    return TransferTrace(mechanism, nbytes, total, events)


def simulate_p2p(src: Cluster, dst: Cluster, nbytes: int, mechanism: str,
                 chunk_bytes: int = 4 << 20, pool_bytes: int = 64 << 20,
                 wr_alpha_s: float = 2e-6) -> TransferTrace:
    """One SendRecv between a border rank of ``src`` and of ``dst``."""
    wire = min(src.nic_Bps, dst.nic_Bps)
    pool_chunks = max(1, pool_bytes // chunk_bytes)
    if mechanism == "native":
        # GDR: NIC reads device memory directly; single-stage wire.
        return _pipeline(nbytes, chunk_bytes, pool_chunks, [wire],
                         [wr_alpha_s], mechanism, src.alpha_native_s)
    if mechanism == "hetccl":
        # Fig. 2(c): d2d copy-in -> wire -> d2d copy-out, chunk-pipelined.
        return _pipeline(nbytes, chunk_bytes, pool_chunks,
                         [src.d2d_Bps, wire, dst.d2d_Bps],
                         [wr_alpha_s] * 3, mechanism, src.alpha_hetccl_s)
    if mechanism == "host":
        # Fig. 2(b): d2h (pageable PCIe) -> TCP wire -> h2d; Gloo neither
        # pins buffers nor pipelines across the bounce buffer —
        # serialized per chunk at pageable-copy + TCP-stack rates.
        return _pipeline(nbytes, chunk_bytes, pool_chunks,
                         [src.h2d_pageable_Bps, wire * src.tcp_wire_eff,
                          dst.h2d_pageable_Bps],
                         [wr_alpha_s * 10] * 3, mechanism, src.alpha_host_s,
                         serialize_all=True)
    raise ValueError(mechanism)


def simulate_c2c_cpy(src: Cluster, dst: Cluster, total_bytes: int,
                     mechanism: str = "hetccl", chunk_bytes: int = 4 << 20,
                     nics_in_use: int | None = None,
                     level: str = "device") -> float:
    """c2cCpy (paper Fig. 7): the cluster-to-cluster volume is divided
    proportionally to NIC bandwidth over the destination border ranks;
    each (src border, dst border) pair runs an independent chunk
    pipeline; the primitive completes when the slowest pair drains.

    ``level="cluster"`` is the cluster-aggregated queue model
    (DESIGN.md §14): the border pairs of one cluster pair are
    independent event pipelines over the same (src, dst) rates, so the
    completion time depends only on a pair's byte share — the aggregate
    model simulates one pipeline per *distinct* share instead of one
    per border rank.  For the symmetric intra phases we emit the shares
    take at most two distinct values (a granularity boundary), so this
    is exact, not approximate: max over distinct shares == max over all
    pairs.  A 256-chip all-border TPU pod drops from 256 event loops to
    at most 2."""
    n_src = src.n_border if nics_in_use is None else min(nics_in_use * src.n_nodes, src.n_border)
    n_dst = dst.n_border if nics_in_use is None else min(nics_in_use * dst.n_nodes, dst.n_border)
    pairs = min(n_src, n_dst)
    if pairs == 0:
        return float("inf")
    bws = [min(src.nic_Bps, dst.nic_Bps)] * pairs
    split = proportional_split(total_bytes, bws, granularity=256)
    parts = sorted(set(split), reverse=True) if level == "cluster" else split
    t = 0.0
    for part in parts:
        if part == 0:
            continue
        tr = simulate_p2p(src, dst, part, mechanism, chunk_bytes)
        t = max(t, tr.time_s)
    return t


def _sim_step_time(step: schedule_ir.Step, topo: HetTopology, nbytes: float,
                   mechanism: str, chunk_bytes: int,
                   level: str = "device") -> float:
    """Duration of one schedule step for a (chunk of) per-rank payload
    ``nbytes``: intra steps use the closed-form ring times (the intra
    fabric is not what this simulator models); C2C steps drain each
    cluster's Table-7 volume to its ring successor through the
    event-driven chunk pipeline (``simulate_c2c_cpy``).

    ``level="cluster"`` folds both loops by cluster fingerprint: intra
    maxima over the distinct representatives (identical clusters yield
    identical floats, so the max is unchanged) and one simulated
    transfer per distinct (src, dst) cluster-fingerprint pair."""
    from . import cost_model  # local: keeps the module importable alone
    folded = level == "cluster"
    if isinstance(step, (schedule_ir.IntraReduceScatter,
                         schedule_ir.IntraAllGather, schedule_ir.IntraBcast,
                         schedule_ir.IntraAll2All, schedule_ir.BorderGather,
                         schedule_ir.Pack, schedule_ir.Unpack,
                         schedule_ir.Compress, schedule_ir.Decompress)):
        cis = ([rep for rep, _ in topo.fold_groups()] if folded
               else range(topo.n_clusters))
        return max(cost_model._intra_step_time(step, topo, ci, nbytes)
                   for ci in cis)
    if isinstance(step, (schedule_ir.C2CRed, schedule_ir.C2CCpy,
                         schedule_ir.BorderExchange, schedule_ir.Flat)):
        mech = "host" if isinstance(step, schedule_ir.Flat) else mechanism
        wire_ratio = getattr(step, "wire_ratio", 1.0)
        vol_ratio = getattr(step, "vol_ratio", 1.0)
        wire = max(1, int(nbytes * wire_ratio))
        C = topo.n_clusters
        t = 0.0
        seen: set[tuple] = set()
        for ci, c in enumerate(topo.clusters):
            nxt = topo.clusters[(ci + 1) % C]
            if folded:
                pair = (c.fingerprint(), nxt.fingerprint())
                if pair in seen:
                    continue
                seen.add(pair)
            send, recv = cost_model.c2c_volume(step.coll, wire, topo, ci)
            vol = int(max(send, recv) * vol_ratio)
            if vol == 0:
                continue
            t = max(t, simulate_c2c_cpy(c, nxt, vol, mech, chunk_bytes,
                                        level=level))
        return t
    return 0.0  # Scale: nb-sized multiply folded into the codec, free


def apply_link_scale(topo: HetTopology,
                     link_scale: dict[int, float]) -> HetTopology:
    """Fabric with each cluster ``ci``'s per-NIC bandwidth multiplied by
    ``link_scale[ci]`` — how the simulator (and the planner, via
    ``HetTopology.derate_cluster``) prices a *degraded* link: a fault
    that inflates beta by k is a scale of 1/k.  Scales must be finite
    and positive; a scale of 1.0 is a no-op for that cluster."""
    out = topo
    for ci, scale in sorted(link_scale.items()):
        if not (scale > 0 and math.isfinite(scale)):
            raise ValueError(
                f"apply_link_scale: scale for cluster {ci} must be "
                f"finite and positive, got {scale!r}")
        if not 0 <= ci < out.n_clusters:
            raise ValueError(
                f"apply_link_scale: cluster index {ci} out of range "
                f"[0, {out.n_clusters})")
        if scale != 1.0:
            out = out.derate_cluster(ci, out.clusters[ci].nic_Bps * scale)
    return out


def simulate_schedule(sched: schedule_ir.Schedule, topo: HetTopology,
                      nbytes_per_rank: int, mechanism: str = "hetccl",
                      chunk_bytes: int = 4 << 20,
                      level: str = "device",
                      link_scale: dict[int, float] | None = None) -> float:
    """Simulation interpreter of the schedule IR (DESIGN.md §9): walk
    the same steps the executor runs and the cost model prices through
    the event queue.  Each step is a pipeline stage with a resource
    free-time; a ChunkLoop feeds the stages chunk by chunk, so the
    steady state drains at the bottleneck stage exactly as the paper's
    Fig. 9 pipeline does — but with the per-chunk WR-posting and
    buffer-pool effects the α–β closed form cannot see.  Returns
    seconds.

    ``level`` selects the event-queue granularity (DESIGN.md §14):
    ``"device"`` walks every border-rank pair and every cluster;
    ``"cluster"`` models per-cluster aggregate queues, folding
    fingerprint-identical clusters and border pairs.  Because the
    per-device queues this simulator builds are independent and
    identical within a fold group, the cluster level is *exact* for
    every schedule we emit (asserted against the device level in
    tests), while scaling with the number of distinct cluster specs
    instead of the device count.

    ``link_scale`` prices a degraded fabric: ``{cluster_index: factor}``
    NIC-bandwidth multipliers applied via :func:`apply_link_scale`
    before the walk (the chaos engine uses this to ask "what does this
    schedule cost once link ci runs at beta x k")."""
    if link_scale:
        topo = apply_link_scale(topo, link_scale)
    steps, k = sched.unrolled()
    k = max(1, min(k, nbytes_per_rank))   # never more chunks than bytes
    per = max(1, nbytes_per_rank // k)
    stage_free = [0.0] * len(steps)
    done = 0.0
    for chunk in range(k):
        n_c = per if chunk < k - 1 else nbytes_per_rank - per * (k - 1)
        t = 0.0
        for si, step in enumerate(steps):
            if isinstance(step, (schedule_ir.Pack, schedule_ir.Unpack)):
                # packing happens ONCE per sync at trace time, outside
                # the chunk loop — charge the full payload on the first
                # chunk only (mirrors the pricer's single pass)
                dur = (0.0 if chunk else _sim_step_time(
                    step, topo, nbytes_per_rank, mechanism, chunk_bytes,
                    level))
            else:
                dur = _sim_step_time(step, topo, n_c, mechanism,
                                     chunk_bytes, level)
            start = max(t, stage_free[si])
            t = start + dur
            stage_free[si] = t
        done = max(done, t)
    return done


def simulate_step(topo: HetTopology, sched: schedule_ir.Schedule,
                  nbytes_per_rank: int, compute_s,
                  mechanism: str = "hetccl",
                  chunk_bytes: int = 4 << 20) -> float:
    """End-to-end training-step event simulation with per-cluster
    compute stages (DESIGN.md §10): cluster ``c``'s gradients only exist
    after ``compute_s[c]`` seconds, so its intra phases run on a
    per-cluster clock — a fast vendor group starts its ReduceScatter
    while the straggler is still computing — and every C2C step is
    synchronous, starting when the *last* cluster reaches it (paper
    §4.4).  That synchronization point is what makes compute skew
    visible end to end: with the even batch split the weakest cluster
    gates every cross-cluster exchange.  Chunks pipeline through the
    per-(step, cluster) stage resources exactly as in
    ``simulate_schedule``.  Returns seconds."""
    from . import cost_model  # local: keeps the module importable alone
    C = topo.n_clusters
    comp = [float(x) for x in compute_s]
    if len(comp) != C:
        raise ValueError(f"simulate_step: need one compute time per "
                         f"cluster ({C}); got {len(comp)}")
    steps, k = sched.unrolled()
    k = max(1, min(k, nbytes_per_rank))
    per = max(1, nbytes_per_rank // k)
    stage_free = [[0.0] * C for _ in steps]
    done = max(comp, default=0.0)
    for chunk in range(k):
        n_c = per if chunk < k - 1 else nbytes_per_rank - per * (k - 1)
        t = list(comp)
        for si, step in enumerate(steps):
            if isinstance(step, (schedule_ir.Pack, schedule_ir.Unpack)):
                # once per sync, not per chunk (see simulate_schedule)
                for ci in range(C):
                    dur = (0.0 if chunk else cost_model._intra_step_time(
                        step, topo, ci, nbytes_per_rank))
                    t[ci] = max(t[ci], stage_free[si][ci]) + dur
                    stage_free[si][ci] = t[ci]
            elif isinstance(step, (schedule_ir.IntraReduceScatter,
                                   schedule_ir.IntraAllGather,
                                   schedule_ir.IntraBcast,
                                   schedule_ir.IntraAll2All,
                                   schedule_ir.BorderGather,
                                   schedule_ir.Compress,
                                   schedule_ir.Decompress)):
                for ci in range(C):
                    dur = cost_model._intra_step_time(step, topo, ci, n_c)
                    t[ci] = max(t[ci], stage_free[si][ci]) + dur
                    stage_free[si][ci] = t[ci]
            elif isinstance(step, (schedule_ir.C2CRed, schedule_ir.C2CCpy,
                                   schedule_ir.BorderExchange,
                                   schedule_ir.Flat)):
                dur = _sim_step_time(step, topo, n_c, mechanism, chunk_bytes)
                end = max(max(t), max(stage_free[si])) + dur
                t = [end] * C
                stage_free[si] = [end] * C
            # Scale: free (folded into the codec's nb-sized vector)
        done = max(done, max(t))
    return done


def memcpy_comparison(src: Cluster, dst: Cluster, nbytes: int) -> dict:
    """Fig. 3: time spent in memory copies per mechanism for one
    transfer. d2h+h2d (pageable host path) vs 2x d2d (hetccl path)."""
    host = nbytes / src.h2d_pageable_Bps + nbytes / dst.h2d_pageable_Bps
    dev = nbytes / src.d2d_Bps + nbytes / dst.d2d_Bps
    return {"host_d2h_h2d_s": host, "hetccl_2x_d2d_s": dev,
            "ratio": host / dev if dev > 0 else float("inf")}


def fit_alpha_beta(sizes: list[int], times: list[float]) -> tuple[float, float]:
    """Linear regression t = α + n/B over (size, time) pairs — the
    paper's Fig. 11 synthesis; returns (alpha_s, bandwidth_Bps).

    Degenerate inputs are handled instead of crashing or going
    negative: identical sizes carry no slope information (the fit
    attributes the mean time to bandwidth through the origin), and
    noisy small-payload fits whose intercept comes out below zero are
    clamped to α = 0 — a negative launch latency is never physical."""
    n = len(sizes)
    assert n >= 2 and n == len(times)
    xs = [float(s) for s in sizes]
    mx = sum(xs) / n
    my = sum(times) / n
    var = sum((x - mx) ** 2 for x in xs)
    if var == 0.0:
        if mx > 0.0 and my > 0.0:
            return 0.0, mx / my
        return max(0.0, my), float("inf")
    cov = sum((x - mx) * (y - my) for x, y in zip(xs, times))
    slope = cov / var
    alpha = max(0.0, my - slope * mx)
    beta = 1.0 / slope if slope > 0 else float("inf")
    return alpha, beta
