"""Hierarchical topology abstraction for heterogeneous clusters (paper §4.2.1).

The heterogeneous cluster is modeled as an ordered list of homogeneous
``Cluster``s (one per vendor device group, possibly subdivided for
bandwidth balance, §4.4).  Each cluster knows its ranks, its *border
ranks* (the ranks with minimum NUMA distance to an RDMA NIC — the ranks
that terminate cross-cluster links), and its link bandwidths.  The
global communicator (Comm_H) is the concatenation of clusters; each
cluster owns a homogeneous communicator (Comm_C) and a border
communicator (Comm_B).

On the TPU mapping (DESIGN.md §2), a *pod* is a cluster: the intra-pod
ICI mesh plays the role of the vendor fabric and the DCN uplinks play
the role of the cross-cluster RDMA channels.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import math
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """An α–β link: latency_s + bytes / bandwidth_Bps."""

    latency_s: float
    bandwidth_Bps: float

    def time(self, nbytes: float) -> float:
        return self.latency_s + nbytes / self.bandwidth_Bps


@dataclasses.dataclass(frozen=True)
class Cluster:
    """A homogeneous device sub-cluster (one vendor group or a balanced
    subdivision of one).

    ``nic_Bps`` is per-border-rank cross-cluster bandwidth;
    ``intra_Bps`` per-rank scale-up bandwidth inside the cluster;
    ``tflops`` per-device bf16 compute, for end-to-end step modeling.
    """

    name: str
    n_nodes: int
    devs_per_node: int
    nics_per_node: int
    nic_Bps: float          # per NIC
    intra_Bps: float        # per-device scale-up bandwidth
    tflops: float = 100.0
    # staging-copy engine into the RDMA buffer pool (data path c): GPU
    # copy engines sustain ~50 GB/s — calibrated so Fig. 3's measured
    # (d2h+h2d)/(2·d2d) ≈ 3.8x holds.
    d2d_Bps: float = 50.0e9
    h2d_Bps: float = 20.0e9        # pinned-buffer PCIe (not used by Gloo)
    # CPU-forwarding path constants: pageable bounce-buffer copies and
    # TCP-stack wire efficiency (Gloo does not pin or pipeline).
    h2d_pageable_Bps: float = 10.5e9
    tcp_wire_eff: float = 0.6
    alpha_native_s: float = 0.05e-3   # vendor-CCL P2P latency (paper §6.1.1)
    alpha_hetccl_s: float = 0.20e-3   # host-proxy control latency, 1.2-2.4x native
    alpha_host_s: float = 1.73e-3     # Gloo CPU-forwarding latency

    @property
    def n_ranks(self) -> int:
        return self.n_nodes * self.devs_per_node

    @property
    def border_ranks(self) -> tuple[int, ...]:
        """Local indices of border ranks: one rank per NIC, chosen as the
        ranks with minimum NUMA distance (here: round-robin over the
        node's devices, matching one-NIC-per-NUMA-domain placement).
        Memoized on the (n_nodes, devs_per_node, nics_per_node) triple —
        at 100k devices this tuple is consulted per simulated transfer
        and rebuilding it per access dominated the event sim."""
        return _border_ranks(self.n_nodes, self.devs_per_node,
                             self.nics_per_node)

    @property
    def n_border(self) -> int:
        return len(self.border_ranks)

    @property
    def cross_Bps(self) -> float:
        """Total cross-cluster bandwidth (all NICs)."""
        return self.n_nodes * self.nics_per_node * self.nic_Bps

    def fingerprint(self) -> tuple:
        """Canonical pricing identity of this cluster: every field the
        cost model, the event simulator, and the planner read —
        excluding the display ``name``, so renaming a pod never changes
        its prices.  Two clusters with equal fingerprints are
        indistinguishable to every interpreter, which is what lets the
        planner fold k identical pods into one representative."""
        return (self.n_nodes, self.devs_per_node, self.nics_per_node,
                self.nic_Bps, self.intra_Bps, self.tflops, self.d2d_Bps,
                self.h2d_Bps, self.h2d_pageable_Bps, self.tcp_wire_eff,
                self.alpha_native_s, self.alpha_hetccl_s,
                self.alpha_host_s)


@functools.lru_cache(maxsize=4096)
def _border_ranks(n_nodes: int, devs_per_node: int,
                  nics_per_node: int) -> tuple[int, ...]:
    out = []
    for node in range(n_nodes):
        base = node * devs_per_node
        stride = max(1, devs_per_node // max(1, nics_per_node))
        for nic in range(min(nics_per_node, devs_per_node)):
            out.append(base + nic * stride)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class HetTopology:
    """The global heterogeneous topology Comm_H = ordered clusters."""

    clusters: tuple[Cluster, ...]

    @property
    def n_clusters(self) -> int:
        return len(self.clusters)

    @functools.cached_property
    def n_ranks(self) -> int:
        # cached: c2c_volume reads this per cluster per pricing call, and
        # recomputing the O(n_clusters) sum there turns every closed-form
        # evaluation into O(n_clusters^2) at 100k devices
        return sum(c.n_ranks for c in self.clusters)

    def cluster_of_rank(self, rank: int) -> tuple[int, int]:
        """Global rank -> (cluster index, local rank)."""
        off = 0
        for ci, c in enumerate(self.clusters):
            if rank < off + c.n_ranks:
                return ci, rank - off
            off += c.n_ranks
        raise ValueError(f"rank {rank} out of range {self.n_ranks}")

    def ring_order(self) -> tuple[int, ...]:
        """Cluster-level ring (paper: c2cCpy only exchanges with the
        previous and next cluster, minimizing total C2C volume)."""
        return tuple(range(self.n_clusters))

    def bottleneck_cross_Bps(self) -> float:
        """Cross-cluster step is synchronous: bounded by the minimum
        total NIC bandwidth among clusters (paper §4.4)."""
        return min(c.cross_Bps for c in self.clusters)

    def fingerprint(self) -> tuple:
        """Canonical topology fingerprint: the *sorted multiset* of the
        per-cluster fingerprints.  Cluster order and cluster names do
        not appear — permuting or renaming clusters yields an equal
        fingerprint.  That canonicalization is sound because the C2C
        capability matrix is fully determined by the per-cluster NIC
        specs (the cluster ring's pairwise wire bandwidth is
        ``min(src.nic_Bps, dst.nic_Bps)`` and every closed-form C2C
        term is a max over per-cluster drains), so topologies equal
        under permutation price identically.  This is the key the
        planner's ``PlanCache`` and symmetry folding are built on."""
        return _topo_fingerprint(self)

    def fold_groups(self) -> tuple[tuple[int, int], ...]:
        """Symmetry folding: ``(representative cluster index, count)``
        per *distinct* cluster fingerprint, in first-occurrence order.
        Pricing k identical pods computes the representative once — the
        closed forms aggregate clusters with ``max``, so multiplicity
        never changes the result (exactness argument in DESIGN.md §14).
        A homogeneous 100k-device multipod folds to a single group."""
        return _topo_fold_groups(self)

    def drop_cluster(self, index: int) -> "HetTopology":
        """Survivor topology after losing cluster ``index`` whole (pod
        failure).  The result has a new ``fingerprint()`` — the elastic
        controller invalidates the old one's ``PlanCache`` lines and
        re-plans against this."""
        if not 0 <= index < self.n_clusters:
            raise ValueError(
                f"drop_cluster: index {index} out of range "
                f"[0, {self.n_clusters})")
        if self.n_clusters == 1:
            raise ValueError(
                "drop_cluster: cannot drop the only cluster — there is "
                "no survivor topology")
        return HetTopology(self.clusters[:index] + self.clusters[index + 1:])

    def shrink_cluster(self, index: int, n_nodes: int) -> "HetTopology":
        """Survivor topology after evicting hosts *inside* cluster
        ``index`` (persistent straggler / host loss): the same cluster
        with ``n_nodes`` remaining nodes.  Unlike :meth:`drop_cluster`
        this changes the intra-cluster world size, so the ZeRO-1 master
        layout must be remapped (``packing.remap_shard_ops``)."""
        if not 0 <= index < self.n_clusters:
            raise ValueError(
                f"shrink_cluster: index {index} out of range "
                f"[0, {self.n_clusters})")
        c = self.clusters[index]
        if not 0 < n_nodes <= c.n_nodes:
            raise ValueError(
                f"shrink_cluster: {c.name} has {c.n_nodes} nodes, "
                f"cannot keep {n_nodes}")
        if n_nodes == c.n_nodes:
            return self
        survivor = dataclasses.replace(c, n_nodes=int(n_nodes))
        return HetTopology(self.clusters[:index] + (survivor,)
                           + self.clusters[index + 1:])

    def derate_cluster(self, index: int, nic_Bps: float) -> "HetTopology":
        """Topology with cluster ``index``'s per-NIC bandwidth replaced
        by a *measured* value (degraded-link recovery): the same shape,
        but every C2C term priced at what the link actually delivers.
        ``nic_Bps`` is in the fingerprint, so the result has a new
        ``fingerprint()`` — the elastic controller invalidates the old
        one's ``PlanCache`` lines and re-plans against this, exactly as
        for :meth:`drop_cluster`."""
        if not 0 <= index < self.n_clusters:
            raise ValueError(
                f"derate_cluster: index {index} out of range "
                f"[0, {self.n_clusters})")
        if not (isinstance(nic_Bps, (int, float)) and nic_Bps > 0
                and math.isfinite(nic_Bps)):
            raise ValueError(
                f"derate_cluster: nic_Bps must be finite and positive, "
                f"got {nic_Bps!r}")
        c = self.clusters[index]
        if nic_Bps == c.nic_Bps:
            return self
        derated = dataclasses.replace(c, nic_Bps=float(nic_Bps))
        return HetTopology(self.clusters[:index] + (derated,)
                           + self.clusters[index + 1:])

    def balanced_subgroups(self, tol: float = 0.34) -> "HetTopology":
        """§4.4: divide larger vendor groups into subgroups with roughly
        equal total cross-cluster bandwidth, so no cluster idles while
        the bottleneck cluster drains."""
        target = self.bottleneck_cross_Bps()
        new: list[Cluster] = []
        for c in self.clusters:
            k = max(1, int(round(c.cross_Bps / target)))
            k = min(k, c.n_nodes)  # can only split at node granularity
            while k > 1 and c.n_nodes % k != 0:
                k -= 1
            if k == 1 or c.cross_Bps <= target * (1.0 + tol):
                new.append(c)
                continue
            per = c.n_nodes // k
            for i in range(k):
                new.append(dataclasses.replace(c, name=f"{c.name}.{i}", n_nodes=per))
        return HetTopology(tuple(new))


@functools.lru_cache(maxsize=1024)
def _topo_fingerprint(topo: "HetTopology") -> tuple:
    return tuple(sorted(c.fingerprint() for c in topo.clusters))


@functools.lru_cache(maxsize=1024)
def _topo_fold_groups(topo: "HetTopology") -> tuple[tuple[int, int], ...]:
    index: dict[tuple, int] = {}
    groups: list[list[int]] = []
    for i, c in enumerate(topo.clusters):
        fp = c.fingerprint()
        gi = index.get(fp)
        if gi is None:
            index[fp] = len(groups)
            groups.append([i, 1])
        else:
            groups[gi][1] += 1
    return tuple((rep, count) for rep, count in groups)


def proportional_split(total_bytes: int, bandwidths: Sequence[float],
                       granularity: int = 1) -> list[int]:
    """Divide a C2C transfer across border ranks proportionally to their
    NIC bandwidth (paper §4.2.2, c2cCpy load balance).  The split is
    quantized to ``granularity`` bytes; remainders go to the fastest
    links first.  sum(result) == total_bytes.

    Raises ``ValueError`` when every link has zero bandwidth and there
    are bytes to place (there is no proportion to split by); zero bytes
    short-circuit to an all-zero split whatever the bandwidths.

    Memoized on ``(total_bytes, tuple(bandwidths), granularity)``: the
    C2C simulator calls this per transfer with the same NIC vector at
    every cluster of a large topology, and the result is deterministic.
    ``_proportional_split_impl`` is the uncached computation the
    memoized path is regression-tested bit-identical against."""
    return list(_proportional_split_cached(
        int(total_bytes), tuple(bandwidths), int(granularity)))


@functools.lru_cache(maxsize=8192)
def _proportional_split_cached(total_bytes: int, bandwidths: tuple,
                               granularity: int) -> tuple[int, ...]:
    return tuple(_proportional_split_impl(total_bytes, bandwidths,
                                          granularity))


def _proportional_split_impl(total_bytes: int, bandwidths: Sequence[float],
                             granularity: int = 1) -> list[int]:
    assert total_bytes >= 0 and len(bandwidths) > 0
    if total_bytes == 0:
        return [0] * len(bandwidths)
    tot_bw = float(sum(bandwidths))
    if tot_bw <= 0.0:
        raise ValueError(
            "proportional_split: all link bandwidths are zero — "
            f"cannot place {total_bytes} bytes")
    raw = [total_bytes * (bw / tot_bw) for bw in bandwidths]
    out = [int(r // granularity) * granularity for r in raw]
    rem = total_bytes - sum(out)
    order = sorted(range(len(bandwidths)), key=lambda i: -bandwidths[i])
    i = 0
    while rem > 0:
        take = min(granularity, rem)
        out[order[i % len(order)]] += take
        rem -= take
        i += 1
    return out


def integer_split(total: int, weights: Sequence[float],
                  floor: int = 0) -> list[int]:
    """Largest-remainder integer split of ``total`` items proportionally
    to ``weights``, every entry at least ``floor`` (the workload-side
    sibling of :func:`proportional_split`: microbatches over clusters,
    samples over hosts).  Deterministic: after each entry's floor and
    integer quota, leftover units go to the largest fractional parts,
    ties broken toward the larger weight, then the lower index.  The
    result is monotone in the weights (a heavier entry never receives
    less) and ``sum(result) == total``.

    Raises ``ValueError`` when ``total`` cannot cover the floors or all
    weights are zero.

    Memoized on ``(total, tuple(weights), floor)`` exactly like
    :func:`proportional_split` (same per-bucket repeat pattern at large
    cluster counts); ``_integer_split_impl`` is the uncached oracle."""
    return list(_integer_split_cached(int(total), tuple(weights),
                                      int(floor)))


@functools.lru_cache(maxsize=8192)
def _integer_split_cached(total: int, weights: tuple,
                          floor: int) -> tuple[int, ...]:
    return tuple(_integer_split_impl(total, weights, floor))


def _integer_split_impl(total: int, weights: Sequence[float],
                        floor: int = 0) -> list[int]:
    k = len(weights)
    assert k > 0 and total >= 0
    if total < floor * k:
        raise ValueError(
            f"integer_split: cannot give {k} entries a floor of {floor} "
            f"out of {total} items")
    tot_w = float(sum(weights))
    if tot_w <= 0.0:
        raise ValueError("integer_split: all weights are zero")
    spare = total - floor * k
    quotas = [spare * (float(w) / tot_w) for w in weights]
    out = [floor + int(q) for q in quotas]
    rem = total - sum(out)
    order = sorted(range(k),
                   key=lambda i: (-(quotas[i] - int(quotas[i])),
                                  -weights[i], i))
    for i in range(rem):
        out[order[i % k]] += 1
    return out


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------

def paper_testbed() -> HetTopology:
    """Table 6 of the paper (bandwidths in bytes/s; 1 Gbps = 0.125 GB/s)."""
    G = 0.125e9
    return HetTopology((
        Cluster("nvidia_a800", n_nodes=4, devs_per_node=8, nics_per_node=8,
                nic_Bps=200 * G, intra_Bps=4.8e12 / 8, tflops=312.0),
        Cluster("vendor1", n_nodes=2, devs_per_node=16, nics_per_node=1,
                nic_Bps=100 * G, intra_Bps=192e9 / 16, tflops=32.0),
        Cluster("vendor2", n_nodes=2, devs_per_node=8, nics_per_node=8,
                nic_Bps=400 * G, intra_Bps=100e9, tflops=256.0),
        Cluster("vendor3", n_nodes=4, devs_per_node=8, nics_per_node=8,
                nic_Bps=400 * G, intra_Bps=240e9 / 8, tflops=200.0),
    ))


def three_vendor_testbed(tflops_ratio: float = 4.0) -> HetTopology:
    """Default 3-vendor skew topology (DESIGN.md §10): three equal-size
    vendor groups (2 nodes x 8 devices, 8 x 200 Gbps NICs each) whose
    per-device tflops span ``tflops_ratio`` geometrically — deliberately
    comm-symmetric so partitioner experiments isolate compute skew from
    bandwidth skew."""
    G = 0.125e9
    r = max(1.0, float(tflops_ratio))
    tf = (100.0 * r, 100.0 * math.sqrt(r), 100.0)
    return HetTopology(tuple(
        Cluster(f"vendor{i}", n_nodes=2, devs_per_node=8, nics_per_node=8,
                nic_Bps=200 * G, intra_Bps=300e9, tflops=t)
        for i, t in enumerate(tf)))


# TPU v5e constants used throughout the roofline analysis (system prompt).
V5E_PEAK_FLOPS = 197e12          # bf16 per chip
V5E_HBM_BPS = 819e9              # HBM bandwidth per chip
V5E_ICI_LINK_BPS = 50e9          # per ICI link
V5E_ICI_LINKS = 4                # 2D torus: 4 links/chip on v5e
V5E_DCN_BPS = 6.25e9             # assumed per-chip DCN (≈ 50 Gbps); documented
V5E_VMEM_BYTES = 128 * 1024**2   # ~128 MiB vector memory per chip


def tpu_pod_cluster(name: str, n_chips: int = 256, dcn_Bps: float = V5E_DCN_BPS) -> Cluster:
    """One TPU v5e pod viewed as a homogeneous cluster; every chip has a
    DCN uplink, so every rank is a border rank (the common modern case
    the paper calls out in §4.3.2)."""
    return Cluster(name, n_nodes=n_chips, devs_per_node=1, nics_per_node=1,
                   nic_Bps=dcn_Bps,
                   intra_Bps=V5E_ICI_LINK_BPS * V5E_ICI_LINKS / 2,  # bidirectional ring usable
                   tflops=V5E_PEAK_FLOPS / 1e12,
                   d2d_Bps=V5E_HBM_BPS,
                   alpha_native_s=1e-6, alpha_hetccl_s=5e-6, alpha_host_s=1e-3)


def tpu_multipod(n_pods: int = 2, chips_per_pod: int = 256,
                 dcn_Bps: float = V5E_DCN_BPS) -> HetTopology:
    """``n_pods`` equal TPU pods.  ``dcn_Bps`` scales every chip's DCN
    uplink — lowering it models a border-scarce deployment (oversubscribed
    inter-pod fabric), the regime where the pairwise-exchange schedules
    (hier_border_rs, hier_a2a) win over their flat counterparts."""
    return HetTopology(tuple(
        tpu_pod_cluster(f"pod{i}", chips_per_pod, dcn_Bps)
        for i in range(n_pods)))


def tpu_multipod_scarce(n_pods: int = 2, chips_per_pod: int = 256,
                        nics_per_pod: int = 4,
                        nic_Bps: float = V5E_DCN_BPS) -> HetTopology:
    """Border-scarce multipod: each pod is a single scale-up domain
    (the full ICI fabric inside, so intra collectives never touch a
    NIC) with only ``nics_per_pod`` DCN uplinks for the whole pod —
    the §4.3.2 border-scarce regime, opposite of ``tpu_multipod``
    where every chip is a border rank.  This is where the pairwise
    border-exchange schedules (hier_border_rs, hier_a2a) beat their
    flat counterparts: the cross-cluster leg is the bottleneck and
    halving its volume dwarfs the extra intra phases."""
    return HetTopology(tuple(
        Cluster(f"pod{i}", n_nodes=1, devs_per_node=chips_per_pod,
                nics_per_node=nics_per_pod, nic_Bps=nic_Bps,
                intra_Bps=V5E_ICI_LINK_BPS * V5E_ICI_LINKS / 2,
                tflops=V5E_PEAK_FLOPS / 1e12, d2d_Bps=V5E_HBM_BPS,
                alpha_native_s=1e-6, alpha_hetccl_s=5e-6,
                alpha_host_s=1e-3)
        for i in range(n_pods)))
