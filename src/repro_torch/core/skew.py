"""Compute-skew-aware workload partitioner (beyond-paper; DESIGN.md §10).

HetCCL's topology abstraction carries per-cluster ``tflops``, but an
even data-parallel batch split prices the fleet at the weakest vendor
group: every cluster processes the same per-rank sample count, so the
step waits for the slowest cluster — the straggler regime H2
(arXiv:2505.17548) and HETHUB (arXiv:2405.16256) identify as the main
obstacle to heterogeneous training.  This module derives an *uneven*
per-cluster batch assignment (integer microbatch counts, proportional
to effective throughput) and jointly optimizes it with the
communication plan:

  * **The split** (:class:`SkewSplit`): integer microbatches per
    cluster, every cluster at least one.  ``even_split`` is the
    per-rank-even baseline (microbatches proportional to rank counts);
    ``throughput_split`` is proportional to ``n_ranks × tflops``;
    ``balance_compute`` greedily moves single microbatches until the
    compute straggler ``max_c(m_c / throughput_c)`` stops improving (the
    even split is in its candidate set, so it is never worse).

  * **The objective** — ``cost_model.straggler_step_time``:
    ``max_c(compute_c + exposed_comm_c)`` instead of the optimistic
    aggregate-flops roofline.  Shifting batch shifts both compute *and*
    the overlap hiding window (gradients of bucket *i* are only complete
    once the slowest cluster has produced them), so :func:`optimize`
    re-runs the communication planner per candidate split
    (``planner.plan(..., skew=...)``) and scores the joint straggler
    time.  Balancing compute shrinks the straggler but also shrinks the
    window that hides comm — the coupling that makes this a joint
    search.

  * **Gradient-weighting correctness**: with uneven shards each
    device's mean-loss gradient represents a different number of
    samples, so the sync must weight cluster ``c`` by its share.
    :attr:`SkewSplit.weights` are the per-pod scale factors (normalized
    to mean 1) that ``CommConfig.cluster_weights`` threads into the
    collectives: a local pre-multiply (schedule IR ``Scale`` step)
    before the first combining step, so every reduction remains the
    intrinsic vendor collective and the existing ``/ n_dp``
    normalization yields the exact global-batch mean.

Units follow cost_model conventions: bytes, seconds, FLOPs.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from . import cost_model, planner
from .topology import HetTopology, integer_split


@dataclasses.dataclass(frozen=True)
class SkewSplit:
    """Uneven per-cluster assignment of the data-parallel batch, in
    integer microbatches (one entry per topology cluster, each >= 1).

    ``n_ranks`` carries the per-cluster device counts the gradient
    weights are derived for; ``None`` assumes equal-size clusters (the
    emulated equal-pod mesh)."""

    microbatches: tuple[int, ...]
    n_ranks: tuple[int, ...] | None = None

    def __post_init__(self):
        if not self.microbatches or any(m < 1 for m in self.microbatches):
            raise ValueError(
                f"every cluster needs >= 1 microbatch: {self.microbatches}")
        if (self.n_ranks is not None
                and len(self.n_ranks) != len(self.microbatches)):
            raise ValueError(
                f"n_ranks needs one entry per cluster: {self.n_ranks}")

    @property
    def total(self) -> int:
        return sum(self.microbatches)

    @property
    def shares(self) -> tuple[float, ...]:
        """Each cluster's fraction of the global batch."""
        t = self.total
        return tuple(m / t for m in self.microbatches)

    @property
    def weights(self) -> tuple[float, ...]:
        """Per-device gradient weights for the weighted reduction (the
        ``CommConfig.cluster_weights`` convention): ``w_c = share_c ·
        G / N_c``, mean 1 over *devices*, so ``psum(w_c · grad_d) /
        n_dp`` is the exact global-batch mean gradient (DESIGN.md §10).
        With equal cluster sizes this reduces to ``C · m_c / M``; the
        equal-size form is also what a ``n_ranks=None`` split assumes."""
        shares = self.shares
        if self.n_ranks is not None:
            G = sum(self.n_ranks)
            return tuple(s * G / max(1, n)
                         for s, n in zip(shares, self.n_ranks))
        C = len(self.microbatches)
        return tuple(C * s for s in shares)

    def describe(self) -> str:
        return "/".join(str(m) for m in self.microbatches)


def _ranks(topo: HetTopology) -> tuple[int, ...]:
    return tuple(c.n_ranks for c in topo.clusters)


def even_split(topo: HetTopology, total_microbatches: int) -> SkewSplit:
    """The per-rank-even baseline: microbatches proportional to each
    cluster's rank count — what a skew-oblivious launcher does."""
    return SkewSplit(tuple(integer_split(
        total_microbatches, [c.n_ranks for c in topo.clusters], floor=1)),
        n_ranks=_ranks(topo))


def throughput_split(topo: HetTopology, total_microbatches: int) -> SkewSplit:
    """Microbatches proportional to effective cluster throughput
    ``n_ranks × tflops`` (largest-remainder rounding, floor 1) — the
    proportional seed the joint optimizer starts from."""
    return SkewSplit(tuple(integer_split(
        total_microbatches,
        [c.n_ranks * c.tflops for c in topo.clusters], floor=1)),
        n_ranks=_ranks(topo))


def compute_times(topo: HetTopology, step_flops: float, split: SkewSplit,
                  mfu: float = 0.4) -> tuple[float, ...]:
    """Per-cluster wall seconds for the split's share of the step."""
    return tuple(
        cost_model.cluster_compute_time(c, step_flops * s, mfu)
        for c, s in zip(topo.clusters, split.shares))


# improvement epsilon shared by both greedy loops
_EPS = 1e-12


def _single_moves(ms, donor: int | None = None):
    """All splits one microbatch-move away from ``ms`` (the donor keeps
    >= 1); restrict the donor side with ``donor``."""
    donors = range(len(ms)) if donor is None else (donor,)
    for i in donors:
        if ms[i] <= 1:
            continue
        for j in range(len(ms)):
            if i == j:
                continue
            out = list(ms)
            out[i] -= 1
            out[j] += 1
            yield out


def balance_compute(topo: HetTopology, total_microbatches: int,
                    max_moves: int = 64) -> SkewSplit:
    """Compute-only straggler minimizer: start from the better of the
    even and throughput-proportional splits and greedily move single
    microbatches while ``max_c(m_c / throughput_c)`` strictly improves.
    The even split is in the candidate set, so the result's straggler
    objective never exceeds the even split's."""
    thr = [max(1e-12, c.n_ranks * c.tflops) for c in topo.clusters]

    def obj(ms) -> float:
        return max(m / t for m, t in zip(ms, thr))

    best = min((list(even_split(topo, total_microbatches).microbatches),
                list(throughput_split(topo, total_microbatches).microbatches)),
               key=obj)
    for _ in range(max_moves):
        cur = obj(best)
        nxt = min(_single_moves(best), key=obj, default=None)
        if nxt is None or obj(nxt) >= cur - _EPS:
            break
        best = nxt
    return SkewSplit(tuple(best), n_ranks=_ranks(topo))


# ---------------------------------------------------------------------------
# Joint skew + communication planning
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SkewPlan:
    """The joint result: the chosen split, its communication plan, and
    the even-split baseline it must beat.  ``predicted_step_s`` /
    ``even_step_s`` are straggler objectives (max per-cluster compute +
    exposed comm), each with its own best comm plan."""

    split: SkewSplit
    plan: planner.CommPlan
    compute_s: tuple[float, ...]
    predicted_step_s: float
    even: SkewSplit
    even_step_s: float
    even_plan: planner.CommPlan

    @property
    def speedup(self) -> float:
        if self.predicted_step_s <= 0.0:
            return 1.0
        return self.even_step_s / self.predicted_step_s

    def summary(self) -> dict:
        return {
            "microbatches": list(self.split.microbatches),
            "weights": [round(w, 4) for w in self.split.weights],
            "compute_s": list(self.compute_s),
            "predicted_step_s": self.predicted_step_s,
            "even_microbatches": list(self.even.microbatches),
            "even_step_s": self.even_step_s,
            "speedup_vs_even": round(self.speedup, 4),
            "plan": self.plan.summary(),
        }

    def describe(self) -> str:
        comp = "/".join(f"{c * 1e3:.1f}" for c in self.compute_s)
        return (f"skew split {self.split.describe()} microbatches "
                f"(weights {'/'.join(f'{w:.2f}' for w in self.split.weights)})"
                f" — compute {comp} ms/cluster, straggler step "
                f"{self.predicted_step_s * 1e3:.2f} ms vs even "
                f"({self.even.describe()}) {self.even_step_s * 1e3:.2f} ms: "
                f"{self.speedup:.2f}x")


def optimize(topo: HetTopology, step_flops: float,
             bucket_sizes: Sequence[int], total_microbatches: int, *,
             mfu: float = 0.4, backward_frac: float = 2.0 / 3.0,
             max_moves: int = 8, _sim_cache: dict | None = None,
             **plan_kw) -> SkewPlan:
    """Jointly choose the batch split and the communication plan.

    For each candidate split the planner prices the gradient sync with
    the split's straggler backward time as the hiding window
    (``backward_compute_s``) and the split attached (``skew=`` — the
    plan scores candidates by straggler time and carries the per-cluster
    weights for the weighted sync).  Candidates: the even baseline, the
    compute-balanced seed (:func:`balance_compute`), then up to
    ``max_moves`` single-microbatch moves away from the slowest cluster
    judged by the *joint* objective.  ``plan_kw`` forwards to
    ``planner.plan`` (coll, compressions, flat_mechanism, ...)."""
    sim_cache: dict = {} if _sim_cache is None else _sim_cache
    sizes = [int(s) for s in bucket_sizes]

    def evaluate(split: SkewSplit):
        comp = compute_times(topo, step_flops, split, mfu)
        bwd = max(comp) * backward_frac if comp else 0.0
        p = planner.plan(topo, sizes, backward_compute_s=bwd or None,
                         skew=split, skew_compute_s=comp,
                         _sim_cache=sim_cache, **plan_kw)
        return p.predicted_straggler_s, p, comp

    ev = even_split(topo, total_microbatches)
    even_t, even_p, even_comp = evaluate(ev)

    best_split = balance_compute(topo, total_microbatches)
    best_t, best_p, best_comp = evaluate(best_split)
    if even_t < best_t:
        best_split, best_t, best_p, best_comp = ev, even_t, even_p, even_comp

    C = topo.n_clusters
    for _ in range(max_moves):
        donor = max(range(C), key=lambda i: best_comp[i])
        improved = False
        for ms in _single_moves(best_split.microbatches, donor=donor):
            cand = dataclasses.replace(best_split, microbatches=tuple(ms))
            t, p, comp = evaluate(cand)
            if t < best_t - _EPS:
                best_split, best_t, best_p, best_comp = cand, t, p, comp
                improved = True
        if not improved:
            break

    return SkewPlan(best_split, best_p, best_comp, best_t,
                    ev, even_t, even_p)
