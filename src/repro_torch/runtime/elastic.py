"""Elastic re-planning: detect -> re-plan -> reshard -> resume (the JAX
package's ``runtime/elastic.py``).

Closes the loop the health monitors left open (DESIGN.md §15): when a
pod dies or a host persistently straggles, the topology the planner
priced no longer exists — the old ``PlanCache`` lines are garbage and
the ZeRO-1 master shards are laid out for a world that shrank.  The
``ElasticController`` owns the transition:

  * **detect** — ``report_pod_failure`` (an externally observed loss of
    a whole cluster) or ``observe_step`` fed the ``StragglerMonitor``'s
    per-step verdict (``cfg.straggler_patience`` consecutive slow steps
    confirm a *persistent* straggler; transient flags reset the streak).
  * **re-plan** — derive the survivor ``HetTopology``
    (``drop_cluster`` / ``shrink_cluster``), invalidate the old
    fingerprint's plan-cache lines, and re-run ``planner.plan`` (plus
    ``skew.optimize`` when compute skew is being modeled) against the
    survivors.  Cross-validation is never skipped: the new plan carries
    ``validated_via`` like any other.
  * **reshard** — remap the per-dtype ZeRO-1 master segments through
    the ``PackedLayout`` slot map (:func:`remap_zero_state` — a pure
    slice remap, no re-flatten).  When the layouts are not remappable
    (``ValueError``: segment signature changed or the world no longer
    divides a segment), the caller falls back to
    ``CheckpointManager.restore`` with the new shardings.
  * **resume** — ``resumed(step)`` closes the transition and fills the
    ``ReplanReport`` (old->new fingerprint digests, replan latency,
    steps lost, remap path) that ``train.py``/``dryrun.py`` surface
    under ``--elastic``.

What stays *vendor-intrinsic* across a re-plan: the survivor topology
is still a tuple of homogeneous clusters, so every combining collective
in the new plan remains a vendor-CCL intra collective + C2C border
exchange — elasticity changes which clusters exist, never how a cluster
communicates internally (the paper's §4 invariant).

The controller, its report and the remap are verbatim copies of the
reference's, ``remap_zero_state`` on the port's ``ZeroState`` (a
dataclass).  ``zero1_master_layout`` takes the port's local leaves, as
the master is packed from them; the survivor mesh is a cut of the world
(``launch.mesh.survivor_mesh``), and ``reshard_tree`` moves host
tensors onto this rank's device and slice.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core.topology import HetTopology
from repro_torch.launch.mesh import survivor_mesh  # noqa: F401  (the reference's export)

from . import tree as tree_lib


def fingerprint_digest(fp: Any) -> str:
    """Short stable digest of a topology fingerprint (the raw
    fingerprint is a nested float tuple — unreadable in logs)."""
    return hashlib.sha1(repr(fp).encode()).hexdigest()[:12]


# ---------------------------------------------------------------------------
# ZeRO-1 master remap (slice remap through the PackedLayout slot map)
# ---------------------------------------------------------------------------

def _layout_of(meta_or_layout: Any) -> packing.PackedLayout:
    return getattr(meta_or_layout, "layout", meta_or_layout)


def remap_flat(flat: Any, old_meta: Any, new_meta: Any, *,
               old_world: int, new_world: int,
               n_columns: int = 1) -> np.ndarray:
    """Remap one global flat master buffer from the old intra world to
    the new one.  ``flat`` is the host copy of the global array: the
    rank-major concatenation of per-rank shards (``n_columns`` > 1 for
    TP — each data rank holds one shard per TP column, column-minor, as
    ``P((intra, tp))`` lays them out).  Every copy is derived from
    ``packing.remap_shard_ops`` — the slot-map slice remap, not a
    re-flatten — and raises ``ValueError`` when the layouts are not
    remappable (fall back to checkpoint restore)."""
    old_layout, new_layout = _layout_of(old_meta), _layout_of(new_meta)
    ops = packing.remap_shard_ops(old_layout, new_layout,
                                  old_world=old_world, new_world=new_world)
    flat = np.asarray(flat)
    shard_old = old_layout.padded_total // old_world
    shard_new = new_layout.padded_total // new_world
    if flat.size != old_world * n_columns * shard_old:
        raise ValueError(
            f"remap_flat: buffer has {flat.size} elements, expected "
            f"{old_world} rank(s) x {n_columns} column(s) x {shard_old}")
    view = flat.reshape(old_world, n_columns, shard_old)
    out = np.zeros((new_world, n_columns, shard_new), flat.dtype)
    for c in range(n_columns):
        new_shards = packing.apply_remap_ops(
            ops, [view[r, c] for r in range(old_world)], shard_new)
        for r in range(new_world):
            out[r, c] = new_shards[r]
    return out.reshape(-1)


def remap_zero_state(state: Any, old_meta: Any, new_meta: Any, *,
                     old_world: int, new_world: int,
                     n_columns: int = 1) -> Any:
    """Remap a host-resident ``ZeroState`` (flat_param/mu/nu global
    buffers + step scalar) onto the new intra world.  The optimizer
    moments ride the same slot map as the master params — padding tails
    are zeros on both sides, so the remap is exact.  Raises
    ``ValueError`` when not slot-map remappable; the caller then
    restores from checkpoint with the new shardings instead."""
    def remap(a):
        return remap_flat(a, old_meta, new_meta, old_world=old_world,
                          new_world=new_world, n_columns=n_columns)
    return dataclasses.replace(state, flat_param=remap(state.flat_param),
                               mu=remap(state.mu), nu=remap(state.nu))


def zero1_master_layout(leaves: Any, intra_size: int) -> packing.PackedLayout:
    """The packed per-wire-dtype ZeRO-1 master layout of this rank's
    local (TP-sharded) leaves over an intra world of ``intra_size``: the
    layout ``collectives._zero1_layout`` gives the bootstrap and the
    scattered sync.  Computed from the leaves' shapes alone, so the
    elastic remap can derive the old and the new layout before any step
    runs on the survivors."""
    return packing.plan_layout(packing.tree_metas(leaves),
                               world=max(1, int(intra_size)),
                               block=packing.DEFAULT_BLOCK)


def reshard_tree(tree: Any, device: Any = None, shardings: Any = None) -> Any:
    """Host copies of ``tree``'s leaves (tensors or numpy arrays) moved
    onto the survivor's ``device``.  ``shardings`` is a matching tree of
    functions from the global tensor to this rank's slice; without it
    every leaf is replicated, as the param tree is on a data-only
    survivor mesh."""
    def host(x):
        return x.detach().cpu() if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.array(x, order="C"))

    flat = [host(x) for x in tree_lib.leaves(tree)]
    slicers = (tree_lib.leaves(shardings) if shardings is not None
               else [None] * len(flat))
    return tree_lib.unflatten(tree, [(s(x) if s is not None else x).to(device)
                                     for x, s in zip(flat, slicers)])


# ---------------------------------------------------------------------------
# The controller
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ElasticConfig:
    """Knobs for the detect->resume loop.

    ``on_straggler`` maps the current topology to its survivor when a
    persistent straggler is confirmed (e.g. ``lambda t:
    t.shrink_cluster(0, t.clusters[0].n_nodes // 2)``); left ``None``
    the controller records the detection but takes no action (the
    scheduler owns host replacement)."""

    straggler_patience: int = 3   # consecutive slow steps -> persistent
    max_resume_steps: int = 3     # resume-latency bound (steps)
    on_straggler: Callable[[HetTopology], HetTopology] | None = None
    step_flops: float = 0.0       # > 0: re-run skew.optimize jointly
    total_microbatches: int = 8


@dataclasses.dataclass
class ReplanReport:
    """One elastic transition, as surfaced by ``--elastic``."""

    trigger: str        # "pod_failure" | "straggler" | "degraded_link"
    detail: str
    step_detected: int
    old_fingerprint: str          # digests (fingerprint_digest)
    new_fingerprint: str
    invalidated_entries: int      # plan-cache lines dropped
    replan_latency_s: float
    plan_mode: str | None = None
    validated: bool = False
    validated_via: str | None = None
    skew_microbatches: tuple | None = None
    steps_lost: int | None = None          # filled by resumed()
    remap_path: str | None = None          # "slot_map" | "restore_fallback"
    within_bound: bool | None = None       # steps_lost <= max_resume_steps

    def summary(self) -> dict:
        return dataclasses.asdict(self)

    def describe(self) -> str:
        out = (f"[elastic] {self.trigger} at step {self.step_detected} "
               f"({self.detail}): re-planned "
               f"{self.old_fingerprint} -> {self.new_fingerprint} in "
               f"{self.replan_latency_s * 1e3:.1f} ms "
               f"({self.invalidated_entries} stale cache line(s) "
               f"invalidated, plan {self.plan_mode} "
               f"validated via {self.validated_via})")
        if self.steps_lost is not None:
            out += (f"; resumed after {self.steps_lost} step(s) via "
                    f"{self.remap_path} "
                    f"[{'within' if self.within_bound else 'OVER'} the "
                    f"resume bound]")
        return out


class ElasticController:
    """State machine: ``healthy`` -> (detect) -> ``replanned`` ->
    (``resumed()``) -> ``healthy``.  Owns the current topology, the
    current plan, and the transition reports; the training driver owns
    the mesh rebuild and the state remap (helpers above)."""

    def __init__(self, topo: HetTopology, bucket_sizes: Sequence[int], *,
                 plan_cache: Any = None, straggler: Any = None,
                 config: ElasticConfig | None = None,
                 plan_kw: dict | None = None):
        self.topo = topo
        self.bucket_sizes = [int(b) for b in bucket_sizes]
        self.plan_cache = plan_cache
        self.straggler = straggler
        self.cfg = config or ElasticConfig()
        self.plan_kw = dict(plan_kw or {})
        self.state = "healthy"
        self.plan = None
        self.skew_plan = None
        self.reports: list[ReplanReport] = []
        self._slow_streak = 0

    # -- detect -------------------------------------------------------------
    def observe_step(self, step: int, *, slow: bool = False
                     ) -> ReplanReport | None:
        """Feed one training step's straggler verdict (the return value
        of ``StragglerMonitor.stop()``).  Returns a ``ReplanReport``
        when a persistent straggler is confirmed AND
        ``cfg.on_straggler`` yields a survivor topology, else None."""
        if self.state == "replanned":
            return None  # transition in flight; waiting for resumed()
        if not slow:
            self._slow_streak = 0
            return None
        self._slow_streak += 1
        if self._slow_streak < self.cfg.straggler_patience:
            return None
        self._slow_streak = 0
        if self.cfg.on_straggler is None:
            return None
        survivor = self.cfg.on_straggler(self.topo)
        if survivor.fingerprint() == self.topo.fingerprint():
            return None
        return self._replan(
            "straggler",
            f"{self.cfg.straggler_patience} consecutive slow steps",
            survivor, step)

    def report_pod_failure(self, step: int, cluster_index: int
                           ) -> ReplanReport:
        """A whole cluster died (externally observed — the fabric or
        the scheduler reports it; there is no in-band signal once its
        ranks stop answering)."""
        lost = self.topo.clusters[cluster_index].name
        survivor = self.topo.drop_cluster(cluster_index)
        return self._replan(
            "pod_failure", f"lost cluster {cluster_index} ({lost})",
            survivor, step)

    def report_degraded_link(self, step: int, cluster_index: int,
                             measured_Bps: float) -> ReplanReport | None:
        """A link got slow — the ``CollectiveGuard``'s per-link
        bandwidth EWMA confirmed cluster ``cluster_index``'s NIC
        delivering ``measured_Bps`` instead of its nominal beta.  The
        survivor topology is the same shape *derated* to the measured
        bandwidth (``HetTopology.derate_cluster``), so the re-plan
        prices every C2C term at what the fabric actually delivers —
        PR 9's recovery extended from "pod died" to "link got slow".
        No reshard is needed (the mesh is unchanged); the driver just
        rebuilds the step with the new plan.  Returns ``None`` when the
        measurement equals the current nominal (nothing to re-plan)."""
        if self.state == "replanned":
            return None  # transition in flight; waiting for resumed()
        c = self.topo.clusters[cluster_index]
        survivor = self.topo.derate_cluster(cluster_index,
                                            float(measured_Bps))
        if survivor.fingerprint() == self.topo.fingerprint():
            return None
        return self._replan(
            "degraded_link",
            f"cluster {cluster_index} ({c.name}) nic_Bps "
            f"{c.nic_Bps:.3g} -> {float(measured_Bps):.3g}",
            survivor, step)

    # -- re-plan ------------------------------------------------------------
    def _replan(self, trigger: str, detail: str, survivor: HetTopology,
                step: int) -> ReplanReport:
        from repro_torch.core import planner as planner_lib

        t0 = time.perf_counter()
        old_fp = self.topo.fingerprint()
        invalidated = (self.plan_cache.invalidate(old_fp)
                       if self.plan_cache is not None else 0)
        kw = dict(self.plan_kw)
        kw["cache"] = self.plan_cache
        if survivor.n_clusters <= 1:
            # the survivor mesh has no pod axis; C2C steps would be
            # no-ops anyway, but the plan should price what will run
            kw["pod_axis"] = None
        skew_mb = None
        if self.cfg.step_flops > 0:
            from repro_torch.core import skew as skew_lib
            self.skew_plan = skew_lib.optimize(
                survivor, self.cfg.step_flops, self.bucket_sizes,
                total_microbatches=max(survivor.n_clusters,
                                       self.cfg.total_microbatches),
                **kw)
            self.plan = self.skew_plan.plan
            skew_mb = tuple(self.skew_plan.split.microbatches)
        else:
            self.plan = planner_lib.plan(survivor, self.bucket_sizes, **kw)
        latency = time.perf_counter() - t0
        if self.straggler is not None:
            # a replaced/evicted host must not inherit (or be judged
            # against) the old fleet's trailing median
            self.straggler.reset()
        report = ReplanReport(
            trigger=trigger, detail=detail, step_detected=step,
            old_fingerprint=fingerprint_digest(old_fp),
            new_fingerprint=fingerprint_digest(survivor.fingerprint()),
            invalidated_entries=invalidated, replan_latency_s=latency,
            plan_mode=self.plan.recommended_mode(),
            validated=bool(self.plan.validated),
            validated_via=self.plan.validated_via,
            skew_microbatches=skew_mb)
        self.topo = survivor
        self.reports.append(report)
        self.state = "replanned"
        self._slow_streak = 0
        return report

    # -- resume -------------------------------------------------------------
    def resumed(self, step: int, *, remap_path: str = "slot_map"
                ) -> ReplanReport:
        """The driver finished resharding and is stepping again: close
        the transition.  ``remap_path`` records how the ZeRO-1 state
        crossed — ``"slot_map"`` (online slice remap) or
        ``"restore_fallback"`` (checkpoint restore with new
        shardings)."""
        if not self.reports or self.state != "replanned":
            raise RuntimeError("resumed() without a pending re-plan")
        rep = self.reports[-1]
        rep.steps_lost = max(0, int(step) - rep.step_detected)
        rep.remap_path = remap_path
        rep.within_bound = rep.steps_lost <= self.cfg.max_resume_steps
        self.state = "healthy"
        return rep
