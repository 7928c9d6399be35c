"""Collective guard: detect hangs, desyncs, corrupted payloads, and
degraded links in the collective data path — and route each to its
recovery (the JAX package's ``runtime/guard.py``; DESIGN.md §16).

Four detectors, one per failure class the chaos engine
(``runtime/faults.py``) can inject:

  * **deadline** — a per-step comm deadline derived from the cost
    model's predicted step time x a margin, floored by a wall-clock
    calibration over the first warmup steps (on the emulated CPU
    fabric the model's fabric-seconds are not wall-comparable, so the
    effective deadline is ``margin x max(predicted, calibrated
    median)``).  A step overrunning it is a *hang*; heartbeats
    attribute it to the silent rank(s).
  * **desync** — a pre-launch schedule-digest agreement check:
    ``schedule_digest`` fingerprints what each rank is about to run
    (modes, chunking, compression, cluster weights — never timing
    floats), and ``verify_agreement`` flags the outlier ranks before a
    mismatched collective can deadlock the fabric.
  * **payload** — optional finiteness check + CRC32 checksum over the
    synced tree, catching NaN gradients and bit-flipped blocks after
    the wire.
  * **link health** — per-link bandwidth EWMA over observed transfer
    times, fitted with ``transport_sim.fit_alpha_beta`` (the paper's
    Fig. 11 synthesis) on a sliding window; a confirmed degraded
    verdict escalates to ``ElasticController.report_degraded_link``,
    which re-plans against the derated topology.

Transient failures get a **bounded retry** with exponential backoff +
deterministic jitter; exhaustion raises ``PersistentCommFailure`` (the
driver escalates — a link that never answers is a pod failure, not a
blip).

Every verdict is recorded as a ``GuardEvent``; ``report()`` summarizes
them in the shape the chaos harness and the CI summary render.

The detectors, the link health and the retry are verbatim copies of the
reference's.  ``payload_checksum`` and ``nonfinite_leaves`` walk a tree
of tensors, numpy arrays and numbers in the reference's leaf order
(``runtime/tree.py``): the checksum is the CRC32 of each leaf's bytes
(a bf16 tensor's 2-byte words), so equal values checksum as in the
reference, and a tensor is copied to the host for it, as the reference
copies every leaf.  ``schedule_digest`` takes the port's
``CommConfig`` (groups, keyed as the reference's axes), ``BoundPlan``,
``CommPlan`` and ``Schedule``.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import statistics
import time
import zlib
from typing import Any, Callable, Iterable, Mapping

import numpy as np
import torch

from repro_torch.core.transport_sim import fit_alpha_beta
from .faults import TransientTransferError
from .tree import keystr, leaves, leaves_with_path


class PersistentCommFailure(RuntimeError):
    """Bounded retry exhausted: the failure is not transient."""


# ---------------------------------------------------------------------------
# Schedule digests (desync detector)
# ---------------------------------------------------------------------------

def schedule_digest(plan_or_cfg: Any) -> str:
    """Stable fingerprint of what a rank is about to launch: the
    schedule-*shape* decisions every rank must agree on — per-bucket
    (nbytes, mode, n_chunks, compression), the data path, and the
    cluster weights (they change the reduction arithmetic).  Timing
    floats (predictions, simulations) are deliberately excluded: two
    ranks that priced the same plan differently still agree.  Accepts a
    ``CommPlan`` or a ``BoundPlan`` (keyed as its plan), a
    ``CommConfig`` (its groups keyed as the reference's axes: ``"pod"``
    when a pod group exists, intra ``"data"``), or a schedule-IR
    ``Schedule``; the same schedule digests as in the reference."""
    if hasattr(plan_or_cfg, "plan") and hasattr(plan_or_cfg, "config_for"):
        plan_or_cfg = plan_or_cfg.plan                # BoundPlan
    if hasattr(plan_or_cfg, "buckets"):          # CommPlan
        p = plan_or_cfg
        key = ("plan", getattr(p, "data_path", None),
               tuple(p.cluster_weights) if getattr(
                   p, "cluster_weights", None) else None,
               tuple((b.nbytes, b.candidate.mode, b.candidate.n_chunks,
                      b.candidate.compression) for b in p.buckets))
    elif hasattr(plan_or_cfg, "intra_group"):    # CommConfig
        c = plan_or_cfg
        key = ("config", c.mode, "pod" if c.pod_group is not None else None,
               "data", c.n_chunks, c.compression,
               tuple(c.cluster_weights) if c.cluster_weights else None)
    elif hasattr(plan_or_cfg, "steps"):          # schedule_ir.Schedule
        s = plan_or_cfg
        key = ("schedule", s.mode, s.n_chunks, s.compression,
               tuple(type(st).__name__ for st in s.steps))
    else:
        raise TypeError(f"schedule_digest: cannot fingerprint "
                        f"{type(plan_or_cfg).__name__}")
    return hashlib.sha1(repr(key).encode()).hexdigest()[:12]


def digest_agreement(digests: Mapping[int, str]
                     ) -> tuple[bool, str, tuple[int, ...]]:
    """(all_agree, majority_digest, outlier_ranks) over per-rank
    schedule digests.  Majority by count (ties broken by digest value
    for determinism); outliers are the ranks to fence before launch."""
    if not digests:
        raise ValueError("digest_agreement: no digests")
    counts = collections.Counter(digests.values())
    majority = max(sorted(counts), key=lambda d: counts[d])
    outliers = tuple(sorted(r for r, d in digests.items() if d != majority))
    return not outliers, majority, outliers


# ---------------------------------------------------------------------------
# Payload integrity
# ---------------------------------------------------------------------------

def _leaf_bytes(leaf: Any) -> bytes:
    """A leaf's byte representation on the host: a tensor's elements in
    its dtype (bf16 as its 2-byte words), an array's, a number's as
    ``np.asarray`` gives it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    return np.asarray(leaf).tobytes()


def payload_checksum(tree: Any) -> int:
    """CRC32 over every leaf's byte representation (host-side; order is
    the deterministic leaf order of ``runtime/tree.py``).  Equal trees
    checksum equal; a single flipped wire bit does not."""
    crc = 0
    for leaf in leaves(tree):
        crc = zlib.crc32(_leaf_bytes(leaf), crc)
    return crc


def _nonfinite(leaf: Any) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.is_floating_point() and not bool(torch.isfinite(leaf).all())
    a = np.asarray(leaf)
    return np.issubdtype(a.dtype, np.floating) and not np.all(np.isfinite(a))


def nonfinite_leaves(tree: Any) -> tuple[str, ...]:
    """Paths of float leaves containing NaN/Inf (empty when clean); a
    tensor is checked on its own device."""
    return tuple(keystr(path) for path, leaf in leaves_with_path(tree)
                 if _nonfinite(leaf))


# ---------------------------------------------------------------------------
# Link health (bandwidth EWMA -> degraded verdict)
# ---------------------------------------------------------------------------

class LinkHealth:
    """Per-link bandwidth estimation from observed transfer times.

    Each observation is an (nbytes, seconds) sample for one link (keyed
    by cluster index).  Over a sliding window the α–β fit
    (``fit_alpha_beta``) separates launch latency from bandwidth; the
    fitted beta feeds an EWMA, and an EWMA persistently below
    ``nominal / degraded_factor`` for ``patience`` consecutive
    observations is a *degraded* verdict — persistence filters the
    transient dips a single slow transfer would cause."""

    def __init__(self, nominal_Bps: Mapping[int, float], *,
                 window: int = 8, ewma_alpha: float = 0.4,
                 degraded_factor: float = 2.0, patience: int = 3):
        if not 0 < ewma_alpha <= 1:
            raise ValueError(f"ewma_alpha must be in (0, 1], got {ewma_alpha}")
        self.nominal = dict(nominal_Bps)
        self.window = int(window)
        self.alpha = float(ewma_alpha)
        self.factor = float(degraded_factor)
        self.patience = int(patience)
        self._samples: dict[int, collections.deque] = {}
        self.ewma_Bps: dict[int, float] = {}
        self._slow_streak: dict[int, int] = {}
        self._flagged: set[int] = set()

    def observe(self, link: int, nbytes: int, t_s: float) -> float | None:
        """Feed one transfer sample; returns the link's updated EWMA
        bandwidth (None until two samples exist).  Non-positive or
        non-finite samples are dropped — same contract as the
        straggler monitor's clock-skew guard."""
        if not (t_s > 0 and np.isfinite(t_s)) or nbytes <= 0:
            return self.ewma_Bps.get(link)
        q = self._samples.setdefault(link,
                                     collections.deque(maxlen=self.window))
        q.append((int(nbytes), float(t_s)))
        if len(q) < 2:
            return None
        _, beta = fit_alpha_beta([s for s, _ in q], [t for _, t in q])
        if not (beta > 0 and np.isfinite(beta)):
            return self.ewma_Bps.get(link)
        prev = self.ewma_Bps.get(link)
        ewma = beta if prev is None else (self.alpha * beta
                                          + (1 - self.alpha) * prev)
        self.ewma_Bps[link] = ewma
        nominal = self.nominal.get(link)
        if nominal is not None and ewma < nominal / self.factor:
            self._slow_streak[link] = self._slow_streak.get(link, 0) + 1
        else:
            self._slow_streak[link] = 0
        return ewma

    def degraded(self, link: int) -> bool:
        """Confirmed-degraded verdict (one-shot per link: after the
        escalation re-plans, the new nominal owns the judgement)."""
        if link in self._flagged:
            return False
        if self._slow_streak.get(link, 0) >= self.patience:
            self._flagged.add(link)
            return True
        return False

    def rebase(self, link: int, nominal_Bps: float) -> None:
        """Adopt a new nominal after a re-plan (the derated topology's
        bandwidth is now the baseline) and re-arm the verdict."""
        self.nominal[link] = float(nominal_Bps)
        self._slow_streak[link] = 0
        self._flagged.discard(link)


# ---------------------------------------------------------------------------
# The guard
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GuardConfig:
    """Knobs for the four detectors.

    ``deadline_margin`` multiplies the predicted/calibrated step time;
    ``warmup_steps`` is the wall-clock calibration window (no deadline
    is armed until it fills — zero false positives by construction
    while calibrating); ``min_deadline_s`` floors the result against
    timer jitter on trivially small steps."""

    deadline_margin: float = 4.0
    min_deadline_s: float = 0.05
    warmup_steps: int = 5
    max_retries: int = 3
    backoff_base_s: float = 0.05
    backoff_jitter: float = 0.5     # fraction of the backoff, seeded
    checksums: bool = True
    link_window: int = 8
    ewma_alpha: float = 0.4
    degraded_factor: float = 2.0
    degraded_patience: int = 3
    seed: int = 0


@dataclasses.dataclass
class GuardEvent:
    """One detection (or retry) verdict."""

    kind: str          # hang | desync | corrupt_payload | degraded_link
    #                  | transient_retry | persistent_failure
    step: int
    attribution: str   # "rank 3" / "link 1" / leaf path — who/where
    detail: str = ""
    deadline_s: float | None = None
    measured: float | None = None
    replan: Any = None             # ReplanReport when escalation re-planned

    def summary(self) -> dict:
        d = dataclasses.asdict(self)
        d["replan"] = (self.replan.summary()
                       if hasattr(self.replan, "summary") else self.replan)
        return d


class CollectiveGuard:
    """Deadline + desync + payload + link-health detectors with the
    bounded-retry escalation path.  One instance per training run;
    ``elastic`` (an ``ElasticController``) is the escalation target for
    degraded links."""

    def __init__(self, cfg: GuardConfig | None = None, *,
                 predicted_step_s: float | None = None,
                 nominal_Bps: Mapping[int, float] | None = None,
                 expected_ranks: Iterable[int] = (),
                 elastic: Any = None):
        self.cfg = cfg or GuardConfig()
        self.predicted_step_s = predicted_step_s
        self.expected_ranks = tuple(expected_ranks)
        self.elastic = elastic
        self.links = LinkHealth(
            nominal_Bps or {}, window=self.cfg.link_window,
            ewma_alpha=self.cfg.ewma_alpha,
            degraded_factor=self.cfg.degraded_factor,
            patience=self.cfg.degraded_patience)
        self.events: list[GuardEvent] = []
        self._warmup: list[float] = []
        self._heartbeats: dict[int, set[int]] = {}
        self._rng = np.random.Generator(np.random.PCG64(self.cfg.seed))
        self._checksums: dict[int, int] = {}

    # -- deadline (hang detector) -------------------------------------------
    @property
    def deadline_s(self) -> float | None:
        """Effective comm deadline: ``margin x max(predicted step time,
        calibrated wall median)``, floored at ``min_deadline_s``.  None
        (not armed) until the wall-clock warmup window fills — the
        plan's prediction can only *raise* the base, never substitute
        for calibration: predicted times describe the modeled fabric,
        and on a substrate where they undershoot real step time
        (e.g. the emulated-CPU fabric, where sub-ms predicted syncs
        meet multi-ms wall steps) an uncalibrated deadline would flag
        every healthy step as a hang."""
        if len(self._warmup) < self.cfg.warmup_steps:
            return None
        base = statistics.median(self._warmup)
        if self.predicted_step_s is not None:
            base = max(base, float(self.predicted_step_s))
        if base <= 0.0:
            return None
        return max(self.cfg.min_deadline_s,
                   self.cfg.deadline_margin * base)

    def heartbeat(self, step: int, rank: int) -> None:
        """A rank reports liveness for ``step`` (on a real deployment
        the per-rank host proxies feed this; the emulated harness feeds
        every non-hung rank)."""
        self._heartbeats.setdefault(step, set()).add(rank)

    def observe_step_time(self, step: int, dt_s: float
                          ) -> GuardEvent | None:
        """Feed one step's measured wall time.  Returns a ``hang``
        event when the armed deadline is overrun — attributed to the
        ranks that did not heartbeat this step (or "unattributed" when
        heartbeats aren't wired).  In-deadline samples extend the
        calibration window."""
        if not (dt_s > 0 and np.isfinite(dt_s)):
            return None
        deadline = self.deadline_s
        if deadline is not None and dt_s > deadline:
            silent = (tuple(sorted(set(self.expected_ranks)
                                   - self._heartbeats.get(step, set())))
                      if self.expected_ranks else ())
            attribution = (f"rank {','.join(map(str, silent))}" if silent
                           else "unattributed")
            ev = GuardEvent(
                kind="hang", step=step, attribution=attribution,
                detail=f"step took {dt_s:.3f}s > deadline {deadline:.3f}s",
                deadline_s=deadline, measured=dt_s)
            self.events.append(ev)
            return ev
        if len(self._warmup) < 4 * self.cfg.warmup_steps:
            self._warmup.append(float(dt_s))
        return None

    # -- desync detector ------------------------------------------------------
    def check_agreement(self, step: int, digests: Mapping[int, str]
                        ) -> GuardEvent | None:
        """Pre-launch digest agreement over ``{rank: schedule_digest}``.
        Returns a ``desync`` event naming the outlier ranks, or None
        when every rank is about to run the same schedule."""
        ok, majority, outliers = digest_agreement(digests)
        if ok:
            return None
        ev = GuardEvent(
            kind="desync", step=step,
            attribution=f"rank {','.join(map(str, outliers))}",
            detail=f"{len(outliers)}/{len(digests)} rank(s) diverge "
                   f"from majority digest {majority}")
        self.events.append(ev)
        return ev

    # -- payload detector -----------------------------------------------------
    def check_payload(self, step: int, tree: Any, *,
                      phase: str = "post-sync") -> GuardEvent | None:
        """Integrity check on a synced tree: float leaves must be
        finite, and (when ``cfg.checksums``) the CRC32 is recorded so
        the harness can compare against an independently computed
        reference.  Returns a ``corrupt_payload`` event naming the bad
        leaves, or None."""
        bad = nonfinite_leaves(tree)
        if self.cfg.checksums:
            self._checksums[step] = payload_checksum(tree)
        if not bad:
            return None
        ev = GuardEvent(
            kind="corrupt_payload", step=step,
            attribution=bad[0] if len(bad) == 1 else f"{len(bad)} leaves",
            detail=f"non-finite {phase} leaves: "
                   f"{', '.join(bad[:4])}{'...' if len(bad) > 4 else ''}")
        self.events.append(ev)
        return ev

    def checksum_at(self, step: int) -> int | None:
        return self._checksums.get(step)

    # -- bounded retry --------------------------------------------------------
    def retry(self, step: int, fn: Callable[[], Any], *,
              transient: tuple = (TransientTransferError,),
              sleep: Callable[[float], None] = time.sleep) -> Any:
        """Run a transfer thunk with bounded retry: up to
        ``max_retries`` re-attempts on ``transient`` exceptions, backed
        off exponentially with seeded jitter (decorrelates the herd
        without breaking replay determinism).  Exhaustion raises
        ``PersistentCommFailure`` after recording a
        ``persistent_failure`` event — the driver escalates that the
        way it would a pod failure."""
        last: Exception | None = None
        for attempt in range(self.cfg.max_retries + 1):
            try:
                out = fn()
                if attempt:
                    self.events.append(GuardEvent(
                        kind="transient_retry", step=step,
                        attribution="c2c transfer",
                        detail=f"succeeded on attempt {attempt + 1} "
                               f"after {attempt} transient failure(s)",
                        measured=float(attempt)))
                return out
            except transient as e:
                last = e
                if attempt < self.cfg.max_retries:
                    backoff = self.cfg.backoff_base_s * (2 ** attempt)
                    backoff *= 1.0 + (self.cfg.backoff_jitter
                                      * float(self._rng.random()))
                    sleep(backoff)
        ev = GuardEvent(
            kind="persistent_failure", step=step,
            attribution="c2c transfer",
            detail=f"still failing after {self.cfg.max_retries + 1} "
                   f"attempts: {last}")
        self.events.append(ev)
        raise PersistentCommFailure(str(last)) from last

    # -- link health ----------------------------------------------------------
    def observe_transfer(self, step: int, link: int, nbytes: int,
                         t_s: float) -> GuardEvent | None:
        """Feed one observed C2C transfer for ``link`` (cluster index).
        When the bandwidth EWMA confirms degradation, escalates to
        ``elastic.report_degraded_link`` (if wired) and returns the
        ``degraded_link`` event carrying the ``ReplanReport``."""
        ewma = self.links.observe(link, nbytes, t_s)
        if not self.links.degraded(link):
            return None
        nominal = self.links.nominal.get(link)
        report = None
        if self.elastic is not None and ewma is not None:
            report = self.elastic.report_degraded_link(step, link, ewma)
            if report is not None:
                self.links.rebase(link, ewma)
        ev = GuardEvent(
            kind="degraded_link", step=step, attribution=f"link {link}",
            detail=(f"bandwidth EWMA {ewma:.3g} B/s vs nominal "
                    f"{nominal:.3g} B/s"
                    + (" — re-planned" if report is not None else "")),
            measured=ewma, replan=report)
        self.events.append(ev)
        return ev

    # -- reporting ------------------------------------------------------------
    def report(self) -> dict:
        counts = collections.Counter(e.kind for e in self.events)
        return {"deadline_s": self.deadline_s,
                "counts": dict(counts),
                "events": [e.summary() for e in self.events]}
