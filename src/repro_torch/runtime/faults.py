"""Seeded chaos engine: deterministic fault plans and the injector that
lands them in the data path (the JAX package's ``runtime/faults.py``).

A ``FaultPlan`` is a seeded, deterministic schedule of ``FaultEvent``s,
and a ``FaultInjector`` turns each event into a perturbation:

  * ``degraded_link``  — beta x k on one cluster's NIC: the injector
    inflates the guard's transfer-observation feed (``t x k``), since
    nothing here can slow the fabric itself.
  * ``transient``      — a transfer attempt raises
    ``TransientTransferError``; the guard's bounded retry absorbs it.
  * ``hang``           — a rank stalls past the guard's deadline
    (``sleep_s(step)``); heartbeats attribute the hang to it.
  * ``nan_payload`` / ``bitflip`` — payload corruption through the
    collective seam (``core.primitives.inject_hook``): NaN into a float
    buffer, or one flipped bit of the payload's wire representation
    (for int8 inside a real quantized block).  Only the planned rank
    corrupts its payload (``corruption_hook``'s ``rank``).

The plan, the events and the injector's host-side seams are verbatim
copies of the reference's; the corruption bodies act on tensors.  The
same seed replays the same fault sequence.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable, Sequence

import numpy as np
import torch

FAULT_KINDS = ("degraded_link", "transient", "hang", "nan_payload",
               "bitflip")
# payload-corruption kinds land through the inject hook
CORRUPTION_KINDS = ("nan_payload", "bitflip")


class TransientTransferError(RuntimeError):
    """A C2C transfer attempt failed transiently (injected or real);
    the guard's bounded retry is the expected handler."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.  ``step`` is the first training step the
    fault is active; ``duration`` how many consecutive steps it stays
    active (1 for point faults; degraded links persist).  ``cluster``
    attributes link faults, ``rank`` attributes rank faults.
    ``factor`` is the beta inflation of a degraded link (k in
    "beta x k") and the deadline multiple a hang stalls for."""

    kind: str
    step: int
    duration: int = 1
    cluster: int | None = None
    rank: int | None = None
    factor: float = 1.0
    detail: str = ""

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(known: {FAULT_KINDS})")
        if self.step < 0 or self.duration < 1:
            raise ValueError(f"bad fault window step={self.step} "
                             f"duration={self.duration}")

    def active_at(self, step: int) -> bool:
        return self.step <= step < self.step + self.duration

    def summary(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, deterministic schedule of faults."""

    seed: int
    events: tuple[FaultEvent, ...]

    @classmethod
    def generate(cls, seed: int, n_steps: int, *,
                 n_clusters: int = 2, n_ranks: int = 8,
                 classes: Sequence[str] = FAULT_KINDS,
                 first_step: int = 1,
                 degrade_factor: float = 4.0,
                 degrade_duration: int | None = None) -> "FaultPlan":
        """One fault per requested class at distinct seeded steps in
        ``[first_step, n_steps)``, targets (cluster/rank) drawn from the
        same PCG64 stream.  Pure function of its arguments: identical
        calls yield identical plans (property-tested).

        ``first_step`` defaults past step 0 so the guard's calibration
        window sees at least one clean step.  A degraded link persists
        to the end of the run unless ``degrade_duration`` bounds it —
        slow links don't heal themselves; recovery is the planner's
        job."""
        classes = tuple(classes)
        unknown = [c for c in classes if c not in FAULT_KINDS]
        if unknown:
            raise ValueError(f"unknown fault classes {unknown} "
                             f"(known: {FAULT_KINDS})")
        span = n_steps - first_step
        if span < len(classes):
            raise ValueError(
                f"cannot place {len(classes)} faults in steps "
                f"[{first_step}, {n_steps})")
        rng = np.random.Generator(np.random.PCG64(int(seed)))
        steps = sorted(rng.choice(span, size=len(classes),
                                  replace=False) + first_step)
        order = list(classes)
        rng.shuffle(order)
        events = []
        for kind, step in zip(order, steps):
            step = int(step)
            if kind == "degraded_link":
                dur = (degrade_duration if degrade_duration is not None
                       else n_steps - step)
                events.append(FaultEvent(
                    kind, step, duration=max(1, int(dur)),
                    cluster=int(rng.integers(n_clusters)),
                    factor=float(degrade_factor)))
            elif kind == "hang":
                events.append(FaultEvent(
                    kind, step, rank=int(rng.integers(n_ranks)),
                    factor=1.5))
            elif kind == "transient":
                events.append(FaultEvent(
                    kind, step, cluster=int(rng.integers(n_clusters))))
            else:  # nan_payload / bitflip
                events.append(FaultEvent(
                    kind, step, rank=int(rng.integers(n_ranks))))
        return cls(seed=int(seed),
                   events=tuple(sorted(events, key=lambda e: e.step)))

    # -- queries -------------------------------------------------------------
    def events_at(self, step: int) -> tuple[FaultEvent, ...]:
        """Events whose active window covers ``step``."""
        return tuple(e for e in self.events if e.active_at(step))

    def starting_at(self, step: int) -> tuple[FaultEvent, ...]:
        """Events that begin exactly at ``step``."""
        return tuple(e for e in self.events if e.step == step)

    def link_factors(self, step: int) -> dict[int, float]:
        """Active beta-inflation per cluster: ``{cluster: k}`` for every
        degraded link covering ``step`` (factors of overlapping events
        on the same cluster multiply)."""
        out: dict[int, float] = {}
        for e in self.events_at(step):
            if e.kind == "degraded_link" and e.cluster is not None:
                out[e.cluster] = out.get(e.cluster, 1.0) * e.factor
        return out

    def link_scale(self, step: int) -> dict[int, float]:
        """The ``transport_sim.simulate_schedule(link_scale=...)`` view
        of the active degradations: bandwidth multipliers (1/k)."""
        return {ci: 1.0 / k for ci, k in self.link_factors(step).items()}

    def degrade_topology(self, topo: Any, step: int) -> Any:
        """The fabric as it actually performs at ``step``: every active
        degraded link's cluster derated to nominal/k."""
        from repro_torch.core.transport_sim import apply_link_scale
        return apply_link_scale(topo, self.link_scale(step))

    def summary(self) -> dict:
        return {"seed": self.seed,
                "events": [e.summary() for e in self.events]}


# ---------------------------------------------------------------------------
# Payload corruption (the hook's bodies)
# ---------------------------------------------------------------------------

# the same-width integer view of each float dtype (the bits are flipped there)
_INT_VIEW = {torch.float64: torch.int64, torch.float32: torch.int32,
             torch.bfloat16: torch.int16, torch.float16: torch.int16}


def corrupt_nan(buf: torch.Tensor) -> torch.Tensor:
    """Poison element 0 of a float buffer with NaN (a corrupted
    gradient), in a copy.  Non-float buffers pass through untouched: NaN
    is not representable there (an int8 wire block takes
    :func:`corrupt_bitflip`)."""
    if not buf.is_floating_point():
        return buf
    out = buf.clone()
    out.view(-1)[0] = float("nan")
    return out


def corrupt_bitflip(buf: torch.Tensor, bit: int | None = None) -> torch.Tensor:
    """Flip one bit of element 0, in a copy, in the payload's wire
    representation: integers (the int8 blocks of the codec) are XORed
    directly, floats through the same-width integer view (bf16 through
    ``torch.int16``).  The default bit is the reference's: a high
    mantissa bit of a float (``nbits - 10``), bit ``nbits - 2`` of an
    integer, so the corruption is visible but finite."""
    if buf.is_floating_point():
        nbits = buf.element_size() * 8
        b = bit if bit is not None else nbits - 10
        out = buf.clone()
        ints = out.view(-1).view(_INT_VIEW[buf.dtype])
        ints[0] = ints[0] ^ _signed_bit(b, nbits)
        return out
    if buf.dtype == torch.bool:
        return buf
    nbits = buf.element_size() * 8
    b = bit if bit is not None else nbits - 2
    out = buf.clone()
    flat = out.view(-1)
    flat[0] = flat[0] ^ _signed_bit(b, nbits) if buf.is_signed() else flat[0] ^ (1 << b)
    return out


def _signed_bit(b: int, nbits: int) -> int:
    """1 << b as a two's-complement value of an ``nbits``-bit signed
    integer (the top bit is negative)."""
    return -(1 << b) if b == nbits - 1 else 1 << b


def _corrupt_payload(buf: Any, kind: str) -> Any:
    """Apply one corruption to a payload that may be a bare tensor or
    the codec's encoded tuple: for int8 that is ``(q, scale)`` and the
    corruption lands in ``q`` (a real bit-flipped int8 block; NaN on it
    is a no-op, as in the reference)."""
    if isinstance(buf, tuple):
        return (_corrupt_payload(buf[0], kind),) + tuple(buf[1:])
    if kind == "nan_payload":
        return corrupt_nan(buf)
    return corrupt_bitflip(buf)


# ---------------------------------------------------------------------------
# The injector
# ---------------------------------------------------------------------------

class FaultInjector:
    """Turns a ``FaultPlan`` into concrete perturbations and keeps the
    ground-truth log the chaos harness scores detections against.

    Host-side faults (``sleep_s``, ``wrap_transfer``,
    ``perturb_transfer_time``) act per step.  Payload corruption acts on
    the collective calls made while ``corruption_hook(step)`` is
    installed through ``core.primitives.inject_hook``: the harness runs
    the faulted step inside that context, and only that step."""

    def __init__(self, plan: FaultPlan, *,
                 corrupt_phases: Iterable[str] = ("c2c", "chunk_c2c",
                                                  "intra_rs", "flat")):
        self.plan = plan
        self.corrupt_phases = tuple(corrupt_phases)
        self.injected: list[dict] = []

    def _log(self, step: int, event: FaultEvent, action: str) -> None:
        self.injected.append({"step": int(step), "kind": event.kind,
                              "cluster": event.cluster,
                              "rank": event.rank,
                              "factor": event.factor, "action": action})

    # -- hang ---------------------------------------------------------------
    def sleep_s(self, step: int, deadline_s: float) -> float:
        """Stall duration for a hang active at ``step``: the event's
        ``factor`` x the guard's current deadline, so the stall is
        guaranteed past the deadline regardless of calibration."""
        total = 0.0
        for e in self.plan.events_at(step):
            if e.kind == "hang":
                total += e.factor * deadline_s
                self._log(step, e, f"stall {e.factor:.1f}x deadline")
        return total

    def stall(self, step: int, deadline_s: float) -> float:
        """Actually sleep the hang duration (the harness's in-band way
        to hang "a rank" in a single emulated process); returns the
        seconds slept."""
        s = self.sleep_s(step, deadline_s)
        if s > 0:
            time.sleep(s)
        return s

    def hung_ranks(self, step: int) -> tuple[int, ...]:
        """Ground truth for heartbeat attribution: ranks hanging at
        ``step`` (they will not heartbeat)."""
        return tuple(e.rank for e in self.plan.events_at(step)
                     if e.kind == "hang" and e.rank is not None)

    # -- transient transfer failures ----------------------------------------
    def transient_attempts(self, step: int) -> int:
        """How many transfer attempts fail at ``step`` before one
        succeeds (0 when no transient fault is active)."""
        return sum(1 for e in self.plan.events_at(step)
                   if e.kind == "transient")

    def wrap_transfer(self, step: int, fn: Callable[..., Any]
                      ) -> Callable[..., Any]:
        """Wrap a transfer thunk so its first ``transient_attempts``
        calls at ``step`` raise ``TransientTransferError`` — the guard's
        ``retry`` absorbs exactly that many failures."""
        fails = {"left": self.transient_attempts(step)}
        evs = [e for e in self.plan.events_at(step) if e.kind == "transient"]

        def wrapped(*a, **kw):
            if fails["left"] > 0:
                fails["left"] -= 1
                for e in evs:
                    self._log(step, e, "transfer attempt failed")
                raise TransientTransferError(
                    f"injected transient transfer failure at step {step}")
            return fn(*a, **kw)
        return wrapped

    # -- degraded links ------------------------------------------------------
    def perturb_transfer_time(self, step: int, cluster: int,
                              t_s: float) -> float:
        """The emulated-fabric landing site for link degradation: the
        observed transfer time for ``cluster``'s link, inflated by the
        active beta factor.  On a real fabric the slow wire inflates the
        measurement itself; the emulated CPU fabric cannot slow down, so
        the injector perturbs the observation feed — the guard's EWMA
        sees exactly what a degraded link would produce."""
        k = self.plan.link_factors(step).get(cluster, 1.0)
        if k != 1.0:
            for e in self.plan.events_at(step):
                if e.kind == "degraded_link" and e.cluster == cluster:
                    self._log(step, e, f"transfer time x{k:g}")
        return t_s * k

    # -- payload corruption -------------------------------------------------
    def corruption_hook(self, step: int, rank: int | None = None
                        ) -> Callable[[Any, str], Any] | None:
        """Hook for ``core.primitives.inject_hook`` applying the
        payload corruptions active at ``step`` (None when there are
        none).  The hook corrupts the first matching phase it sees and
        passes everything else through.

        ``rank`` is this process's rank in the world, the reference's
        major-first rank over (pod, data, model), (p * D + d) * T + m: with
        it, only the event's ``rank`` corrupts its payload, as the
        reference gates the corruption per device (an ungated flip on
        every rank could cancel in the combining reduction, and one
        faulty sender is what a real corruption looks like).  Every rank
        logs the event and spends it alike, so the ranks' logs agree.
        Without ``rank`` the corruption is unconditional (single-tensor
        unit tests)."""
        evs = [e for e in self.plan.events_at(step)
               if e.kind in CORRUPTION_KINDS]
        if not evs:
            return None
        fired: set[str] = set()

        def hook(buf, phase):
            if phase not in self.corrupt_phases:
                return buf
            for e in evs:
                if e.kind in fired:
                    continue
                fired.add(e.kind)
                self._log(step, e, f"corrupted {phase} payload")
                if rank is None or e.rank is None or e.rank == rank:
                    buf = _corrupt_payload(buf, e.kind)
            return buf
        return hook

    def summary(self) -> dict:
        return {"plan": self.plan.summary(), "injected": list(self.injected)}
