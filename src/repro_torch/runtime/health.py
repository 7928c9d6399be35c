"""Training-loop health: NaN/overflow watchdog with rollback, step-time
straggler detection, and the restart policy used by launch/train.py.

At thousand-node scale the failure modes this guards are: a bad batch /
numerics blowup (watchdog -> rollback to last checkpoint, skip the
window), a slow host (straggler detector -> surface + data-layer skip),
and process loss (handled by checkpoint restore on restart — see
CheckpointManager; the vendor-CCL failure semantics the paper defers to
(§8) map to jax's distributed runtime re-initialization here).
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np


@dataclasses.dataclass
class WatchdogConfig:
    max_bad_steps: int = 3          # consecutive non-finite losses -> rollback
    loss_spike_factor: float = 10.0  # vs running median -> suspicious
    window: int = 64


class NaNWatchdog:
    def __init__(self, cfg: WatchdogConfig = WatchdogConfig()):
        self.cfg = cfg
        self.bad_streak = 0
        self.history: list[float] = []

    def observe(self, loss: float) -> str:
        """-> 'ok' | 'skip' (drop this update) | 'rollback'."""
        if not math.isfinite(loss):
            self.bad_streak += 1
            if self.bad_streak >= self.cfg.max_bad_steps:
                self._rollback()
                return "rollback"
            return "skip"
        med = (float(np.median(self.history[-self.cfg.window:]))
               if self.history else loss)
        self.history.append(loss)
        if self.history and loss > max(1e-6, med) * self.cfg.loss_spike_factor \
                and len(self.history) > 8:
            self.bad_streak += 1
            if self.bad_streak >= self.cfg.max_bad_steps:
                self._rollback()
                return "rollback"
            return "skip"
        self.bad_streak = 0
        return "ok"

    def _rollback(self) -> None:
        # the caller restores an older checkpoint, so the pre-blowup
        # history no longer describes the stream it will observe next:
        # keeping it made healthy post-rewind losses re-flag as spikes
        # against a stale median (and the spike branch above had already
        # appended the blowup values themselves)
        self.bad_streak = 0
        self.history.clear()


class StragglerMonitor:
    """Flags steps slower than ``factor`` x the trailing median — at
    fleet scale this feeds the scheduler's host-replacement decision;
    here it surfaces in metrics and tests."""

    def __init__(self, factor: float = 3.0, window: int = 32):
        self.factor = factor
        self.window = window
        self.times: list[float] = []
        self.flagged: list[int] = []
        self._t0 = None
        self._step = 0

    def start(self):
        self._t0 = time.monotonic()

    def stop(self) -> bool:
        if self._t0 is None:
            # stop() without a matching start() (e.g. the first loop
            # iteration after a replan reset, or an exception path that
            # skipped start) is a no-observation, not a TypeError
            return False
        t0, self._t0 = self._t0, None
        return self.observe(time.monotonic() - t0)

    def reset(self) -> None:
        """Forget the timing history and flags.  Called after elastic
        recovery (host replaced / topology re-planned): the trailing
        median belongs to the old fleet, so a replacement host must not
        inherit the straggler's baseline — nor be judged against it.
        ``_step`` keeps counting so flag indices stay aligned with the
        global training step."""
        self.times.clear()
        self.flagged.clear()
        self._t0 = None

    def observe(self, dt: float) -> bool:
        """Record one step duration (seconds) directly — the testable
        core of start/stop.  Flags only *relative* slowdowns vs the
        trailing median, so a steadily skewed fleet (every step paced by
        the slowest vendor group) is the new normal, not a straggler —
        compute skew is the partitioner's job (core/skew.py), not this
        monitor's.

        Non-positive or non-finite durations (clock skew, a
        monotonic-clock bug, a poisoned upstream timer) are dropped
        without entering the median window — one NaN would otherwise
        poison every subsequent median, and a zero/negative dt would
        drag it toward flagging healthy steps.  ``_step`` still
        advances so flag indices stay aligned with the training step
        (same contract as ``reset``)."""
        if not (math.isfinite(dt) and dt > 0.0):
            self._step += 1
            return False
        med = float(np.median(self.times[-self.window:])) if self.times else dt
        self.times.append(dt)
        slow = len(self.times) > 4 and dt > self.factor * med
        if slow:
            self.flagged.append(self._step)
        self._step += 1
        return slow
