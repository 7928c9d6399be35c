"""Deterministic synthetic data: the numpy core of the JAX package's
``data/pipeline.py``.

Every batch is a pure function of (seed, step, host): the same token
stream as the reference's.  Each training process takes its rows of its
host's batch.  ``host_shares`` gives each host an explicit sample count
(the skew-aware uneven split), and ``shares_for_hosts`` turns a
throughput split (``core.skew.SkewSplit.shares``) into such counts.

``Prefetcher`` (a copy of the reference's) runs ``synth_batch`` in a
daemon thread with a bounded queue; ``get(timeout)`` records a batch
that did not arrive in time as skipped and keeps waiting, the data-side
straggler mitigation.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Iterator

import numpy as np

from repro_torch.core.topology import integer_split


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    enc_seq: int = 0          # >0: also emit encoder frame embeddings
    d_model: int = 0
    prefetch: int = 4
    # uneven per-host sample counts (one entry per host, summing to
    # global_batch); None is the even split
    host_shares: tuple[int, ...] | None = None

    @property
    def host_batch(self) -> int:
        if self.host_shares is not None:
            assert len(self.host_shares) == self.n_hosts, (
                f"host_shares needs one entry per host: "
                f"{len(self.host_shares)} != {self.n_hosts}")
            assert sum(self.host_shares) == self.global_batch, (
                f"host_shares must sum to the global batch: "
                f"{sum(self.host_shares)} != {self.global_batch}")
            return self.host_shares[self.host_id]
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


def shares_for_hosts(global_batch: int, weights) -> tuple[int, ...]:
    """Integer per-host sample counts proportional to ``weights`` (e.g. a
    ``SkewSplit``'s shares), every host at least one sample:
    largest-remainder rounding by ``core.topology.integer_split``."""
    return tuple(integer_split(int(global_batch), list(weights), floor=1))


def synth_batch(cfg: DataConfig, step: int) -> dict:
    """The batch host ``host_id`` contributes at ``step``: zipf-ish token
    ranks clipped into the vocabulary; labels are the next token of the
    same stream.  With ``enc_seq`` the batch also holds ``enc``, the
    stub frontend's frame embeddings (host_batch, enc_seq, d_model) f32,
    drawn after the tokens from the same stream."""
    base = np.random.SeedSequence([cfg.seed, step])
    child = np.random.default_rng(base.spawn(cfg.n_hosts)[cfg.host_id])
    z = child.zipf(1.3, size=(cfg.host_batch, cfg.seq_len + 1))
    toks = np.minimum(z - 1, cfg.vocab_size - 1).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.enc_seq:
        batch["enc"] = child.normal(
            size=(cfg.host_batch, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


class Prefetcher:
    """Bounded-queue background loader with straggler skip."""

    def __init__(self, cfg: DataConfig, start_step: int = 0,
                 inject_delay_s: float = 0.0):
        self.cfg = cfg
        self._q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
        self._stop = threading.Event()
        self._step = start_step
        self._delay = inject_delay_s
        self.skipped: list[int] = []
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            if self._delay:
                time.sleep(self._delay)
            batch = synth_batch(self.cfg, step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def get(self, timeout: float | None = None) -> tuple[int, dict]:
        """Next (step, batch); on timeout the batch is recorded as
        skipped and the wait continues with the following one."""
        while True:
            try:
                return self._q.get(timeout=timeout)
            except queue.Empty:
                self.skipped.append(self._step)
                timeout = max(0.5, (timeout or 0.5) * 2)  # backoff, keep trying

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)


def batches(cfg: DataConfig, start_step: int = 0) -> Iterator[tuple[int, dict]]:
    step = start_step
    while True:
        yield step, synth_batch(cfg, step)
        step += 1
