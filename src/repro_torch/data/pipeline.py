"""Deterministic synthetic data: the numpy core of the JAX package's
``data/pipeline.py``.

Every batch is a pure function of (seed, step, host): the same token
stream as the reference's.  Each training process takes its rows of its
host's batch.  ``host_shares`` gives each host an explicit sample count
(the skew-aware uneven split), and ``shares_for_hosts`` turns a
throughput split (``core.skew.SkewSplit.shares``) into such counts.  The
prefetch thread comes with the path that needs it.
"""

from __future__ import annotations

import dataclasses
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
    same stream."""
    base = np.random.SeedSequence([cfg.seed, step])
    child = np.random.default_rng(base.spawn(cfg.n_hosts)[cfg.host_id])
    z = child.zipf(1.3, size=(cfg.host_batch, cfg.seq_len + 1))
    toks = np.minimum(z - 1, cfg.vocab_size - 1).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def batches(cfg: DataConfig, start_step: int = 0) -> Iterator[tuple[int, dict]]:
    step = start_step
    while True:
        yield step, synth_batch(cfg, step)
        step += 1
