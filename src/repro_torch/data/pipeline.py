"""Deterministic synthetic data: the numpy core of the JAX package's
``data/pipeline.py``.

Every batch is a pure function of (seed, step): the same token stream
as the reference's for one host.  Each training process takes its rows
of that batch.  The prefetch thread and the per-host streams
(``n_hosts``/``host_id``, the uneven ``host_shares`` split) come with
the paths that set them.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0


def synth_batch(cfg: DataConfig, step: int) -> dict:
    """The global batch at ``step``: zipf-ish token ranks clipped into the
    vocabulary; labels are the next token of the same stream (the
    reference's stream for host 0 of 1)."""
    base = np.random.SeedSequence([cfg.seed, step])
    child = np.random.default_rng(base.spawn(1)[0])
    z = child.zipf(1.3, size=(cfg.global_batch, cfg.seq_len + 1))
    toks = np.minimum(z - 1, cfg.vocab_size - 1).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def batches(cfg: DataConfig, start_step: int = 0) -> Iterator[tuple[int, dict]]:
    step = start_step
    while True:
        yield step, synth_batch(cfg, step)
        step += 1
