"""Synthetic token data (numpy)."""

from .pipeline import (  # noqa: F401
    DataConfig,
    Prefetcher,
    batches,
    shares_for_hosts,
    synth_batch,
)
