"""Distribution runtime: explicit TP/SP/FSDP/EP over process groups, and
PP over the pod group (``parallel/pipeline.py``)."""

from .sharding import (  # noqa: F401
    Runtime,
    copy_to_tp,
    fsdp_gather,
    gather_sp,
    reduce_from_tp,
    scatter_sp,
)
