"""Distribution context for the model code: process groups in place of
the JAX package's mesh axis names.

``Runtime`` carries one ``torch.distributed`` process group per role
(``None`` is a group of one): tensor parallel ("model"), the cluster
("pod"), the intra-cluster data-parallel group ("data") and the group
of every data-parallel rank (the reference's ``dp_axes``, pod x data).
The MoE knobs come with their slice.  ``copy_to_tp``/``reduce_from_tp`` mark
the edges of a tensor-parallel region as in the JAX package; at a TP
group of one they are the identity, and tensor parallelism across
processes is not ported yet, so a larger group raises.  Kernels are chosen by the
device of the tensor they get, so there is no ``use_pallas`` switch.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Static distribution context threaded through the model code."""

    tp_group: Any = None            # tensor-parallel group ("model")
    pod_group: Any = None           # cluster group ("pod"): the KV-transfer ring
    data_group: Any = None          # intra-cluster data-parallel group ("data")
    dp_group: Any = None            # every data-parallel rank (pod x data)


def group_size(group) -> int:
    """World size of ``group``; ``None`` (no group) counts as one."""
    return 1 if group is None else dist.get_world_size(group)


def _single(group, what: str) -> None:
    if group_size(group) != 1:
        raise NotImplementedError(
            f"{what} over a tensor-parallel group larger than one is not "
            f"ported yet")


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Entry of a TP region (forward identity)."""
    _single(group, "copy_to_tp")
    return x


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Exit of a row-parallel product (forward sum over the TP group)."""
    _single(group, "reduce_from_tp")
    return x
