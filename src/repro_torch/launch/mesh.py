"""Runtime construction from process groups (the counterpart of the JAX
package's mesh helpers).

There is no device mesh: each process drives one device, and the roles
of the mesh axes are ``torch.distributed`` groups the caller creates
(``init_process_group`` with an explicit address, world size and rank).
"""

from __future__ import annotations

from repro_torch.parallel.sharding import Runtime


def runtime_for_groups(*, pod_group=None, tp_group=None) -> Runtime:
    """The Runtime for one process (no groups), or for the given groups.
    ``pod_group`` is the ring the disaggregated KV transfer runs over."""
    return Runtime(tp_group=tp_group, pod_group=pod_group)
