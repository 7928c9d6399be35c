"""Runtime construction from process groups (the counterpart of the JAX
package's mesh helpers).

There is no device mesh: each process drives one device, and the roles
of the mesh axes are ``torch.distributed`` groups.  The caller starts
the process group (``init_process_group`` with an explicit store or
address, world size and rank); ``runtime_for_groups`` either takes
groups it is given or cuts the world into (pod, data) groups.
"""

from __future__ import annotations

import torch.distributed as dist

from repro_torch.parallel.sharding import Runtime


def runtime_for_groups(*, pod_group=None, tp_group=None, pods: int | None = None,
                       data_per_pod: int | None = None, fsdp: bool = False) -> Runtime:
    """The Runtime for one process.

    With ``pods`` and ``data_per_pod`` (model = 1) the current world of
    ``pods * data_per_pod`` ranks is cut as the reference's mesh
    (pod, data) lays out devices: rank r sits in pod r // data_per_pod at
    data index r % data_per_pod.  Every rank builds every group (each
    ``new_group`` is collective), and keeps its own pod group (the ranks
    of its data index across pods) and data group (the ranks of its
    pod); the data-parallel group is the whole world.  With ``fsdp``
    the data group is also the FSDP group, as ``runtime_for_mesh(fsdp=True)``
    makes the data axis the FSDP axis.  Groups of one
    member are real groups, so a world of one still runs the pod hop and
    its codec.  Otherwise the Runtime holds the given groups as they are
    (``None`` is a group of one, no collective) and no data-parallel
    group: ``pod_group`` is the ring the disaggregated KV transfer runs
    over."""
    if pods is None and data_per_pod is None:
        return Runtime(tp_group=tp_group, pod_group=pod_group)
    if pods is None or data_per_pod is None or pods < 1 or data_per_pod < 1:
        raise ValueError(f"pods {pods} x data_per_pod {data_per_pod}")
    world = dist.get_world_size()
    if pods * data_per_pod != world:
        raise ValueError(f"pods {pods} x data_per_pod {data_per_pod} != world {world}")
    rank = dist.get_rank()
    mine_pod = mine_data = None
    for p in range(pods):
        g = dist.new_group([p * data_per_pod + d for d in range(data_per_pod)])
        if rank // data_per_pod == p:
            mine_data = g
    for d in range(data_per_pod):
        g = dist.new_group([p * data_per_pod + d for p in range(pods)])
        if rank % data_per_pod == d:
            mine_pod = g
    return Runtime(tp_group=tp_group, pod_group=mine_pod, data_group=mine_data,
                   dp_group=dist.group.WORLD, fsdp_group=mine_data if fsdp else None)
