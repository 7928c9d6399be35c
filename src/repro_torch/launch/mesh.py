"""Runtime construction from process groups (the counterpart of the JAX
package's mesh helpers).

There is no device mesh: each process drives one device, and the roles
of the mesh axes are ``torch.distributed`` groups.  The caller starts
the process group (``init_process_group`` with an explicit store or
address, world size and rank); ``runtime_for_groups`` either takes
groups it is given or cuts the world into (pod, data, model) groups.
``make_production_world`` starts the reference's production mesh as a
world of ``fake`` ranks, which move nothing: the dry run's world.
``spawn_world`` starts a world of processes on this host, each of which
starts its process group with ``init_world``: the examples' 2 pods x 2
data x 2 model (``TEST_SHAPE``, the reference's ``make_test_mesh``).
"""

from __future__ import annotations

import itertools
import multiprocessing
import os
import pathlib
import socket
import tempfile

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import Runtime


# --dist-backend: "nccl" sends CPU tensors through gloo and CUDA tensors
# through NCCL; "gloo" sends both through gloo (staging CUDA tensors
# through the host), which lets ranks share one card
BACKENDS = {"nccl": "cpu:gloo,cuda:nccl", "gloo": "gloo"}

# the reference's production mesh geometry, shared with the planners that
# price the production topology (dryrun.auto_plan)
PRODUCTION_MULTI_SHAPE = (2, 16, 16)     # (pod, data, model)
PRODUCTION_SINGLE_SHAPE = (16, 16)       # (data, model)
TEST_SHAPE = (2, 2, 2)                   # (pod, data, model): make_test_mesh's


def init_world(device: torch.device, backend: str | None = None) -> bool:
    """Start the default process group unless one is running, and return
    whether it started one.  The world comes from the usual environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, and
    ``LOCAL_RANK`` for the card, else ``RANK``); without it a lone process
    makes a world of one over an in-process store.  ``backend`` is a key
    of ``BACKENDS``: "nccl" by default on the card, "gloo" on the CPU.
    Nothing switches backend when one fails: NCCL refuses two ranks of one
    communicator on one card, so a rank without a card of its own raises
    here under "nccl", and shares the card under "gloo"."""
    if dist.is_initialized():
        return False
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs device cuda")
    if "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))
            cards = torch.cuda.device_count()
            if backend == "nccl" and local >= cards:
                raise RuntimeError(
                    f"local rank {local} has no card of its own ({cards} visible): NCCL "
                    f"cannot put two ranks of one communicator on one card; the gloo "
                    f"backend can")
            torch.cuda.set_device(local % cards)
        dist.init_process_group(BACKENDS[backend], init_method="env://")
    else:
        dist.init_process_group(BACKENDS[backend], store=dist.HashStore(), rank=0,
                                world_size=1)
    return True


def mesh_coords(rank: int, data_per_pod: int, tp: int) -> tuple[int, int, int]:
    """(pod, data, model) of ``rank`` as ``jax.make_mesh((pods, data, model))``
    lays out devices: rank = (pod * data_per_pod + data) * tp + model."""
    return rank // (data_per_pod * tp), rank // tp % data_per_pod, rank % tp


def runtime_for_groups(*, pod_group=None, tp_group=None, pods: int | None = None,
                       data_per_pod: int | None = None, tp: int = 1, fsdp: bool = False,
                       sp: bool = False, remat_policy: str = "none",
                       moe_capacity_factor: float = 1.25,
                       moe_a2a_mode: str = "flat", moe_cluster_weights=None,
                       lost_pod: int | None = None) -> Runtime | None:
    """The Runtime for one process.

    With ``pods`` and ``data_per_pod`` the current world of ``pods *
    data_per_pod * tp`` ranks is cut as the reference's (pod, data, model)
    mesh lays out devices (``mesh_coords``).  Every rank builds every group
    (each ``new_group`` is collective) and keeps its own: the TP group
    (the ``tp`` consecutive ranks of its (pod, data) cell; none at tp 1),
    the data group (its pod's ranks at its model index), the pod group
    (the ranks of its (data, model) index across pods) and the
    data-parallel group (every rank at its model index: the reference's
    reductions over (pod, data) never cross model indices).  With
    ``fsdp`` the data group is also the FSDP group, as
    ``runtime_for_mesh(fsdp=True)`` makes the data axis the FSDP axis.
    Groups of one member are real groups, so a world of one still runs
    the pod hop and its codec.  With ``lost_pod`` the groups are cut over
    the surviving pods only (``survivor_mesh``): a pod axis left with one
    pod becomes ``pod_group=None``, and a rank of the lost pod gets
    ``None``.  Otherwise the Runtime holds the given
    groups as they are (``None`` is a group of one, no collective) and no
    data-parallel group: ``pod_group`` is the ring the disaggregated KV
    transfer runs over.  The MoE knobs go to the Runtime as the
    reference's ``runtime_for_mesh`` passes them, and so does
    ``remat_policy``; the ep exchange's cluster group stays ``None``
    (experts never shard over pods)."""
    knobs = dict(remat_policy=remat_policy,
                 moe_capacity_factor=moe_capacity_factor, moe_a2a_mode=moe_a2a_mode,
                 moe_cluster_weights=(tuple(moe_cluster_weights) if moe_cluster_weights
                                      else None))
    if pods is None and data_per_pod is None:
        return Runtime(tp_group=tp_group, pod_group=pod_group, sp=sp, **knobs)
    if pods is None or data_per_pod is None or min(pods, data_per_pod, tp) < 1:
        raise ValueError(f"pods {pods} x data_per_pod {data_per_pod} x tp {tp}")
    world = dist.get_world_size()
    if pods * data_per_pod * tp != world:
        raise ValueError(f"pods {pods} x data_per_pod {data_per_pod} x tp {tp} "
                         f"!= world {world}")
    if lost_pod is not None and not (0 <= lost_pod < pods and pods > 1):
        raise ValueError(f"cannot lose pod {lost_pod} of {pods}")
    mine = mesh_coords(dist.get_rank(), data_per_pod, tp)
    P = [p for p in range(pods) if p != lost_pod]
    D, T = range(data_per_pod), range(tp)

    def rank(p, d, m):
        return (p * data_per_pod + d) * tp + m

    def cut(keys, members, own):
        """One group per key, of the ranks ``members(key)``; returns this
        rank's, the one of key ``own`` (None on the lost pod)."""
        groups = {k: dist.new_group(members(*k)) for k in keys}
        return groups.get(own)

    p0, d0, m0 = mine
    tp_group = (cut(itertools.product(P, D), lambda p, d: [rank(p, d, m) for m in T],
                    (p0, d0)) if tp > 1 else None)
    data = cut(itertools.product(P, T), lambda p, m: [rank(p, d, m) for d in D], (p0, m0))
    pod = (cut(itertools.product(D, T), lambda d, m: [rank(p, d, m) for p in P], (d0, m0))
           if lost_pod is None or len(P) > 1 else None)
    dp = (dist.group.WORLD if tp == 1 and lost_pod is None else
          cut(((m,) for m in T), lambda m: [rank(p, d, m) for p in P for d in D], (m0,)))
    if p0 == lost_pod:
        return None
    return Runtime(tp_group=tp_group, pod_group=pod, data_group=data, dp_group=dp,
                   fsdp_group=data if fsdp else None, sp=sp, **knobs)


def survivor_mesh(pods: int, data_per_pod: int, tp: int, lost_pod: int,
                  **kw) -> tuple[Runtime | None, int]:
    """The survivor cut of a (pods, data, model) world that lost pod
    ``lost_pod``: the reference's ``survivor_mesh(mesh, "pod", lost_pod)``.
    Every rank, those of the lost pod too, takes part in each
    ``new_group`` in the same order; a survivor gets the Runtime of its
    place among the surviving ranks (``runtime_for_groups(lost_pod=...)``,
    which takes the Runtime knobs ``kw``), a rank of the lost pod gets
    ``None``.  Returns (the Runtime or None, the survivors' pod count)."""
    return (runtime_for_groups(pods=pods, data_per_pod=data_per_pod, tp=tp,
                               lost_pod=lost_pod, **kw), pods - 1)


def production_axes(multi_pod: bool) -> dict[str, int]:
    """The production mesh's axis sizes by the reference's axis names:
    (pod, data, model) multi-pod, (data, model) single-pod."""
    if multi_pod:
        return dict(zip(("pod", "data", "model"), PRODUCTION_MULTI_SHAPE))
    return dict(zip(("data", "model"), PRODUCTION_SINGLE_SHAPE))


def make_fake_world(axes: dict[str, int], **kw) -> Runtime:
    """Start a world of ``fake`` ranks, ``axes``' product of them, and
    return rank 0's Runtime of that (pod, data, model) cut
    (``runtime_for_groups`` with the knobs ``kw``).  A fake rank issues
    every collective and moves nothing, so one process traces rank 0 of
    a world of any size; its tensors must be fake too (``FakeTensorMode``).
    One world per process: a running fake world of the same size is cut
    again (each cut makes new groups), any other process group raises."""
    # the fake backend lives with the test utilities; importing it here,
    # never at module import, keeps them out of every other entry point
    from torch.testing._internal.distributed.fake_pg import FakeStore

    pods, data, tp = axes.get("pod", 1), axes.get("data", 1), axes.get("model", 1)
    world = pods * data * tp
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    elif dist.get_backend() != "fake" or dist.get_world_size() != world:
        raise RuntimeError(f"a {dist.get_backend()} world of {dist.get_world_size()} rank(s) "
                           f"is running: the fake world of {world} is one per process")
    return runtime_for_groups(pods=pods, data_per_pod=data, tp=tp, **kw)


def make_production_world(*, multi_pod: bool = False, **kw) -> Runtime:
    """The production mesh (``PRODUCTION_MULTI_SHAPE`` or
    ``PRODUCTION_SINGLE_SHAPE``) as a fake world of 512 or 256 ranks:
    rank 0's Runtime (the counterpart of ``make_production_mesh``)."""
    return make_fake_world(production_axes(multi_pod), **kw)


def _spawned(fn, rank: int, world: int, port: int, out_dir: str, args: tuple) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      GLOO_SOCKET_IFNAME="lo")
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    torch.save(fn(rank, *args), pathlib.Path(out_dir) / f"rank{rank}.pt")


def spawn_world(fn, world: int, *args, timeout: float = 600) -> list:
    """Run ``fn(rank, *args)`` in ``world`` spawned processes, each with
    the environment of one rank of a world on this host (``RANK``,
    ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` localhost, a free
    ``MASTER_PORT``), so that ``init_world`` starts its process group, and
    with its share of the host's threads.  ``fn`` is a module-level
    function.  Returns each rank's return value in rank order; raises if
    a rank failed.  Every process is joined, or killed at ``timeout``."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_spawned, args=(fn, r, world, port, tmp, args))
                 for r in range(world)]
        try:
            for p in procs:
                p.start()
            for p in procs:
                p.join(timeout=timeout)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=30)
        codes = [p.exitcode for p in procs]
        if codes != [0] * world:
            raise RuntimeError(f"{fn.__name__} on {world} ranks: exit codes {codes}")
        return [torch.load(pathlib.Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(world)]
