"""Data-parallel training with the HetCCL gradient sync.

    python -m repro_torch.launch.train --arch qwen2.5-3b --mode hier --compression int8
    python -m repro_torch.launch.train --mode hier_pipelined --compression int8
    python -m repro_torch.launch.train --mode hier_border_rs --compression bf16
    python -m repro_torch.launch.train --mode hier_zero1 --compression int8
    python -m repro_torch.launch.train --mode hier_overlap --compression int8
    python -m repro_torch.launch.train --mode fsdp --compression int8
    python -m repro_torch.launch.train --plan auto --skew auto --plan-cache plans.pkl
    python -m repro_torch.launch.train --mode hier --no-packed
    python -m repro_torch.launch.train --smoke --device cpu --steps 2
    python -m repro_torch.launch.train --arch qwen3-moe-30b-a3b --smoke --device cpu
    python -m repro_torch.launch.train --arch mamba2-2.7b --mode hier --compression int8
    python -m repro_torch.launch.train --arch hymba-1.5b --seq 2048 --compression int8
    python -m repro_torch.launch.train --arch whisper-tiny --compression int8
    python -m repro_torch.launch.train --arch chameleon-34b --layers 2 --compression int8
    RANK=r WORLD_SIZE=8 MASTER_ADDR=localhost MASTER_PORT=29500 \
        python -m repro_torch.launch.train --smoke --device cpu --pods 2 --tp 2
    python -m repro_torch.launch.train --steps 12 --guard --chaos 8 --compression int8
    python -m repro_torch.launch.train --ckpt-dir ckpt --ckpt-every 50 --resume
    RANK=r WORLD_SIZE=8 MASTER_ADDR=localhost MASTER_PORT=29500 \
        python -m repro_torch.launch.train --smoke --device cpu --pods 2 --global-batch 8 \
        --mode hier_zero1 --compression int8 --elastic --inject-pod-failure 3

Each process trains one replica (or its TP shard of one) on its slice of
the global batch; the gradients meet through ``flat``, ``hier``,
``hier_pipelined`` (the pod hop in 4 chunks, as ``TrainConfig.n_chunks``
sets), ``hier_border_rs``, ``hier_overlap`` (one AllReduceH per
readiness-ordered gradient bucket of at most 64 MiB of f32, each fired
inside the backward), ``hier_zero1``
(ReduceScatterH into the ZeRO-1 flat-shard AdamW, whose f32 master and
moments are bootstrapped from the drawn parameters; the reconstruction
is the deferred AllGather) or ``fsdp`` (the layer parameters sharded
over the data group, gathered per layer; the pod hop per leaf),
optionally bf16, or int8 except with ``hier_border_rs``, on the pod hop.

``--plan auto`` lets the planner (``core/planner.py``, a copy of the JAX
package's) pick the schedule, its chunks and codec per gradient bucket,
and whether the sync runs overlapped and packed; ``--skew auto`` derives
the per-pod batch split (``core/skew.py``); ``--plan-cache PATH`` keeps
plans on disk across launches; ``--no-packed`` runs the per-leaf data
path.  The plan is priced on ``topology.tpu_multipod(pods, world //
pods)``, the reference's model of a TPU v5e cluster: its predicted
milliseconds per sync are the cost model's, not a time of this device.

The world and this process's rank come from the usual
``torch.distributed`` environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``); a lone process makes its own world
of one over an in-process store, whose pod and data groups are real
groups of one member, so the pod hop and its codec still run.  The
world is cut into ``--pods`` pods x data x ``--tp`` model ranks, as the
reference's (pod, data, model) mesh lays out devices; ``--sp`` adds
sequence parallelism.  Each data-parallel index takes its slice of the
batch, and the TP ranks of one index share it.  ``--dist-backend gloo``
sends CUDA tensors through gloo, so that ranks can share one card.

The runtime flags are the reference launcher's, with its defaults and
its loop (``runtime/``): ``--ckpt-dir``/``--ckpt-every``/``--resume``
(the state gathered to rank 0, which writes; every rank restores its
slices), the NaN watchdog's rollback and skip, the straggler monitor,
``--guard`` (the deadline and heartbeats, the schedule digests gathered
over the world, the payload's CRC32 and finiteness, the bounded retry,
the link-health feed with more than one pod), ``--chaos SEED`` (the
seeded fault plan; implies ``--guard``) and ``--elastic`` with
``--inject-pod-failure STEP`` (the last pod lost before STEP: the
survivors re-plan, cut new groups and carry the state across, the ZeRO-1
master through the slot map; the lost pod's ranks wait at the end).  A
step that builds kernels or the step after a rebuild is no hang signal.
The ``[run]``, ``[guard]``, ``[chaos]``, ``[elastic]`` and ``[health]``
lines precede the JSON lines.

Weights are random, drawn from ``--seed``; the data is the synthetic
zipf-ish stream of ``data/pipeline.py``, read ahead by its
``Prefetcher``.  Every ``--log-every`` steps a
JSON line gives the reference's per-step log (step, loss, grad norm,
ms per step) and the kernel launches of the step.  It runs on the GPU
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import get_config
from repro_torch.core import collectives, cost_model, overlap, planner, primitives, topology
from repro_torch.core import skew as skew_lib
from repro_torch.core.collectives import CommConfig
from repro_torch.data.pipeline import DataConfig, Prefetcher
from repro_torch.kernels import ops
from repro_torch.launch.mesh import (BACKENDS, init_world, mesh_coords, runtime_for_groups,
                                     survivor_mesh)
from repro_torch.models import moe as moe_lib
from repro_torch.models.model import Model, resolve_device
from repro_torch.parallel.sharding import Runtime, group_size
from repro_torch.runtime import elastic as elastic_lib
from repro_torch.runtime import faults as faults_lib
from repro_torch.runtime import guard as guard_lib
from repro_torch.runtime import tree as tree_lib
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.health import NaNWatchdog, StragglerMonitor, WatchdogConfig
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (TrainConfig, load_state, make_train_step, state_like,
                                          state_shardings, state_tree, zero_bootstrap,
                                          zero_global)

MODES = ("flat", "hier", "hier_pipelined", "hier_border_rs", "hier_overlap",
         "hier_zero1", "fsdp")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass(frozen=True)
class Planned:
    """What the planning block decided: the plan (or None), the executed
    comm mode, the data path, the per-pod gradient weights, and the plan
    cache's counters."""
    plan: planner.CommPlan | None
    mode: str
    packed: bool
    cluster_weights: tuple[float, ...] | None
    cache: dict | None = None
    # the MoE dispatch/combine All2All: the planned schedule mode and the
    # skew weights steering expert capacity (the Runtime's moe_* knobs)
    moe_a2a_mode: str = "flat"
    moe_cluster_weights: tuple[float, ...] | None = None


def dp_rows(rank: int, global_batch: int, pods: int, data_per_pod: int, tp: int) -> slice:
    """The rows of the global batch ``rank`` trains on: the batch is split
    over the data-parallel index (pod-major, pod * data_per_pod + data) and
    shared by the TP ranks of an index, as the reference shards it over
    (pod, data) and replicates it over model."""
    pod, data, _ = mesh_coords(rank, data_per_pod, tp)
    index, per = pod * data_per_pod + data, global_batch // (pods * data_per_pod)
    return slice(index * per, (index + 1) * per)


def n_train_leaves(cfg) -> int:
    """The number of ``Model.train_leaves()`` of ``cfg`` (the reference's
    stacked leaves), from the parameters' shapes alone: drawn under
    FakeTensorMode, nothing allocated."""
    with FakeTensorMode():
        return len(Model(cfg, device="cpu").init(0).train_leaves())


def make_plan(cfg, pods: int, world: int, mode: str, compression: str | None,
              plan: str = "manual", skew: str = "none", plan_cache: str | None = None,
              packed: bool = True, global_batch: int = 4, seq: int = 1024,
              tp: int = 1, log=print) -> Planned:
    """The planning block of the JAX package's launcher: ``--plan auto``
    and ``--skew auto`` priced on ``topology.tpu_multipod(pods, world //
    pods)``, with a pod axis only if ``pods > 1``, as the reference prices
    its mesh; then its mode override and its per-leaf fallback.  ``world``
    counts every rank, TP ranks included; each syncs the gradients of its
    own TP shard, a ``tp``-th of the parameters.  For an MoE model
    ``--plan auto`` also plans the expert dispatch/combine All2All over
    the a2a candidate family (flat / flat_a2a / hier_a2a), one bucket of
    E x capacity x d_model f32 per layer, and ``--skew auto``'s split
    steers the expert capacity."""
    plan_obj = cluster_weights = stats = None
    moe_a2a_mode, moe_weights = "flat", None
    if plan == "auto" or skew == "auto":
        n_pods = max(1, pods)
        topo = topology.tpu_multipod(n_pods, world // n_pods)
        grad_bytes = max(1, cfg.param_count() * 4 // tp)
        allowed = (None, compression) if compression else (None, "bf16")
        cache = (planner.PlanCache(path=plan_cache) if plan_cache
                 else planner.default_plan_cache())
        plan_kw = dict(
            cache=cache,
            # the ZeRO-1 sync is a reduce_scatter (the end AllGather moves
            # to the parameter update); everything else rides all_reduce
            coll="reduce_scatter" if mode == "hier_zero1" else "all_reduce",
            pod_axis="pod" if n_pods > 1 else None, intra_axis="data",
            compressions=allowed, flat_mechanism="native",
            # balanced subgroups are advisory: price the groups as they run
            try_balanced=False,
            # priced with the Pack/Unpack steps; the leaf count arms the
            # per-leaf fallback below
            packed=packed, n_leaves=n_train_leaves(cfg))
        # overlap: price the readiness-ordered layer buckets against the
        # backward's timeline; the structural modes run one monolithic sync
        step_flops = 6.0 * cfg.active_param_count() * global_batch * seq
        backward_s = None
        bucket_sizes = [grad_bytes]
        if mode not in ("fsdp", "hier_zero1"):
            backward_s = cost_model.backward_compute_time(topo, step_flops)
            bucket_sizes = overlap.bucket_sizes_for_volume(
                grad_bytes, cfg.n_layers, overlap.DEFAULT_CAP_BYTES)
        sim_cache: dict = {}
        skew_split = skew_comp = None
        if skew == "auto":
            sp = skew_lib.optimize(
                topo, step_flops, bucket_sizes,
                total_microbatches=max(topo.n_clusters, global_batch),
                backward_frac=0.0 if mode in ("fsdp", "hier_zero1") else 2.0 / 3.0,
                _sim_cache=sim_cache, **plan_kw)
            skew_split, skew_comp = sp.split, sp.compute_s
            cluster_weights = sp.split.weights
            log("[skew] " + sp.describe())
            if any(abs(w - 1.0) > 1e-9 for w in cluster_weights):
                # every rank takes an even slice of the batch: weighting the
                # gradients of an even batch would bias the mean
                log("[skew] data shards are even per device — keeping the "
                    "unweighted sync (the split above describes the intended "
                    "uneven assignment)")
                cluster_weights = None
            if plan == "auto":
                plan_obj = sp.plan
        if plan == "auto" and plan_obj is None:
            plan_obj = planner.plan(topo, bucket_sizes, backward_compute_s=backward_s,
                                    skew=skew_split, skew_compute_s=skew_comp,
                                    _sim_cache=sim_cache, **plan_kw)
        if (plan_obj is not None and plan_obj.overlap is not None
                and plan_obj.recommended_mode() != "hier_overlap"):
            # overlap does not win: the sync is one monolithic collective,
            # so re-plan at that granularity
            plan_obj = planner.plan(topo, [grad_bytes], skew=skew_split,
                                    skew_compute_s=skew_comp, _sim_cache=sim_cache,
                                    **plan_kw)
        if (plan_obj is not None and cluster_weights is None
                and plan_obj.cluster_weights is not None):
            plan_obj = dataclasses.replace(plan_obj, cluster_weights=None)
        if plan_obj is not None:
            b = max(plan_obj.buckets, key=lambda x: x.nbytes)
            msg = (f"[plan] {plan_obj.recommended_mode()} "
                   f"(biggest bucket: {b.candidate.mode} "
                   f"n_chunks={b.candidate.n_chunks} "
                   f"compression={b.candidate.compression}) "
                   f"predicted {plan_obj.predicted_step_s*1e3:.2f} ms/sync total")
            if plan_obj.overlap is not None:
                msg += (f", {plan_obj.exposed_comm_s*1e3:.2f} ms exposed "
                        f"(backward {plan_obj.overlap.backward_compute_s*1e3:.2f} ms)")
            log(msg + f" validated={plan_obj.validated}")
            log(plan_obj.describe())
        if plan == "auto" and cfg.n_experts:
            # the ep payload is token activations, not gradients, so it gets
            # its own plan; int8 is left out (activations have no error
            # feedback to absorb the quantization bias)
            t_loc = max(1, max(1, global_batch * seq) // max(1, topo.n_ranks))
            cap = moe_lib._capacity(t_loc, cfg.top_k, cfg.n_experts,
                                    Runtime.moe_capacity_factor)
            a2a_bytes = max(1, cfg.n_experts * cap * cfg.d_model * 4)
            a2a_plan = planner.plan(
                topo, [a2a_bytes] * max(1, cfg.n_layers), coll="all_to_all",
                pod_axis="pod" if n_pods > 1 else None, intra_axis="data",
                compressions=(None, "bf16"), flat_mechanism="native",
                try_balanced=False, cache=cache, _sim_cache=sim_cache)
            moe_a2a_mode = a2a_plan.recommended_mode()
            # capacity allocation weights no gradient, so the even-data
            # guard above does not apply
            if skew_split is not None:
                moe_weights = tuple(skew_split.weights)
            log(f"[plan] MoE dispatch/combine All2All -> {moe_a2a_mode} "
                f"({a2a_bytes / 2 ** 20:.1f} MiB/layer)")
            log(a2a_plan.describe())
        st = cache.stats()
        stats = {"hits": st["hits"], "misses": st["misses"], "path": st["path"]}
        log(f"[plan] cache: {st['hits']} hit(s), {st['misses']} miss(es)")
    # the optimizer's structure (fsdp, hier_zero1) is not a per-bucket knob:
    # the plan replaces only the schedule choice of the hier path
    if plan_obj is not None and mode not in ("fsdp", "hier_zero1"):
        mode = "hier_overlap" if plan_obj.recommended_mode() == "hier_overlap" else "hier"
    if plan_obj is not None and plan_obj.data_path == "per_leaf":
        log("[plan] per-leaf data path (pack overhead loses; packed disabled for this run)")
        packed = False
    return Planned(plan_obj, mode, packed,
                   None if cluster_weights is None else tuple(cluster_weights), stats,
                   moe_a2a_mode, moe_weights)


@dataclasses.dataclass
class _Live:
    """What a pod failure rebuilds: the groups, the model, the step and
    the optimizer state, and this rank's place in the world."""
    rt: Runtime
    model: Model
    tcfg: TrainConfig
    step_fn: Any
    opt: Any
    pods: int
    rows: slice
    group: Any = None       # the ranks still training (None: the world)


def run(arch: str = "qwen2.5-3b", *, smoke: bool = False, steps: int = 4,
        mode: str = "hier", compression: str | None = None,
        global_batch: int = 4, seq: int = 1024, lr: float = 3e-3,
        log_every: int = 1, seed: int = 0, pods: int = 1, device="cuda",
        plan: str = "manual", skew: str = "none", plan_cache: str | None = None,
        packed: bool = True, plan_world: tuple[int, int] | None = None,
        tp: int = 1, sp: bool = False, layers: int | None = None,
        ckpt_dir: str | None = None, ckpt_every: int = 50, resume: bool = False,
        watchdog_max_bad_steps: int = 3, watchdog_spike_factor: float = 10.0,
        watchdog_window: int = 64, straggler_factor: float = 3.0,
        straggler_window: int = 32, guard: bool = False, chaos: int | None = None,
        elastic: bool = False, inject_pod_failure: int | None = None,
        log=print) -> dict:
    """Train ``steps`` steps in the running process group and return what
    was measured.  Step times are host wall-clock around work that ends
    in a device synchronize.  ``plan``, ``skew``, ``plan_cache`` and
    ``packed`` are the flags of ``make_plan``; ``plan_world`` (pods, ranks
    per pod) prices the plan for that cluster in place of the running
    world, so that a small world runs the plan a larger one would get.
    ``layers`` cuts the depth.

    The runtime knobs are the reference launcher's flags, with its
    meaning: ``ckpt_dir``/``ckpt_every``/``resume`` (the state gathered
    to rank 0, which writes; every rank restores its slices), the NaN
    watchdog's and the straggler monitor's knobs, ``guard`` (the
    collective guard, with its default config), ``chaos``
    (the seed of a fault plan, one fault per class; implies ``guard``),
    ``elastic`` (the re-planning controller) and ``inject_pod_failure``
    (with ``elastic`` and more than one pod: the last pod is reported
    lost just before that step, and its ranks leave the loop).  The
    result adds the guard's report, the injector's log, the elastic
    reports, the watchdog's verdicts and the checkpointed steps."""
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world, rank = dist.get_world_size(), dist.get_rank()
    n_dp = world // tp
    if world % (pods * tp) or global_batch % n_dp:
        raise ValueError(f"world {world}, pods {pods}, tp {tp}, global batch {global_batch}")
    data_per_pod = n_dp // pods
    cfg = get_config(arch, smoke=smoke)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    plan_pods, per_pod = plan_world or (pods, world // pods)
    planned = make_plan(cfg, plan_pods, plan_pods * per_pod, mode, compression, plan=plan,
                        skew=skew, plan_cache=plan_cache, packed=packed,
                        global_batch=global_batch, seq=seq, tp=tp, log=log)
    # the Runtime takes the planned MoE All2All knobs before the model is built
    rt_kw = dict(tp=tp, fsdp=mode == "fsdp", sp=sp, moe_a2a_mode=planned.moe_a2a_mode,
                 moe_cluster_weights=planned.moe_cluster_weights)
    rt = runtime_for_groups(pods=pods, data_per_pod=data_per_pod, **rt_kw)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    def build(rt: Runtime, tcfg: TrainConfig) -> tuple[Model, Any, Any]:
        model = Model(cfg, rt, device)
        if mode == "fsdp":
            model.with_fsdp(group_size(rt.data_group))
        step_fn, init_fn = make_train_step(model, tcfg)
        return model, step_fn, init_fn

    tcfg = TrainConfig(comm_mode=planned.mode, dcn_compression=compression,
                       plan=planned.plan, cluster_weights=planned.cluster_weights,
                       packed=planned.packed, opt=OptConfig(lr=lr, warmup_steps=20))
    model, step_fn, init_fn = build(rt, tcfg)
    live = _Live(rt, model, tcfg, step_fn, init_fn(seed), pods,
                 dp_rows(rank, global_batch, pods, data_per_pod, tp))
    n_params = sum(p.numel() for p in model.parameters())
    dcfg = DataConfig(vocab_size=cfg.vocab_size, global_batch=global_batch,
                      seq_len=seq, seed=seed, enc_seq=cfg.enc_seq,
                      d_model=cfg.d_model if cfg.enc_seq else 0)

    ckpt = _checkpoints(ckpt_dir, rank)
    ckpt_ops: list[dict] = []      # each save and restore: its host ms and the state's GB
    start = 0
    if ckpt and resume and ckpt.latest_step() is not None:
        start, live.opt = _restore(ckpt, live, ckpt_ops)
        log(f"resumed from step {start}")

    watchdog = NaNWatchdog(WatchdogConfig(max_bad_steps=watchdog_max_bad_steps,
                                          loss_spike_factor=watchdog_spike_factor,
                                          window=watchdog_window))
    straggler = StragglerMonitor(factor=straggler_factor, window=straggler_window)
    use_guard = guard or chaos is not None
    log(f"[run] watchdog(max_bad_steps={watchdog_max_bad_steps}, "
        f"spike_factor={watchdog_spike_factor:g}, window={watchdog_window}) "
        f"straggler(factor={straggler_factor:g}, window={straggler_window}) "
        f"guard={'on' if use_guard else 'off'} "
        f"chaos={chaos if chaos is not None else 'off'}")

    grad_bytes = max(1, cfg.param_count() * 4 // tp)
    pod_kw = dict(coll="reduce_scatter" if mode == "hier_zero1" else "all_reduce",
                  pod_axis="pod" if pods > 1 else None, intra_axis="data",
                  compressions=(None, compression) if compression else (None, "bf16"),
                  flat_mechanism="native", try_balanced=False)
    elastic_ctl = None
    if elastic:
        e_topo = topology.tpu_multipod(max(1, pods), world // max(1, pods))
        e_cache = (planner.PlanCache(path=plan_cache) if plan_cache
                   else planner.default_plan_cache())
        # the running topology's cache line: the line a pod failure invalidates
        planner.plan(e_topo, [grad_bytes], cache=e_cache, **pod_kw)
        elastic_ctl = elastic_lib.ElasticController(e_topo, [grad_bytes], plan_cache=e_cache,
                                                    straggler=straggler, plan_kw=pod_kw)

    the_guard = injector = None
    g_topo = topology.tpu_multipod(max(1, pods), max(1, world // max(1, pods)))
    if use_guard:
        the_guard = guard_lib.CollectiveGuard(
            guard_lib.GuardConfig(),
            predicted_step_s=planned.plan.predicted_step_s if planned.plan else None,
            nominal_Bps={i: c.nic_Bps for i, c in enumerate(g_topo.clusters)},
            expected_ranks=range(world), elastic=elastic_ctl)
        # pre-launch desync check: every rank digests the schedule it is about
        # to run, and the digests are gathered over the world
        dsrc = planned.plan if planned.plan is not None else CommConfig(
            mode=planned.mode, pod_group=rt.pod_group if pods > 1 else None,
            intra_group=rt.data_group, n_chunks=tcfg.n_chunks, compression=compression,
            cluster_weights=planned.cluster_weights)
        digests: list = [None] * world
        dist.all_gather_object(digests, guard_lib.schedule_digest(dsrc))
        ev = the_guard.check_agreement(start, dict(enumerate(digests)))
        log(f"[guard] schedule digest {digests[rank]} "
            + (f"DESYNC: {ev.detail}" if ev is not None else f"({world} rank(s) agree)"))
        if chaos is not None:
            fplan = faults_lib.FaultPlan.generate(chaos, steps, n_clusters=g_topo.n_clusters,
                                                  n_ranks=world)
            injector = faults_lib.FaultInjector(fplan)
            log("\n".join(
                f"[chaos] seed {chaos}: {e.kind} @ step {e.step} x{e.duration}"
                + (f" cluster={e.cluster}" if e.cluster is not None else "")
                + (f" rank={e.rank}" if e.rank is not None else "")
                for e in fplan.events))

    def pod_failover(at_step: int) -> tuple[_Live | None, str]:
        """Lose the last pod: re-plan against the survivors, cut the
        survivor groups, rebuild the step on them, and carry the
        parameters and the optimizer state across (the ZeRO-1 master
        through the packed slot-map remap; a checkpoint restore, then a
        re-bootstrap, when the layouts are not remappable).  A rank of the
        lost pod gets None."""
        t0 = time.perf_counter()
        rep = elastic_ctl.report_pod_failure(at_step, elastic_ctl.topo.n_clusters - 1)
        log(f"[elastic] {rep.trigger}: {rep.detail}; re-planned "
            f"{rep.old_fingerprint} -> {rep.new_fingerprint} in "
            f"{rep.replan_latency_s * 1e3:.1f} ms "
            f"({rep.invalidated_entries} cache line(s) invalidated)")
        failover["replan_ms"] = rep.replan_latency_s * 1e3
        # the parameters on the host, gathered within each pod (the lost
        # pod's ranks, gathering only among themselves, skip it)
        t1 = time.perf_counter()
        lost = mesh_coords(rank, data_per_pod, tp)[0] == live.pods - 1
        params = None if lost else state_tree(live.model, None, live.tcfg)[0]
        old_intra = group_size(live.rt.data_group)
        old_leaves = live.model.train_leaves()
        t2 = time.perf_counter()
        new_rt, new_pods = survivor_mesh(live.pods, data_per_pod, lost_pod=live.pods - 1,
                                         **rt_kw)
        survivors = [r for r in range(world)
                     if mesh_coords(r, data_per_pod, tp)[0] != live.pods - 1]
        group = dist.new_group(survivors)
        failover.update(gather_ms=(t2 - t1) * 1e3, cut_ms=(time.perf_counter() - t2) * 1e3)
        if new_rt is None:
            return None, "lost"
        new_tcfg = dataclasses.replace(
            live.tcfg, plan=elastic_ctl.plan if live.tcfg.plan is not None else None)
        new_model, new_step, _ = build(new_rt, new_tcfg)
        t3 = time.perf_counter()
        remap_path = "slot_map"
        if isinstance(live.opt, opt_lib.ZeroState):
            load_state(new_model, (params, None), new_tcfg)
            new_intra = group_size(new_rt.data_group)
            old_layout = elastic_lib.zero1_master_layout(old_leaves, old_intra)
            new_layout = elastic_lib.zero1_master_layout(new_model.train_leaves(), new_intra)
            place = state_shardings(new_model, live.opt, new_tcfg)[1].flat_param
            try:
                # remap_zero_state's slot-map remap, one buffer at a time: each
                # gathered on the host, remapped, placed and dropped
                shards = [place(torch.from_numpy(elastic_lib.remap_flat(
                    zero_global(live.model, live.tcfg, getattr(live.opt, name)), old_layout,
                    new_layout, old_world=old_intra, new_world=new_intra, n_columns=tp)))
                    for name in ("flat_param", "mu", "nu")]
                new_opt = opt_lib.ZeroState(*shards, step=live.opt.step)
            except ValueError as e:
                # the world shrank below the layout's divisibility (or the
                # leaf contents changed): restore onto the survivors
                remap_path = "restore_fallback"
                log(f"[elastic] slot-map remap not applicable ({e}); "
                    "falling back to checkpoint restore")
                new_opt = None
                if ckpt is not None and ckpt.latest_step() is not None:
                    try:
                        new_opt = _restore(ckpt, _Live(new_rt, new_model, new_tcfg, new_step,
                                                       _zero_like(new_model, new_tcfg), new_pods,
                                                       live.rows, group), ckpt_ops)[1]
                    except Exception as e2:  # noqa: BLE001
                        # the checkpointed master rode the old world's layout
                        log(f"[elastic] restore not layout-compatible either ({e2})")
                        new_opt = None
                if new_opt is None:
                    log("[elastic] re-bootstrapping the optimizer from the resharded "
                        "params (moments reset)")
                    new_opt = zero_bootstrap(new_model, new_tcfg)
        else:
            new_opt = load_state(new_model, state_tree(live.model, live.opt, live.tcfg),
                                 new_tcfg)
        failover.update(remap_ms=(time.perf_counter() - t3) * 1e3,
                        total_ms=(time.perf_counter() - t0) * 1e3, remap_path=remap_path)
        me = survivors.index(rank)
        rows = dp_rows(me, global_batch, new_pods, data_per_pod, tp)
        return _Live(new_rt, new_model, new_tcfg, new_step, new_opt, new_pods, rows,
                     group), remap_path

    pre = Prefetcher(dcfg, start_step=start)
    records, losses, verdicts, saved = [], [], [], []
    failover: dict = {}
    injected_failure, alive = False, True
    elastic_remap_path = "slot_map"
    fresh_trace = True     # step 0 builds the kernels: its wall time is not a hang
    try:
        step = start
        while step < steps:
            if (elastic_ctl is not None and not injected_failure
                    and inject_pod_failure is not None and step >= inject_pod_failure
                    and elastic_ctl.topo.n_clusters > 1):
                injected_failure = True
                new_live, elastic_remap_path = pod_failover(step)
                if new_live is None:
                    alive = False        # this rank's pod is lost: wait at the end
                    break
                live = new_live
                fresh_trace = True
            _, batch = pre.get(timeout=30.0)
            # token ids as int64, an encoder-decoder's frames as f32
            b = {k: torch.from_numpy(v[live.rows]).to(device, torch.long if k != "enc" else None)
                 for k, v in batch.items()}
            retraced, fresh_trace = fresh_trace, False
            chaos_hook = None
            stalled_s = 0.0
            if injector is not None:
                # a hung rank stalls past the guard's deadline (the in-band
                # emulation of a silent rank)
                stalled_s = injector.stall(
                    step, the_guard.deadline_s or the_guard.cfg.min_deadline_s)
                chaos_hook = injector.corruption_hook(step, rank=rank)
            straggler.start()
            timing: dict = {}
            before = ops.launch_counts()

            def _run(b=b, hook=chaos_hook):
                _sync(device)
                t0 = time.perf_counter()
                if hook is not None:
                    with primitives.inject_hook(hook):
                        out = live.step_fn(live.opt, b)
                else:
                    out = live.step_fn(live.opt, b)
                _sync(device)
                timing["dt"] = time.perf_counter() - t0
                return out

            if the_guard is not None:
                thunk = _run if injector is None else injector.wrap_transfer(step, _run)
                m = the_guard.retry(step, thunk)
            else:
                m = _run()
            after = ops.launch_counts()
            loss = m["loss"]
            slow = straggler.stop()
            guard_ms = None
            if the_guard is not None:
                t_guard = time.perf_counter()
                hung = injector.hung_ranks(step) if injector is not None else ()
                for r in range(world):
                    if r not in hung:
                        the_guard.heartbeat(step, r)
                if chaos_hook is None and not retraced:
                    # a step that builds kernels is not a hang signal
                    gev = the_guard.observe_step_time(step, timing.get("dt", 0.0) + stalled_s)
                    if gev is not None:
                        log(f"[guard] {gev.kind} @ step {step}: {gev.detail} "
                            f"({gev.attribution})")
                # with the finite gate a NaN payload never reaches the
                # parameters: the synced grad norm is where it surfaces
                gev = the_guard.check_payload(step, {
                    "grad_norm": np.float32(m["grad_norm"]), "loss": np.float32(loss),
                    "params": live.model.param_tree()})
                if gev is not None:
                    log(f"[guard] {gev.kind} @ step {step}: {gev.detail}")
                if g_topo.n_clusters > 1:
                    # the emulated link-health feed: the nominal C2C time of
                    # this step's gradient payload (its size varied so that
                    # the alpha-beta fit is well-posed), inflated by any
                    # active degradation
                    nbytes = int(grad_bytes * (1.0 + 0.25 * (step % 4))) + 1
                    for ci, cl in enumerate(g_topo.clusters):
                        t_obs = nbytes / cl.nic_Bps
                        if injector is not None:
                            t_obs = injector.perturb_transfer_time(step, ci, t_obs)
                        gev = the_guard.observe_transfer(step, ci, nbytes, t_obs)
                        if gev is None:
                            continue
                        log(f"[guard] {gev.kind} @ step {step}: {gev.detail} "
                            f"({gev.attribution})")
                        if gev.replan is not None:
                            # re-planned against the derated fabric: rebuild
                            # the step with the new plan on the same groups
                            if live.tcfg.plan is not None:
                                live.tcfg = dataclasses.replace(live.tcfg,
                                                                plan=elastic_ctl.plan)
                                live.step_fn, _ = make_train_step(live.model, live.tcfg)
                                fresh_trace = True
                            elastic_remap_path = "none (same mesh)"
                guard_ms = (time.perf_counter() - t_guard) * 1e3
            if elastic_ctl is not None:
                # confirmed persistent stragglers are surfaced: host eviction
                # is the scheduler's call
                elastic_ctl.observe_step(step, slow=slow)
            verdict = watchdog.observe(loss)
            verdicts.append((step, verdict))
            rec = {"step": step, "loss": loss, "gnorm": m["grad_norm"], "aux": m["aux"],
                   "ms_per_step": timing["dt"] * 1e3, "gated": m["gated"],
                   "launches": {k: after[k] - before[k] for k in after},
                   "verdict": verdict, "guard_ms": guard_ms}
            records.append(rec)
            if step % log_every == 0:
                log(json.dumps(rec))
            if verdict == "rollback" and ckpt and _latest(ckpt, live) is not None:
                step, live.opt = _restore(ckpt, live, ckpt_ops)
                log(f"[health] non-finite/spiking loss -> rolled back to {step}")
                continue
            if verdict == "skip":
                # the finite gate left the state as it was: that is the skip
                log(f"[health] step {step}: loss {loss} skipped")
                step += 1
                continue
            if elastic_ctl is not None and elastic_ctl.state == "replanned":
                log(elastic_ctl.resumed(step, remap_path=elastic_remap_path).describe())
            losses.append(loss)
            if ckpt is not None and step and step % ckpt_every == 0:
                _save(ckpt, live, step, ckpt_ops, asynchronous=True)
                saved.append(step)
            step += 1
        if ckpt is not None and alive:
            _save(ckpt, live, step, ckpt_ops, asynchronous=False)
            saved.append(step)
    finally:
        pre.close()
    if injected_failure:
        dist.barrier()         # the lost pod's ranks wait here for the survivors
    report = the_guard.report() if the_guard is not None else None
    if report is not None:
        dl = report["deadline_s"]
        log(f"[guard] deadline {'unarmed' if dl is None else f'{dl:.3f}s'}; "
            f"events: {report['counts'] or 'none'}")
    if injector is not None:
        log(f"[chaos] {len(injector.injected)} injected action(s): "
            + (", ".join(sorted({i['kind'] for i in injector.injected})) or "none"))
    timed = [r["ms_per_step"] for r in records[1:]] or [r["ms_per_step"] for r in records[:1]]
    step_ms = statistics.median(timed) if timed else float("nan")
    return {
        "arch": cfg.name, "device": str(device), "world": world, "pods": pods, "tp": tp,
        "sp": sp, "rank": rank,
        "mode": planned.mode, "compression": compression, "packed": planned.packed,
        "moe_a2a_mode": rt.moe_a2a_mode if cfg.n_experts else None,
        "plan": None if planned.plan is None else planned.plan.summary(),
        "plan_cache": planned.cache,
        "global_batch": global_batch, "seq": seq, "params": n_params,
        "records": records, "step_ms": step_ms,
        "tokens_per_s": global_batch * seq / (step_ms / 1e3),
        "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                        if device.type == "cuda" else None),
        "resumed_from": start if start else None, "alive": alive,
        "guard": report,
        "chaos": injector.summary() if injector is not None else None,
        "elastic": ([r.summary() for r in elastic_ctl.reports]
                    if elastic_ctl is not None else None),
        "losses": losses, "watchdog": verdicts, "checkpoints": saved,
        "checkpoint_ops": ckpt_ops, "failover": failover or None,
    }


def _checkpoints(ckpt_dir: str | None, rank: int) -> CheckpointManager | None:
    """Every rank's manager of ``ckpt_dir``: rank 0 makes the directory and
    finishes any interrupted publish first."""
    if not ckpt_dir:
        return None
    if rank == 0:
        mgr = CheckpointManager(ckpt_dir)
    dist.barrier()
    return mgr if rank == 0 else CheckpointManager(ckpt_dir)


def _latest(ckpt: CheckpointManager, live: _Live) -> int | None:
    """The newest checkpoint once rank 0's writes are done."""
    if dist.get_rank() == 0:
        ckpt.wait()
    dist.barrier(group=live.group)
    return ckpt.latest_step()


def _gb(state) -> float:
    return sum(t.numel() * t.element_size() for t in tree_lib.leaves(state)
               if isinstance(t, torch.Tensor)) / 1e9


def _save(ckpt: CheckpointManager, live: _Live, step: int, ops_log: list,
          asynchronous: bool) -> None:
    """Gather the state (every rank) and write it (rank 0): in a thread
    with ``asynchronous``, else before every rank goes on.  ``ops_log``
    gets the host milliseconds this rank spent and the state's size."""
    t0 = time.perf_counter()
    state = state_tree(live.model, live.opt, live.tcfg, keep=dist.get_rank() == 0)
    if dist.get_rank() == 0:
        if asynchronous:
            ckpt.save_async(step, state)
        else:
            ckpt.save(step, state)
            ckpt.wait()
    if not asynchronous:
        dist.barrier(group=live.group)
    ops_log.append({"op": "save_async" if asynchronous else "save", "step": step,
                    "ms": (time.perf_counter() - t0) * 1e3,
                    "gb": _gb(state_like(live.model, live.opt, live.tcfg))})


def _restore(ckpt: CheckpointManager, live: _Live, ops_log: list) -> tuple[int, Any]:
    """Every rank reads the newest checkpoint and adopts its slices, one
    leaf at a time: (the step, the optimizer state)."""
    t0 = time.perf_counter()
    like = state_like(live.model, live.opt, live.tcfg)
    step, state, _ = ckpt.restore(like, _latest(ckpt, live),
                                  shardings=state_shardings(live.model, live.opt, live.tcfg))
    opt = load_state(live.model, state, live.tcfg, sliced=True)
    ops_log.append({"op": "restore", "step": step, "ms": (time.perf_counter() - t0) * 1e3,
                    "gb": _gb(like)})
    return step, opt


def _zero_like(model: Model, tcfg: TrainConfig) -> opt_lib.ZeroState:
    """A ZeroState of meta tensors shaped as this rank's master shard."""
    isize = group_size(tcfg.comm_config(model.rt).intra_group)
    n = collectives._zero1_layout(model.train_leaves(), isize).padded_total // isize
    flat = torch.empty((n,), dtype=torch.float32, device="meta")
    return opt_lib.ZeroState(flat, flat, flat)


def main(argv=None) -> list[float]:
    """Parse ``argv``, train, print the summary JSON and return the
    losses, one per step taken (the reference's ``main`` returns them)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true", help="the arch's small config")
    ap.add_argument("--layers", type=int, default=None, help="cut the depth to this")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--mode", default="hier", choices=list(MODES))
    ap.add_argument("--compression", default=None, choices=["bf16", "int8"])
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1, help="tensor-parallel ranks per replica")
    ap.add_argument("--sp", action="store_true", help="sequence parallelism (with --tp)")
    ap.add_argument("--dist-backend", default=None, choices=list(BACKENDS),
                    help="nccl (the default on the card) or gloo (the CPU's, and "
                         "ranks sharing one card)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--plan", default="manual", choices=["manual", "auto"],
                    help="auto: the planner picks mode, chunks and codec per "
                         "gradient bucket, replacing --mode's schedule")
    ap.add_argument("--skew", default="none", choices=["none", "auto"],
                    help="auto: derive the per-pod batch split and its "
                         "gradient weights (core/skew.py)")
    ap.add_argument("--plan-cache", default=None, metavar="PATH",
                    help="disk-backed plan cache: a later launch with the same "
                         "topology and knobs reuses the plan")
    ap.add_argument("--no-packed", action="store_true",
                    help="the per-leaf data path in place of the packed layout")
    ap.add_argument("--elastic", action="store_true",
                    help="the elastic re-planning controller (runtime/elastic.py): on a "
                         "pod failure the old topology's plan-cache lines are "
                         "invalidated, the planner re-runs against the survivors, the "
                         "ZeRO-1 master is remapped through the packed slot map, and "
                         "training resumes on the survivor groups; straggler verdicts "
                         "are fed to it too (surfaced, not acted on)")
    ap.add_argument("--inject-pod-failure", type=int, default=None, metavar="STEP",
                    help="with --elastic and more than one pod: report the last pod "
                         "as failed just before STEP executes (its ranks leave the loop)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--guard", action="store_true",
                    help="arm the collective guard (runtime/guard.py): per-step comm "
                         "deadline, pre-launch schedule-digest agreement, payload "
                         "checksums, bounded retry on transient transfer failures, and "
                         "per-link bandwidth EWMAs whose degraded verdicts escalate to "
                         "the elastic controller (re-plan needs --elastic)")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="seeded chaos engine (runtime/faults.py): one fault per class "
                         "(degraded link, transient transfer failure, rank hang, NaN "
                         "payload, bit flip) at deterministic steps; implies --guard")
    ap.add_argument("--watchdog-max-bad-steps", type=int, default=3,
                    help="NaN watchdog: consecutive non-finite/spiking losses before "
                         "rollback")
    ap.add_argument("--watchdog-spike-factor", type=float, default=10.0,
                    help="NaN watchdog: loss vs trailing median ratio flagged as a spike")
    ap.add_argument("--watchdog-window", type=int, default=64,
                    help="NaN watchdog: trailing median window (steps)")
    ap.add_argument("--straggler-factor", type=float, default=3.0,
                    help="straggler monitor: step slower than factor x trailing median "
                         "is flagged")
    ap.add_argument("--straggler-window", type=int, default=32,
                    help="straggler monitor: trailing median window (steps)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    started = init_world(device, args.dist_backend)
    try:
        res = run(args.arch, smoke=args.smoke, steps=args.steps, mode=args.mode,
                  compression=args.compression,
                  global_batch=args.global_batch, seq=args.seq, lr=args.lr,
                  log_every=args.log_every, seed=args.seed, pods=args.pods,
                  device=device, plan=args.plan, skew=args.skew,
                  plan_cache=args.plan_cache, packed=not args.no_packed, tp=args.tp,
                  sp=args.sp, layers=args.layers, ckpt_dir=args.ckpt_dir,
                  ckpt_every=args.ckpt_every,
                  resume=args.resume, watchdog_max_bad_steps=args.watchdog_max_bad_steps,
                  watchdog_spike_factor=args.watchdog_spike_factor,
                  watchdog_window=args.watchdog_window,
                  straggler_factor=args.straggler_factor,
                  straggler_window=args.straggler_window, guard=args.guard,
                  chaos=args.chaos, elastic=args.elastic,
                  inject_pod_failure=args.inject_pod_failure)
    finally:
        if started:
            dist.destroy_process_group()
    res.pop("records")
    print(json.dumps(res))
    return res["losses"]


if __name__ == "__main__":
    main()
