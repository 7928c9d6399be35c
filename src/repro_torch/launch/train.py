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
    RANK=r WORLD_SIZE=8 MASTER_ADDR=localhost MASTER_PORT=29500 \
        python -m repro_torch.launch.train --smoke --device cpu --pods 2 --tp 2

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

Weights are random, drawn from ``--seed``; the data is the synthetic
zipf-ish stream of ``data/pipeline.py``.  Every ``--log-every`` steps a
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

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import get_config
from repro_torch.core import cost_model, overlap, planner, topology
from repro_torch.core import skew as skew_lib
from repro_torch.data.pipeline import DataConfig, batches
from repro_torch.kernels import ops
from repro_torch.launch.mesh import BACKENDS, init_world, mesh_coords, runtime_for_groups
from repro_torch.models import moe as moe_lib
from repro_torch.models.model import Model, resolve_device
from repro_torch.parallel.sharding import Runtime, group_size
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import TrainConfig, make_train_step

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


def run(arch: str = "qwen2.5-3b", *, smoke: bool = False, steps: int = 4,
        mode: str = "hier", compression: str | None = None,
        global_batch: int = 4, seq: int = 1024, lr: float = 3e-3,
        log_every: int = 1, seed: int = 0, pods: int = 1, device="cuda",
        plan: str = "manual", skew: str = "none", plan_cache: str | None = None,
        packed: bool = True, plan_world: tuple[int, int] | None = None,
        tp: int = 1, sp: bool = False, layers: int | None = None, log=print) -> dict:
    """Train ``steps`` steps in the running process group and return what
    was measured.  Step times are host wall-clock around work that ends
    in a device synchronize.  ``plan``, ``skew``, ``plan_cache`` and
    ``packed`` are the flags of ``make_plan``; ``plan_world`` (pods, ranks
    per pod) prices the plan for that cluster in place of the running
    world, so that a small world runs the plan a larger one would get.
    ``layers`` cuts the depth."""
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
    rt = runtime_for_groups(pods=pods, data_per_pod=data_per_pod, tp=tp,
                            fsdp=mode == "fsdp", sp=sp, moe_a2a_mode=planned.moe_a2a_mode,
                            moe_cluster_weights=planned.moe_cluster_weights)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    model = Model(cfg, rt, device)
    if mode == "fsdp":
        model.with_fsdp(group_size(rt.data_group))
    tcfg = TrainConfig(comm_mode=planned.mode, dcn_compression=compression,
                       plan=planned.plan, cluster_weights=planned.cluster_weights,
                       packed=planned.packed, opt=OptConfig(lr=lr, warmup_steps=20))
    step_fn, init_fn = make_train_step(model, tcfg)
    opt = init_fn(seed)
    n_params = sum(p.numel() for p in model.parameters())
    dcfg = DataConfig(vocab_size=cfg.vocab_size, global_batch=global_batch,
                      seq_len=seq, seed=seed)
    rows = dp_rows(rank, global_batch, pods, data_per_pod, tp)
    records = []
    for step, batch in batches(dcfg):
        if step >= steps:
            break
        b = {k: torch.from_numpy(v[rows]).long().to(device) for k, v in batch.items()}
        before = ops.launch_counts()
        _sync(device)
        t0 = time.perf_counter()
        m = step_fn(opt, b)
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        after = ops.launch_counts()
        rec = {"step": step, "loss": m["loss"], "gnorm": m["grad_norm"], "aux": m["aux"],
               "ms_per_step": ms, "gated": m["gated"],
               "launches": {k: after[k] - before[k] for k in after}}
        records.append(rec)
        if step % log_every == 0:
            log(json.dumps(rec))
    timed = [r["ms_per_step"] for r in records[1:]] or [records[0]["ms_per_step"]]
    step_ms = statistics.median(timed)
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
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true", help="the arch's small config")
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
                  sp=args.sp)
    finally:
        if started:
            dist.destroy_process_group()
    res.pop("records")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
