"""The dry run: one (arch x shape x mesh) cell of the production mesh,
priced shapes only (the counterpart of the JAX package's
``launch/dryrun.py``).

    python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k --mesh multi --plan auto
    python -m repro_torch.launch.dryrun --arch whisper-tiny --shape train_4k --mesh multi \\
        --plan auto --device cpu --out d.json
    python -m repro_torch.launch.dryrun --arch qwen3-moe-30b-a3b --shape prefill_32k --mesh multi
    python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k --mode hier \\
        --remat-policy save_collectives --sp --elastic --guard --chaos 0

The reference lowers and compiles the cell with XLA on 512 virtual
devices and reads the compiled module.  The port has no XLA: it RUNS its
own step once and compiles nothing.  The step runs under
``FakeTensorMode`` (tensors with shapes and no data) on a world of fake
ranks of the production mesh's size (``launch/mesh.py``
``make_production_world``: 512 ranks multi-pod, 256 single-pod), and
rank 0 is traced: ``launch/analysis.py`` records what it computes,
moves and holds, and prices it on the H100's roofline.  The training
cell's step starts with its optimizer state present (the AdamW moments,
or the ZeRO-1 master shard of ``runtime.elastic.zero1_master_layout``);
a prefill cell runs the prefill and the argmax, a decode cell one decode
step over caches at the shape's length.

``--device cuda`` (the default) traces the card's path: every kernel
wrapper takes its shape-only branch (``kernels/_build.py``), counted in
``kernels``; it needs a CUDA build of torch (views and autograd of fake
CUDA tensors ask for the CUDA device guard) and no card.  ``--device
cpu`` traces the plain path, which is what the reference's default (no
``--pallas``) prices.  Nothing switches device by itself.

The host arithmetic is the reference's, copied: ``input_specs`` (as torch
shapes and dtypes), ``model_flops_for``, ``moe_a2a_bytes``, ``auto_plan``,
``_dryrun_topology``, ``guard_section``, ``chaos_section`` and
``elastic_replan_report``, over the port's copies of the planner, guard,
faults and elastic modules.  The result JSON keeps ``lower_cell``'s
keys, with ``flops``/``bytes`` in place of ``xla_cost``, ``trace_s`` in
place of ``lower_s``/``compile_s``, ``device`` in place of
``use_pallas``, and ``kernels`` (the shape-only calls by kernel).  On
error it writes ``status: error`` and exits 1, as the reference does.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import time
import traceback

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import SHAPES, cell_applicable, get_config, get_shape
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels import _build
from repro_torch.launch import analysis
from repro_torch.launch.mesh import make_production_world, production_axes
from repro_torch.models.model import Model
from repro_torch.parallel.sharding import Runtime, group_size
from repro_torch.serve.serve_step import make_serve_steps
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.train_step import TrainConfig, make_train_step

MODES = ("flat", "hier", "hier_pipelined", "hier_border_rs", "hier_overlap",
         "hier_zero1", "fsdp")
METHOD = ("shapes-only run of the port's step under FakeTensorMode on a fake world of "
          "{n} rank(s), rank 0 traced; run, not compiled")
BYTES_NOTE = ("unfused: the inputs plus the outputs of every dispatched op and shape-only "
              "kernel, an upper bound on XLA's fused figure")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """(shape, dtype) of every model input, global, as the reference's
    ``ShapeDtypeStruct`` stand-ins (the port's steps take token ids as
    int64; ``trace_cell`` makes them so)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        out = {"tokens": ((B, S), torch.int32),
               "labels": ((B, S), torch.int32)}
        if cfg.n_enc_layers:
            out["enc"] = ((B, cfg.enc_seq, cfg.d_model), torch.float32)
        return out
    if shape.kind == "prefill":
        out = {"tokens": ((B, S), torch.int32)}
        if cfg.n_enc_layers:
            out["enc"] = ((B, cfg.enc_seq, cfg.d_model), torch.float32)
        return out
    return {"token": ((B, 1), torch.int32)}


def model_flops_for(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS: 6·N·D for training, 2·N·D for inference (N = active
    params, D = tokens processed)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # one token per request


def moe_a2a_bytes(cfg: ModelConfig, shape: ShapeConfig | None,
                  n_chips: int) -> int:
    """Per-rank All2All payload of one MoE layer's dispatch (and
    combine): the capacity-padded expert buckets each rank ships —
    tokens×hidden×dtype (Table 2).  Tokens are sliced 1/world on the ep
    path, padded by the capacity factor; 4 B/elem matches the f32
    gradient-volume convention of ``auto_plan``."""
    from repro_torch.models import moe as moe_lib

    tokens = (shape.global_batch * shape.seq_len
              if shape is not None and shape.kind == "train" else 4096)
    t_loc = max(1, tokens // max(1, n_chips))
    cap = moe_lib._capacity(t_loc, cfg.top_k, cfg.n_experts, 1.25)
    return max(1, cfg.n_experts * cap * cfg.d_model * 4)


def auto_plan(arch: str, *, multi_pod: bool, comm_mode: str = "hier",
              allow_int8: bool = False, shape_name: str | None = None,
              skew: str = "none", packed: bool = True,
              border_scarce: bool = False,
              plan_cache_path: str | None = None):
    """--plan auto: run the cost-model planner for this cell's
    production topology and gradient volume; returns
    (CommPlan, chosen Candidate, a2a CommPlan | None, cache stats dict).

    The reference's, copied: the plan goes through a
    ``core.plan_cache.PlanCache`` (the process-wide default, or a
    disk-backed one at ``plan_cache_path``, which lets hillclimb's dry-run
    subprocesses share plans); the ZeRO-1 sync is priced on
    reduce_scatter; int8 must be opted into; balanced subgroups are off.
    With a training ``shape_name`` the gradients are split into
    readiness-ordered layer buckets priced against the backward's
    timeline (the plan may recommend ``hier_overlap``); ``skew='auto'``
    runs the joint skew + comm optimizer; an MoE architecture also gets
    its All2All plan; ``border_scarce`` prices
    ``topology.tpu_multipod_scarce``.  The topology is the reference's
    TPU v5e model, so the plans equal the reference's."""
    from repro_torch.core import cost_model, overlap, planner, topology
    from repro_torch.core import skew as skew_lib
    from repro_torch.launch.mesh import PRODUCTION_MULTI_SHAPE

    n_pods, _, tp_size = PRODUCTION_MULTI_SHAPE
    if not multi_pod:
        n_pods = 1
    chips_per_pod = (
        PRODUCTION_MULTI_SHAPE[1] * PRODUCTION_MULTI_SHAPE[2])
    topo = (topology.tpu_multipod_scarce(n_pods, chips_per_pod)
            if border_scarce else
            topology.tpu_multipod(n_pods, chips_per_pod))
    cfg = get_config(arch)
    grad_bytes = max(1, cfg.param_count() * 4 // tp_size)
    pc = (planner.PlanCache(path=plan_cache_path) if plan_cache_path
          else planner.default_plan_cache())
    plan_kw = dict(
        cache=pc,
        coll="reduce_scatter" if comm_mode == "hier_zero1" else "all_reduce",
        pod_axis="pod" if multi_pod else None, intra_axis="data",
        compressions=(None, "bf16", "int8") if allow_int8 else (None, "bf16"),
        flat_mechanism="native", try_balanced=False,
        # candidates are priced for the data path that will execute:
        # Pack/Unpack steps when packed, legacy re-pads free when
        # --no-packed.  The leaf-count estimate (embed + final norm +
        # lm_head + ~12 tensors per layer) arms the planner's per-leaf
        # fallback; main reads plan.data_path and drops Pack/Unpack when
        # packing loses.
        packed=packed,
        n_leaves=4 + 12 * max(1, cfg.n_layers))
    # structural modes (fsdp / hier_zero1) execute a monolithic sync, so
    # their plan must be priced at that granularity
    sizes, backward_s, train_shape = [grad_bytes], None, None
    if shape_name is not None:
        shape = get_shape(shape_name)
        if shape.kind == "train":
            train_shape = shape
            if comm_mode not in ("fsdp", "hier_zero1"):
                backward_s = cost_model.backward_compute_time(
                    topo, model_flops_for(cfg, shape))
                sizes = overlap.bucket_sizes_for_volume(grad_bytes,
                                                        cfg.n_layers)
    sim_cache: dict = {}
    skew_split = skew_comp = None
    if skew == "auto" and train_shape is not None:
        sp = skew_lib.optimize(
            topo, model_flops_for(cfg, train_shape), sizes,
            total_microbatches=max(topo.n_clusters,
                                   train_shape.global_batch),
            # structural modes execute one monolithic sequential sync —
            # no backward window to hide behind, so score sequentially
            backward_frac=(0.0 if comm_mode in ("fsdp", "hier_zero1")
                           else 2.0 / 3.0),
            _sim_cache=sim_cache, **plan_kw)
        skew_split, skew_comp = sp.split, sp.compute_s
        plan = sp.plan
    else:
        plan = planner.plan(topo, sizes, backward_compute_s=backward_s,
                            _sim_cache=sim_cache, **plan_kw)
    if plan.overlap is not None and plan.recommended_mode() != "hier_overlap":
        # overlap doesn't win -> execution is one monolithic collective;
        # re-plan at that granularity so config_for resolves a schedule
        # tuned for the payload that actually crosses the wire
        plan = planner.plan(topo, [grad_bytes], skew=skew_split,
                            skew_compute_s=skew_comp,
                            _sim_cache=sim_cache, **plan_kw)
    big = max(plan.buckets, key=lambda b: b.nbytes)
    a2a_plan = None
    if cfg.n_experts:
        a2a_bytes = moe_a2a_bytes(cfg, train_shape,
                                  n_pods * chips_per_pod)
        a2a_plan = planner.plan(
            topo, [a2a_bytes] * max(1, cfg.n_layers),
            coll="all_to_all",
            pod_axis="pod" if multi_pod else None, intra_axis="data",
            compressions=(None, "bf16"), flat_mechanism="native",
            try_balanced=False, cache=pc, _sim_cache=sim_cache)
    return plan, big.candidate, a2a_plan, pc.stats()


def _dryrun_topology(multi_pod: bool, border_scarce: bool):
    from repro_torch.core import topology
    from repro_torch.launch.mesh import PRODUCTION_MULTI_SHAPE

    n_pods = PRODUCTION_MULTI_SHAPE[0] if multi_pod else 1
    chips_per_pod = PRODUCTION_MULTI_SHAPE[1] * PRODUCTION_MULTI_SHAPE[2]
    return (topology.tpu_multipod_scarce(n_pods, chips_per_pod)
            if border_scarce else
            topology.tpu_multipod(n_pods, chips_per_pod))


def guard_section(plan, *, mode: str, chunks: int,
                  compression: str | None, n_chips: int):
    """--guard: the collective guard's pre-launch view of this cell —
    the schedule digest every rank must agree on (desync detector) and
    the comm deadline the guard would arm from the cost model's
    prediction.  A dry run traces one process, so all ranks digest
    identically; the chaos harness perturbs one digest to prove the
    detector fires."""
    from repro_torch.core.schedule import STRUCTURAL_MODES, build_schedule
    from repro_torch.runtime import guard as guard_lib

    if plan is not None:
        digest = guard_lib.schedule_digest(plan)
        predicted = plan.predicted_step_s
    else:
        sched = build_schedule("all_reduce",
                               STRUCTURAL_MODES.get(mode, mode),
                               chunks, compression)
        digest = guard_lib.schedule_digest(sched)
        predicted = None
    gcfg = guard_lib.GuardConfig()
    ok, _, outliers = guard_lib.digest_agreement(
        {r: digest for r in range(max(1, n_chips))})
    return {"schedule_digest": digest, "ranks": int(max(1, n_chips)),
            "agreement": bool(ok), "outliers": list(outliers),
            "deadline_margin": gcfg.deadline_margin,
            "deadline_s": (None if predicted is None else
                           max(gcfg.min_deadline_s,
                               gcfg.deadline_margin * predicted))}


def chaos_section(seed: int, arch: str, *, multi_pod: bool,
                  border_scarce: bool, plan, mode: str, chunks: int,
                  compression: str | None, n_steps: int = 32):
    """--chaos: the seeded fault plan this cell would face, plus the
    degraded-fabric pricing — the gradient sync simulated on the
    nominal topology vs. on the fault plan's worst active link
    degradation (``simulate_schedule(link_scale=...)``), which is the
    slowdown the guard's link-health EWMA must detect and the elastic
    re-plan must price around."""
    from repro_torch.core.schedule import STRUCTURAL_MODES, build_schedule
    from repro_torch.core.transport_sim import simulate_schedule
    from repro_torch.launch.mesh import PRODUCTION_MULTI_SHAPE
    from repro_torch.runtime.faults import FaultPlan

    topo = _dryrun_topology(multi_pod, border_scarce)
    fplan = FaultPlan.generate(seed, n_steps,
                               n_clusters=topo.n_clusters,
                               n_ranks=topo.n_ranks)
    if plan is not None:
        b = max(plan.buckets, key=lambda x: x.nbytes)
        sched_mode, nch, comp = (b.candidate.mode, b.candidate.n_chunks,
                                 b.candidate.compression)
        nbytes = b.nbytes
    else:
        sched_mode, nch, comp = STRUCTURAL_MODES.get(mode, mode), chunks, \
            compression
        nbytes = max(1, get_config(arch).param_count() * 4
                     // PRODUCTION_MULTI_SHAPE[2])
    sched = build_schedule("all_reduce", sched_mode, nch, comp)
    # worst concurrent degradation over the plan's timeline
    worst: dict[int, float] = {}
    for e in fplan.events:
        if e.kind == "degraded_link":
            for ci, s in fplan.link_scale(e.step).items():
                worst[ci] = min(worst.get(ci, 1.0), s)
    nominal_s = simulate_schedule(sched, topo, nbytes, level="cluster")
    degraded_s = (simulate_schedule(sched, topo, nbytes, level="cluster",
                                    link_scale=worst)
                  if worst else nominal_s)
    return {"seed": int(seed), "n_steps": int(n_steps),
            "events": fplan.summary()["events"],
            "schedule": {"mode": sched_mode, "n_chunks": nch,
                         "compression": comp, "nbytes": int(nbytes)},
            "degraded_links": {str(ci): round(1.0 / s, 3)
                               for ci, s in sorted(worst.items())},
            "nominal_sync_s": nominal_s,
            "degraded_sync_s": degraded_s,
            "slowdown": (degraded_s / nominal_s if nominal_s > 0
                         else None)}


def elastic_replan_report(arch: str, *, multi_pod: bool,
                          comm_mode: str = "hier",
                          border_scarce: bool = False,
                          plan_cache_path: str | None = None):
    """--elastic: simulate a topology loss against this cell's
    production topology and run the detect -> re-plan transition
    (``runtime.elastic.ElasticController``).  Multi-pod cells lose
    their last pod (``drop_cluster``); single-pod cells confirm a
    persistent straggler and evict half the hosts
    (``shrink_cluster``).  Returns the ``ReplanReport`` — the result
    JSON carries it under ``"replan"`` with the plan-cache
    invalidation observable in ``"plan_cache"`` stats."""
    from repro_torch.core import planner, topology
    from repro_torch.launch.mesh import PRODUCTION_MULTI_SHAPE
    from repro_torch.runtime.elastic import ElasticConfig, ElasticController

    n_pods, _, tp_size = PRODUCTION_MULTI_SHAPE
    if not multi_pod:
        n_pods = 1
    chips_per_pod = PRODUCTION_MULTI_SHAPE[1] * PRODUCTION_MULTI_SHAPE[2]
    topo = (topology.tpu_multipod_scarce(n_pods, chips_per_pod)
            if border_scarce else
            topology.tpu_multipod(n_pods, chips_per_pod))
    cfg = get_config(arch)
    grad_bytes = max(1, cfg.param_count() * 4 // tp_size)
    pc = (planner.PlanCache(path=plan_cache_path) if plan_cache_path
          else planner.default_plan_cache())
    plan_kw = dict(
        coll="reduce_scatter" if comm_mode == "hier_zero1" else "all_reduce",
        pod_axis="pod" if multi_pod else None, intra_axis="data",
        compressions=(None, "bf16"), flat_mechanism="native",
        try_balanced=False)
    # make sure the doomed fingerprint has a cache line to invalidate
    planner.plan(topo, [grad_bytes], cache=pc, **plan_kw)
    ctl = ElasticController(
        topo, [grad_bytes], plan_cache=pc,
        config=ElasticConfig(
            on_straggler=lambda t: t.shrink_cluster(
                0, max(1, t.clusters[0].n_nodes // 2))),
        plan_kw=plan_kw)
    if topo.n_clusters > 1:
        rep = ctl.report_pod_failure(0, topo.n_clusters - 1)
    else:
        rep = None
        for s in range(ctl.cfg.straggler_patience):
            rep = ctl.observe_step(s, slow=True)
        assert rep is not None
    # a dry run traces but never steps, so nothing is resharded
    return ctl.resumed(rep.step_detected, remap_path="none (dry run)")


# ---------------------------------------------------------------------------
# The traced step
# ---------------------------------------------------------------------------

def _fake_model(cfg: ModelConfig, rt: Runtime, device: torch.device, fsdp: int) -> Model:
    """The model with shapes-only parameters on ``device`` (inside
    ``FakeTensorMode``): drawn on the CPU, as ``Model.draw`` draws from a
    ``torch.Generator`` of the model's device, then laid on ``device`` as
    empty tensors of the same shapes and sliced as ``set_params`` slices."""
    model = Model(cfg, rt, device="cpu")
    if fsdp > 1:
        model.with_fsdp(fsdp)
    tree = model.draw(0)
    if device.type != "cpu":
        tree = _laid_on(tree, device)
    return model.set_params(tree)


def _laid_on(tree, device: torch.device):
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device=device)
    if isinstance(tree, list):
        return [_laid_on(t, device) for t in tree]
    return {k: _laid_on(v, device) for k, v in tree.items()}


def _zero_state(model: Model, tcfg: TrainConfig, device: torch.device) -> opt_lib.ZeroState:
    """The ZeRO-1 state's shapes: this rank's shard of the packed f32
    master over the intra group, and its two moments
    (``runtime.elastic.zero1_master_layout``, as the reference's dry run
    shapes it)."""
    from repro_torch.runtime import elastic as elastic_lib

    isize = group_size(tcfg.comm_config(model.rt).intra_group)
    layout = elastic_lib.zero1_master_layout(model.train_leaves(), isize)
    n = layout.padded_total // isize
    return opt_lib.ZeroState(*(torch.empty((n,), dtype=torch.float32, device=device)
                               for _ in range(3)))


def _local_batch(global_batch: int, axes: dict[str, int], serving: bool) -> int:
    """The rows a rank holds: the batch shards over (pod, data) in
    training; a serving batch as the reference's ``_axes_for_batch``
    shards it (over (pod, data), else data, else replicated)."""
    pod, data = axes.get("pod", 1), axes.get("data", 1)
    if global_batch % (pod * data) == 0:
        return global_batch // (pod * data)
    if not serving:
        raise ValueError(f"global batch {global_batch} over {pod} x {data} data ranks")
    return global_batch // data if global_batch % data == 0 else global_batch


def _cuda_trace_refused(device: torch.device) -> None:
    if device.type == "cuda" and not torch.backends.cuda.is_built():
        raise RuntimeError(
            "--device cuda traces the card's path, which needs a CUDA build of torch: views "
            "and autograd of fake CUDA tensors ask for the CUDA device guard (no card is "
            "needed); --device cpu traces the plain path")


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, rt: Runtime, axes: dict[str, int], *,
               comm_mode: str = "fsdp", n_chunks: int = 4, compression: str | None = None,
               plan=None, packed: bool = True, device="cuda") -> dict:
    """Run one step of ``cfg`` at ``shape`` as rank 0 of the world ``rt``
    was cut from (``axes``: its (pod, data, model) sizes by the
    reference's axis names), shapes only, and price it.  Returns the
    cell's numbers: ``n_chips``, ``trace_s``, ``memory``, ``flops``,
    ``bytes``, ``roofline``, ``collectives`` (by kind), ``kernels`` (the
    shape-only calls by kernel, with their FLOPs and bytes) and the
    parameter counts.  ``device`` may be any device whose tensors the
    step takes (a meta device traces the kernels' branches as the card's
    does)."""
    device = torch.device(device)
    _cuda_trace_refused(device)
    n_chips = math.prod(axes.values())
    pod_size = n_chips // axes.get("pod", 1)
    is_train = shape.kind == "train"
    local = _local_batch(shape.global_batch, axes, not is_train)
    ids = dict(dtype=torch.long, device=device)
    rec = analysis.StepRecorder(pod_size)
    with FakeTensorMode():
        fsdp = axes.get("data", 1) if rt.fsdp_group is not None and is_train else 1
        model = _fake_model(cfg, rt, device, fsdp)
        enc = (torch.empty((local, cfg.enc_seq, cfg.d_model), dtype=torch.float32, device=device)
               if cfg.n_enc_layers else None)
        if is_train:
            tcfg = TrainConfig(comm_mode=comm_mode, n_chunks=n_chunks,
                               dcn_compression=compression, plan=plan, packed=packed,
                               # the fsdp sync reads the weights from the config
                               cluster_weights=(plan.cluster_weights
                                                if plan is not None else None))
            step_fn, _ = make_train_step(model, tcfg)
            if comm_mode == "hier_zero1" and rt.dp_group is not None:
                opt = _zero_state(model, tcfg, device)
            else:
                opt = opt_lib.adam_init(opt_lib.flat_params(model.train_leaves())[0])
            batch = {"tokens": torch.empty((local, shape.seq_len), **ids),
                     "labels": torch.empty((local, shape.seq_len), **ids)}
            if enc is not None:
                batch["enc"] = enc
            held = (model.train_leaves(), opt, batch)

            def run():
                step_fn(opt, batch)
                return ()
        else:
            prefill, decode = make_serve_steps(model)
            if shape.kind == "prefill":
                tokens = torch.empty((local, shape.seq_len), **ids)
                held = (model.train_leaves(), tokens, enc)

                def run():
                    return prefill(tokens, enc)
            else:
                caches = model.make_caches(local, shape.seq_len,
                                           cfg.enc_seq if cfg.n_enc_layers else 0)
                token = torch.empty((local, 1), **ids)
                held = (model.train_leaves(), caches, token)

                def run():
                    return decode(token, caches)[0]
        rec.hold(*held)
        t0 = time.perf_counter()
        with _build.shape_only_calls(rec.kernel_call), rec:
            out = run()
        trace_s = time.perf_counter() - t0
        out_bytes = sum(t.untyped_storage().nbytes() for t in
                        {id(t): t for t in tree_leaves(out)
                         if isinstance(t, torch.Tensor)}.values())
        del out, run, held, model
    costs = rec.costs()
    roof = analysis.roofline_terms(costs, n_chips, model_flops_for(cfg, shape))
    return {
        "n_chips": n_chips, "device": device.type, "trace_s": round(trace_s, 1),
        "memory": {"argument_bytes": costs.held_bytes, "output_bytes": out_bytes,
                   "temp_bytes": costs.peak_bytes - costs.held_bytes,
                   "peak_per_device_gib": analysis.gib(costs.peak_bytes),
                   "peak_bytes": costs.peak_bytes},
        "flops": costs.flops_per_chip, "bytes": costs.bytes_per_chip,
        "bytes_convention": BYTES_NOTE,
        "method": METHOD.format(n=n_chips),
        "roofline": roof.to_dict(),
        "collectives": analysis.summarize_ops(costs.collectives),
        "kernels": costs.kernels,
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
    }


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               comm_mode: str = "fsdp", sp: bool = False,
               device: str = "cuda", n_chunks: int = 4,
               compression: str | None = None,
               capacity_factor: float = 1.25,
               remat_policy: str = "none", plan=None,
               packed: bool = True, moe_a2a_mode: str = "flat"):
    """One cell on the production mesh (the reference's ``lower_cell``,
    with ``device`` in place of ``use_pallas``): the fake world of the
    mesh (started once per process), its Runtime with this cell's knobs,
    and ``trace_cell``; a cell ``cell_applicable`` refuses is
    ``skipped`` with its reason."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name,
                "mesh": "multi" if multi_pod else "single",
                "status": "skipped", "reason": why}
    is_train = shape.kind == "train"
    fsdp = is_train and comm_mode == "fsdp"
    rt = make_production_world(
        multi_pod=multi_pod, fsdp=fsdp, sp=sp, remat_policy=remat_policy,
        moe_capacity_factor=capacity_factor, moe_a2a_mode=moe_a2a_mode,
        # skew-aware per-cluster expert capacity rides the same weights as
        # the gradient sync
        moe_cluster_weights=plan.cluster_weights if plan is not None else None)
    cell = trace_cell(cfg, shape, rt, production_axes(multi_pod), comm_mode=comm_mode,
                      n_chunks=n_chunks, compression=compression, plan=plan, packed=packed,
                      device=device)
    result = {
        "arch": arch, "shape": shape_name,
        "mesh": "multi" if multi_pod else "single",
        "comm_mode": comm_mode, "sp": sp, "status": "ok",
        "remat_policy": remat_policy, "compression": compression,
        "capacity_factor": capacity_factor, "n_chunks": n_chunks, **cell}
    if cfg.n_experts:
        result["moe_a2a_mode"] = moe_a2a_mode
    if plan is not None:
        result["plan"] = plan.summary()
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--mode", default=None, choices=list(MODES))
    ap.add_argument("--plan", default="manual", choices=["manual", "auto"],
                    help="auto: core.planner picks mode/chunks/compression "
                         "from the cost model instead of the --mode flags")
    ap.add_argument("--skew", default="none", choices=["none", "auto"],
                    help="auto (requires --plan auto, train shapes): "
                         "core.skew jointly optimizes the uneven per-pod "
                         "batch split with the comm plan; the traced step "
                         "runs the weighted gradient sync")
    ap.add_argument("--sp", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the card's path, each kernel called shape-only "
                         "(needs a CUDA build of torch, not a card); cpu: the "
                         "plain path")
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--compression", default=None,
                    choices=[None, "bf16", "int8"])
    ap.add_argument("--capacity-factor", type=float, default=1.25)
    ap.add_argument("--remat-policy", default="none",
                    choices=["none", "save_collectives"])
    ap.add_argument("--no-packed", action="store_true",
                    help="disable the packed gradient data path (the "
                         "per-leaf path; A/B axis)")
    ap.add_argument("--border-scarce", action="store_true",
                    help="price --plan auto against the border-scarce "
                         "multipod topology (one scale-up domain per "
                         "pod, few DCN uplinks) instead of the "
                         "every-chip-a-border-rank default")
    ap.add_argument("--plan-cache", default=None, metavar="PATH",
                    help="disk-backed plan cache shared across dry-run "
                         "processes (hillclimb passes one file so "
                         "repeated --plan auto invocations hit instead "
                         "of re-searching); stats land in the result "
                         "JSON under 'plan_cache'")
    ap.add_argument("--elastic", action="store_true",
                    help="after the trace, simulate a topology loss "
                         "(multi-pod: drop the last pod; single: evict "
                         "half the hosts on a confirmed straggler) and "
                         "run the elastic re-plan; the transition's "
                         "ReplanReport lands in the result JSON under "
                         "'replan'")
    ap.add_argument("--guard", action="store_true",
                    help="emit the collective guard's pre-launch view "
                         "in the result JSON under 'guard': the "
                         "schedule digest every rank must agree on and "
                         "the comm deadline armed from the cost model's "
                         "prediction (runtime/guard.py)")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="emit the seeded fault plan and the degraded-"
                         "fabric pricing (nominal vs worst injected "
                         "link degradation, simulate_schedule "
                         "link_scale) in the result JSON under 'chaos'; "
                         "implies --guard")
    ap.add_argument("--watchdog-max-bad-steps", type=int, default=3,
                    help="NaN watchdog knob (train.py executes it; the "
                         "dry run records it in the run header)")
    ap.add_argument("--watchdog-spike-factor", type=float, default=10.0,
                    help="NaN watchdog spike ratio (run header)")
    ap.add_argument("--watchdog-window", type=int, default=64,
                    help="NaN watchdog median window (run header)")
    ap.add_argument("--straggler-factor", type=float, default=3.0,
                    help="straggler monitor factor (run header)")
    ap.add_argument("--straggler-window", type=int, default=32,
                    help="straggler monitor median window (run header)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.skew == "auto" and args.plan != "auto":
        ap.error("--skew auto requires --plan auto")
    use_guard = args.guard or args.chaos is not None
    print(f"[run] watchdog(max_bad_steps={args.watchdog_max_bad_steps}, "
          f"spike_factor={args.watchdog_spike_factor:g}, "
          f"window={args.watchdog_window}) "
          f"straggler(factor={args.straggler_factor:g}, "
          f"window={args.straggler_window}) "
          f"guard={'on' if use_guard else 'off'} "
          f"chaos={args.chaos if args.chaos is not None else 'off'}",
          flush=True)
    mode, chunks, comp, plan = (args.mode or "fsdp", args.chunks,
                                args.compression, None)
    moe_a2a_mode = "flat"
    cache_stats = None
    try:
        if args.plan == "auto":
            plan, chosen, a2a_plan, cache_stats = auto_plan(
                args.arch, multi_pod=args.mesh == "multi",
                comm_mode=args.mode or "hier",
                allow_int8=args.compression == "int8",
                shape_name=args.shape, skew=args.skew,
                packed=not args.no_packed,
                border_scarce=args.border_scarce,
                plan_cache_path=args.plan_cache)
            print(f"[plan] cache: {cache_stats['hits']} hit(s), "
                  f"{cache_stats['misses']} miss(es)", flush=True)
            if a2a_plan is not None:
                moe_a2a_mode = a2a_plan.recommended_mode()
                print(f"[plan] MoE dispatch/combine All2All -> "
                      f"{moe_a2a_mode}", flush=True)
                print(a2a_plan.describe(), flush=True)
            # explicitly-flagged structural modes (fsdp / hier_zero1) keep
            # their optimizer wiring; the schedule comes from the plan,
            # resolved per bucket inside the collectives.  For the rest,
            # the plan may recommend the chained overlap executor when
            # exposed comm beats the sequential sync.
            if args.mode in ("fsdp", "hier_zero1"):
                mode = args.mode
            else:
                rec = plan.recommended_mode()
                if rec == "hier_overlap":
                    mode = "hier_overlap"
                else:
                    # per-bucket schedules resolve from the plan inside
                    # the collectives; "hier" is the generic wiring and
                    # "flat" the no-plan degenerate case
                    mode = chosen.mode if chosen.mode == "flat" else "hier"
            chunks, comp = chosen.n_chunks, chosen.compression
            # the human-readable table replaces reading the raw summary
            # dict out of the result JSON
            print(plan.describe(), flush=True)
        use_packed = not args.no_packed
        if plan is not None and plan.data_path == "per_leaf":
            # the planner's per-leaf fallback: the modeled pack overhead
            # loses to syncing the leaves individually, so trace the
            # unpacked executor
            print("[plan] per-leaf data path (pack overhead loses; "
                  "tracing without Pack/Unpack)", flush=True)
            use_packed = False
        res = lower_cell(args.arch, args.shape, multi_pod=args.mesh == "multi",
                         comm_mode=mode, sp=args.sp,
                         device=args.device, n_chunks=chunks,
                         compression=comp,
                         capacity_factor=args.capacity_factor,
                         remat_policy=args.remat_policy, plan=plan,
                         packed=use_packed,
                         moe_a2a_mode=moe_a2a_mode)
        if args.elastic:
            rep = elastic_replan_report(
                args.arch, multi_pod=args.mesh == "multi", comm_mode=mode,
                border_scarce=args.border_scarce,
                plan_cache_path=args.plan_cache)
            res["replan"] = rep.summary()
            print(rep.describe(), flush=True)
        if use_guard:
            res["guard"] = guard_section(
                plan, mode=mode, chunks=chunks, compression=comp,
                n_chips=res.get("n_chips", 1))
            print(f"[guard] schedule digest "
                  f"{res['guard']['schedule_digest']} "
                  f"({res['guard']['ranks']} rank(s) agree)", flush=True)
        if args.chaos is not None:
            res["chaos"] = chaos_section(
                args.chaos, args.arch, multi_pod=args.mesh == "multi",
                border_scarce=args.border_scarce, plan=plan, mode=mode,
                chunks=chunks, compression=comp)
            ch = res["chaos"]
            print(f"[chaos] seed {args.chaos}: "
                  f"{len(ch['events'])} fault(s); sync "
                  f"{ch['nominal_sync_s'] * 1e3:.2f} ms nominal -> "
                  f"{ch['degraded_sync_s'] * 1e3:.2f} ms degraded "
                  f"(x{ch['slowdown']:.2f})", flush=True)
        if cache_stats is not None:
            res["plan_cache"] = cache_stats
    except Exception as e:  # noqa: BLE001
        res = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
               "comm_mode": mode, "status": "error",
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-3000:]}
    js = json.dumps(res, indent=1)
    print(js)
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(js)
    if res["status"] == "error":
        raise SystemExit(1)


if __name__ == "__main__":
    main()
