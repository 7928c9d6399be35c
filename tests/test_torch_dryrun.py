"""The port's dry run, its analysis and its remat policy against the JAX
package's.

* Host arithmetic (``launch/dryrun.py``): ``input_specs`` for every arch
  and shape, ``model_flops_for`` and ``moe_a2a_bytes`` for every arch,
  shape and mesh, ``auto_plan``'s plans (qwen2.5-3b multi-pod, with
  ``--skew auto``, ZeRO-1 single-pod; the MoE oracle of
  ``tests/test_a2a_schedule.py``: ``hier_a2a`` border-scarce, ``flat``
  otherwise, no a2a plan for a dense model), ``guard_section``,
  ``chaos_section`` (seed 0, multi-pod) and ``elastic_replan_report``
  (multi and single) equal the reference's, key for key (wall times
  aside).  Importing the reference's dry run sets 512 host devices, so
  its side runs in a subprocess.
* Launches counted shape-only, beside the reference's side: qwen2.5-3b
  at full width in a fake world of one, traced on the meta device, whose
  tensors have no data as the card's fake ones do, so every kernel
  wrapper takes its shape-only branch (this torch cannot trace fake CUDA
  tensors: ``tests/test_torch_sweep.py``).  The counts equal what
  ``chip_smoke.py`` asserts on the card: 36 flash calls in a 4 x 1024
  prefill, none in decode or training; one ``pack_slots`` and one of
  each codec kernel a ``hier`` + int8 step, 38 of each under
  ``hier_overlap``.  The kernel library is never loaded.
* The collective recorder (``launch/analysis.py``) against
  ``tests/mdscripts/check_hlo_analysis.py``'s program on the (2, 2, 2)
  mesh: 5 trips of a psum over data and one over pod, one all-gather
  over (pod, data), and a ppermute over pod, issued on rank 0 of a fake
  world of 8.  ``summarize_ops`` equals the reference's
  ``analyze_module`` by kind: wire, ICI and DCN bytes, and counts, the
  reference's ops weighted by their loop trips (it counts an op in a
  loop body once and multiplies its bytes; the port records every
  execution).
* The smoke qwen2.5-3b train step traced on a fake (2, 2, 2) world
  against ``analyze_module`` of the reference's step lowered on 8 host
  devices, at ``hier`` + int8 and at ``fsdp`` (d_ff 1024, so that the
  MLP leaves are sharded, and in f32: XLA's CPU backend widens a bf16
  collective to f32, so a bf16 gradient would cross pods at twice the
  bytes there, ROADMAP R25): the bytes across pods within 1%, the FLOPs
  a rank within 5% (both plain).  The other kinds are printed side by
  side; XLA combines and fuses collectives (its all-reduce combiner
  packs the small ones into tuples), so their counts differ, and the
  port's counts are held to the closed forms of its own structure.
* ``Runtime.remat_policy`` on 4 gloo ranks as (pod 2, data 1, model 2):
  losses, grad norms and gradients under ``save_collectives`` bit-equal
  to those under ``none``; both within 1e-3 of the reference's run with
  the same policy (``donate=False``, R12); and the backward issues one
  TP all-reduce fewer per dense layer, the recompute's of the
  attention's ``reduce_from_tp``.  The MLP's is not recomputed by either
  package (the backward needs nothing past its input), so one a layer
  is what the policy saves: the reference's lowered steps show the same
  difference, counted here from its HLO (ROADMAP R26).  The policy keeps
  the output of one TP all-reduce a dense layer, the attention's, and
  none of an SSM layer (the mamba2 smoke model at TP 2 in the same
  world): the last sublayer's output feeds only the residual add, which
  no backward reads (ROADMAP C2).  Its ``MUST_SAVE`` decisions on the
  all-reduce op are counted in the forward, not in the recompute.
"""

import dataclasses
import datetime
import json
import os
import sys
import threading

import numpy as np

GB, S, N_STEPS = 4, 32, 3
LR, WARMUP = 1e-2, 1
FSDP_D_FF = 1024
N_CHECK, TRIPS = 1024, 5          # check_hlo_analysis.py's program
REMAT_WORLD = 4                   # (pod 2, data 1, model 2)
POLICIES = ("none", "save_collectives")
STEP_CASES = (("hier", "int8"), ("fsdp", None))
PLAN_CASES = {   # name: auto_plan arguments
    "qwen_multi": dict(arch="qwen2.5-3b", multi_pod=True, shape_name="train_4k"),
    "qwen_multi_skew": dict(arch="qwen2.5-3b", multi_pod=True, shape_name="train_4k",
                            skew="auto"),
    "qwen_single_zero1": dict(arch="qwen2.5-3b", multi_pod=False, comm_mode="hier_zero1",
                              shape_name="train_4k", allow_int8=True),
    "moe_scarce": dict(arch="qwen3-moe-30b-a3b", multi_pod=True, border_scarce=True),
    "moe_rich": dict(arch="qwen3-moe-30b-a3b", multi_pod=True),
    "dense_no_shape": dict(arch="qwen2.5-3b", multi_pod=True),
}


def batch(step: int, vocab: int) -> dict:
    rng = np.random.default_rng(100 + step)
    return {"tokens": rng.integers(0, vocab, (GB, S), dtype=np.int32),
            "labels": rng.integers(0, vocab, (GB, S), dtype=np.int32)}


def host_arithmetic(dr, archs, shapes, get_config, get_shape, cache_dir) -> dict:
    """Every host number this file compares, from either package's dry-run
    module ``dr``; JSON-able."""
    out = {"specs": {}, "model_flops": {}, "a2a": {}, "plans": {}}
    for a in archs:
        cfg = get_config(a)
        for s in shapes:
            shape = get_shape(s)
            specs = dr.input_specs(cfg, shape)
            out["specs"][f"{a}/{s}"] = {
                k: [list(v[0] if isinstance(v, tuple) else v.shape),
                    str(v[1] if isinstance(v, tuple) else v.dtype).replace("torch.", "")]
                for k, v in specs.items()}
            out["model_flops"][f"{a}/{s}"] = dr.model_flops_for(cfg, shape)
            if cfg.n_experts:
                for n in (512, 256):
                    out["a2a"][f"{a}/{s}/{n}"] = dr.moe_a2a_bytes(cfg, shape, n)
        if cfg.n_experts:
            out["a2a"][f"{a}/none/512"] = dr.moe_a2a_bytes(cfg, None, 512)
    plans = {}
    for name, kw in PLAN_CASES.items():
        kw = dict(kw)
        plan, chosen, a2a, stats = dr.auto_plan(
            kw.pop("arch"), plan_cache_path=os.path.join(cache_dir, f"{name}.pkl"), **kw)
        plans[name] = plan
        out["plans"][name] = {
            "summary": plan.summary(), "describe": plan.describe(),
            "chosen": [chosen.mode, chosen.n_chunks, chosen.compression],
            "a2a": None if a2a is None else [a2a.recommended_mode(), a2a.summary()],
            "stats": {k: v for k, v in stats.items() if k != "path"}}
    out["guard"] = {
        "plan": dr.guard_section(plans["qwen_multi"], mode="hier", chunks=4, compression=None,
                                 n_chips=512),
        "manual": dr.guard_section(None, mode="hier_pipelined", chunks=4, compression="int8",
                                   n_chips=512)}
    out["chaos"] = {
        "manual": dr.chaos_section(0, "qwen2.5-3b", multi_pod=True, border_scarce=False,
                                   plan=None, mode="hier", chunks=4, compression=None),
        "plan": dr.chaos_section(0, "qwen2.5-3b", multi_pod=True, border_scarce=False,
                                 plan=plans["qwen_multi"], mode="hier", chunks=4,
                                 compression=None)}
    out["elastic"] = {}
    for multi in (True, False):
        rep = dr.elastic_replan_report(
            "qwen2.5-3b", multi_pod=multi, comm_mode="hier",
            plan_cache_path=os.path.join(cache_dir, f"elastic_{multi}.pkl")).summary()
        rep.pop("replan_latency_s")
        out["elastic"]["multi" if multi else "single"] = rep
    return json.loads(json.dumps(out, default=str))


def _jax_main(out_dir: str, part: str) -> None:
    """The reference's side: ``host`` (its dry run's host arithmetic) or
    ``lower`` (8 host devices: the check program, the smoke step and the
    remat runs)."""
    import jax
    import jax.numpy as jnp

    from _torch_world import nest as _nest
    from repro.configs import get_config, get_shape
    from repro.launch import hlo_analysis as ha

    if part == "host":
        from repro.launch import dryrun as rd
        from repro.launch import sweep as rsweep
        cache = os.path.join(out_dir, "jax_plans")
        os.makedirs(cache, exist_ok=True)
        out = host_arithmetic(rd, rsweep.ARCHS, rsweep.SHAPES, get_config, get_shape, cache)
        with open(os.path.join(out_dir, "jax_host.json"), "w") as f:
            json.dump(out, f)
        np.savez(os.path.join(out_dir, f"jax_{part}.npz"))
        return

    from jax import lax
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from repro.launch.mesh import runtime_for_mesh
    from repro.models import Model as JaxModel
    from repro.parallel.sharding import shard_map
    from repro.train import TrainConfig as JaxTrainConfig
    from repro.train import make_train_step as jax_train_step
    from repro.train import optimizer as jopt
    from repro.train.optimizer import OptConfig as JaxOpt

    def by_kind(costs) -> dict:
        out = ha.summarize_ops(costs.collectives)
        for kind, d in out.items():
            d["executed"] = sum(o.trip_mult for o in costs.collectives if o.kind == kind)
        return out

    res: dict = {}
    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))

    # check_hlo_analysis.py's program, and its ppermute
    def body(x):
        def step(c, _):
            c = lax.psum(c, "data")
            c = lax.psum(c, "pod") * 0.5
            return c, None
        out, _ = lax.scan(step, x, None, length=TRIPS)
        g = lax.all_gather(x, ("pod", "data"), axis=0, tiled=True)
        return out + g[:N_CHECK]

    def body2(x):
        return lax.ppermute(x, "pod", [(0, 1), (1, 0)])

    arg = jax.ShapeDtypeStruct((N_CHECK,), jnp.float32)
    for name, fn in (("check", body), ("permute", body2)):
        txt = jax.jit(shard_map(fn, mesh=mesh, in_specs=P(None), out_specs=P(None),
                                check_vma=False)).lower(arg).compile().as_text()
        res[name] = by_kind(ha.analyze_module(txt, 8, pod_size=4))

    # the smoke train step, lowered on the 8 devices
    for mode, codec in STEP_CASES:
        fsdp = mode == "fsdp"
        cfg = get_config("qwen2.5-3b", smoke=True)
        if fsdp:
            cfg = dataclasses.replace(cfg, d_ff=FSDP_D_FF, dtype=jnp.float32)
        model = JaxModel(cfg, runtime_for_mesh(mesh, fsdp=fsdp))
        if fsdp:
            model = model.with_fsdp(2)
        pshape = jax.eval_shape(model.init, jax.random.key(0))
        model.prepare(pshape)
        build, _ = jax_train_step(model, JaxTrainConfig(comm_mode=mode, dcn_compression=codec),
                                  mesh=mesh, donate=False)
        step, _ = build(pshape)
        ins = {k: jax.ShapeDtypeStruct((GB, S), jnp.int32) for k in ("tokens", "labels")}
        txt = step.lower(pshape, jax.eval_shape(jopt.adam_init, pshape), ins).compile().as_text()
        costs = ha.analyze_module(txt, 8, pod_size=4)
        res[f"step/{mode}"] = {"kinds": by_kind(costs), "flops": costs.flops_per_chip}

    # the remat policies on (pod 2, data 1, model 2), f32, from the
    # parameters the ranks load
    rmesh = Mesh(np.array(jax.devices()[:REMAT_WORLD]).reshape(2, 1, 2),
                 ("pod", "data", "model"))
    cfg = dataclasses.replace(get_config("qwen2.5-3b", smoke=True), dtype=jnp.float32)
    params0 = jax.tree.map(jnp.asarray, _nest(np.load(os.path.join(out_dir, "params.npz"))))
    arrays = {}
    for pol in POLICIES:
        model = JaxModel(cfg, runtime_for_mesh(rmesh, remat_policy=pol))
        build, _ = jax_train_step(model, JaxTrainConfig(
            comm_mode="hier", opt=JaxOpt(lr=LR, warmup_steps=WARMUP)), mesh=rmesh, donate=False)
        shapes = jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape, p.dtype), params0)
        step, _ = build(shapes)
        params, opt = params0, jopt.adam_init(params0)
        metrics = []
        for i in range(N_STEPS):
            b = {k: jnp.asarray(v) for k, v in batch(i, cfg.vocab_size).items()}
            params, opt, m = step(params, opt, b)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        arrays[f"remat/{pol}"] = np.asarray(metrics)
        txt = step.lower(shapes, jax.eval_shape(jopt.adam_init, shapes),
                         {k: jax.ShapeDtypeStruct((GB, S), jnp.int32)
                          for k in ("tokens", "labels")}).compile().as_text()
        tp_ars = [o for o in ha.analyze_module(txt, REMAT_WORLD, pod_size=2).collectives
                  if o.kind == "all-reduce" and not o.crosses_pods and o.group_size == 2]
        res[f"remat_tp_all_reduces/{pol}"] = sum(o.trip_mult for o in tp_ars)
    res["n_layers"] = cfg.n_layers
    with open(os.path.join(out_dir, "jax_lower.json"), "w") as f:
        json.dump(res, f)
    np.savez(os.path.join(out_dir, f"jax_{part}.npz"), **arrays)


def _gloo_rank(rank: int, store_path: str, out_dir: str) -> None:
    """One rank of the (2, 1, 2) world: both policies' three steps, and
    one backward of each with its TP all-reduces counted."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    from torch.utils._python_dispatch import TorchDispatchMode

    from _torch_world import nest as _nest
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.mesh import runtime_for_groups
    from repro_torch.launch.train import dp_rows
    from repro_torch.models import Model
    from repro_torch.parallel import sharding
    from repro_torch.train import loss as tloss
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import TrainConfig, make_train_step

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, REMAT_WORLD), rank=rank,
                            world_size=REMAT_WORLD, timeout=datetime.timedelta(seconds=120))

    def _tp_all_reduces(rt):
        """A dispatch mode counting the all-reduces over ``rt``'s TP group:
        the functional one and the in-place one of a layer's last sum."""
        tp_ranks = dist.get_process_group_ranks(rt.tp_group)

        class TpAllReduces(TorchDispatchMode):
            n = 0

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func is torch.ops._c10d_functional.all_reduce.default:
                    group = _resolve_process_group(args[2])
                elif func is torch.ops.c10d.allreduce_.default:
                    group = dist.ProcessGroup.unbox(args[1])
                else:
                    group = None
                if group is not None and dist.get_process_group_ranks(group) == tp_ranks:
                    TpAllReduces.n += 1
                return func(*args, **(kwargs or {}))

        return TpAllReduces

    saved = {"n": 0}
    policy = sharding._save_tp_collective

    def counted(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if (not ctx.is_recompute and op is torch.ops._c10d_functional.all_reduce.default
                and decision == sharding.CheckpointPolicy.MUST_SAVE):
            saved["n"] += 1
        return decision

    sharding._save_tp_collective = counted
    out = {}
    try:
        cfg = dataclasses.replace(get_config("qwen2.5-3b", smoke=True), dtype=torch.float32)
        tree = _nest(np.load(os.path.join(out_dir, "params.npz")))
        rows = dp_rows(rank, GB, 2, 1, 2)
        grads = {}
        for pol in POLICIES:
            rt = runtime_for_groups(pods=2, data_per_pod=1, tp=2, remat_policy=pol)

            TpAllReduces = _tp_all_reduces(rt)

            model = params_from_jax(tree, cfg, rt, device="cpu")
            params = [p.requires_grad_(True) for p in
                      opt_lib.flat_params(model.train_leaves())[0]]
            b = {k: torch.from_numpy(v[rows]).long() for k, v in batch(0, cfg.vocab_size).items()}
            logits, _ = model.apply_train(b["tokens"])
            loss, _ = tloss.sharded_xent(logits, b["labels"], rt, cfg.vocab_size)
            out[f"fwd_saved_all_reduces/{pol}"] = np.asarray(saved.pop("n"))
            saved["n"] = 0
            with TpAllReduces():
                grads[pol] = torch.autograd.grad(loss, params)
            out[f"bwd_tp_all_reduces/{pol}"] = np.asarray(TpAllReduces.n)
            for p in params:
                p.requires_grad_(False)

            step_fn, _ = make_train_step(model, TrainConfig(
                comm_mode="hier", opt=opt_lib.OptConfig(lr=LR, warmup_steps=WARMUP)))
            opt = opt_lib.adam_init(params)
            metrics = []
            for i in range(N_STEPS):
                b = {k: torch.from_numpy(v[rows]).long()
                     for k, v in batch(i, cfg.vocab_size).items()}
                m = step_fn(opt, b)
                metrics.append((m["loss"], m["grad_norm"]))
            out[f"remat/{pol}"] = np.asarray(metrics)
        out["grads_equal"] = np.asarray(all(torch.equal(a, b) for a, b in
                                            zip(grads["none"], grads["save_collectives"])))
        # the SSM family: one sublayer a layer, its TP sum the last
        ssm_cfg = dataclasses.replace(get_config("mamba2-2.7b", smoke=True), dtype=torch.float32)
        ssm_grads, ssm_losses = {}, {}
        for pol in POLICIES:
            rt = runtime_for_groups(pods=2, data_per_pod=1, tp=2, remat_policy=pol)
            model = Model(ssm_cfg, rt, device="cpu").init(0)
            params = [p.requires_grad_(True) for p in
                      opt_lib.flat_params(model.train_leaves())[0]]
            b = {k: torch.from_numpy(v[rows]).long()
                 for k, v in batch(0, ssm_cfg.vocab_size).items()}
            saved["n"] = 0
            logits, _ = model.apply_train(b["tokens"])
            ssm_losses[pol], _ = tloss.sharded_xent(logits, b["labels"], rt,
                                                    ssm_cfg.vocab_size)
            out[f"ssm_fwd_saved_all_reduces/{pol}"] = np.asarray(saved["n"])
            TpAllReduces = _tp_all_reduces(rt)
            with TpAllReduces():
                ssm_grads[pol] = torch.autograd.grad(ssm_losses[pol], params)
            out[f"ssm_bwd_tp_all_reduces/{pol}"] = np.asarray(TpAllReduces.n)
        out["ssm_n_layers"] = np.asarray(ssm_cfg.n_layers)
        out["ssm_equal"] = np.asarray(
            torch.equal(ssm_losses["none"], ssm_losses["save_collectives"])
            and all(torch.equal(a, b) for a, b in zip(ssm_grads["none"],
                                                      ssm_grads["save_collectives"])))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    _jax_main(sys.argv[1], sys.argv[2])
    sys.exit(0)


import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from _torch_world import flat_tree, run_world  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.parallel.sharding import Runtime as JaxRuntime  # noqa: E402
from repro_torch.configs import get_config, get_shape  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import primitives  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.launch import analysis, dryrun, sweep  # noqa: E402
from repro_torch.launch.mesh import make_fake_world  # noqa: E402

AXES_8 = {"pod": 2, "data": 2, "model": 2}


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    """The reference's host arithmetic and lowerings, and the four gloo
    ranks, started before the first test in a thread of their own (the
    in-process traces run beside them): the thread and its result."""
    tmp = tmp_path_factory.mktemp("dryrun_world")
    cfg = dataclasses.replace(jax_config("qwen2.5-3b", smoke=True), dtype=jnp.float32)
    params = JaxModel(cfg, JaxRuntime(tp_axis="model", tp_size=2)).init(jax.random.key(0))
    np.savez(tmp / "params.npz", **flat_tree(jax.tree.map(np.asarray, params)))
    out: dict = {}

    def world():
        try:
            out["world"] = run_world(__file__, tmp, ("host", "lower"), 8, _gloo_rank,
                                     REMAT_WORLD)
        except BaseException as e:  # noqa: BLE001 - re-raised in the test thread
            out["error"] = e

    thread = threading.Thread(target=world)
    thread.start()
    yield thread, out, tmp
    thread.join(timeout=600)


@pytest.fixture(scope="module")
def results(started):
    """(the reference's JSON and arrays, each rank's) once the world ended."""
    thread, out, tmp = started
    thread.join(timeout=600)
    assert not thread.is_alive(), "the reference's side and the gloo ranks did not end"
    if "error" in out:
        raise out["error"]
    want, ranks = out["world"]
    ref = {}
    for part in ("host", "lower"):
        ref.update(json.loads((tmp / f"jax_{part}.json").read_text()))
    return ref, want, ranks, tmp


# ---------------------------------------------------------------------------
# Launches counted shape-only (beside the reference's side, in this thread)
# ---------------------------------------------------------------------------

WORLD_OF_ONE = {"pod": 1, "data": 1, "model": 1}
CARD_COUNTS = {   # chip_smoke.py's asserted launches (PERF.md section 2)
    ("prefill", None, None): {"flash_attention_bhsd": 36},
    ("decode", None, None): {},
    ("train", "hier", "int8"): {"pack_slots": 1, "amax_block": 1, "quant_scaled": 1,
                                "dequant_int8": 1},
    ("train", "hier_overlap", "int8"): {"pack_slots": 38, "amax_block": 38,
                                        "quant_scaled": 38, "dequant_int8": 38},
}


@pytest.mark.parametrize("kind, mode, codec", list(CARD_COUNTS))
def test_shape_only_launches_equal_the_cards(monkeypatch, kind, mode, codec):
    def no_library():
        raise AssertionError("a shape-only trace loaded the kernel library")

    monkeypatch.setattr(_build, "library", no_library)
    rt = make_fake_world(WORLD_OF_ONE)
    try:
        ops.reset_launch_counts()
        cell = dryrun.trace_cell(get_config("qwen2.5-3b"), ShapeConfig("card", kind, 1024, 4),
                                 rt, WORLD_OF_ONE, comm_mode=mode or "hier",
                                 compression=codec, device="meta")
    finally:
        dist.destroy_process_group()
    want = {name: CARD_COUNTS[kind, mode, codec].get(name, 0) for name in ops.KERNELS}
    assert ops.fake_launch_counts() == want
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    assert {k: v["calls"] for k, v in cell["kernels"].items()} == {
        {"flash_attention_bhsd": "flash_attention"}.get(k, k): v for k, v in want.items() if v}


class fake_world:
    """A fake world of ``axes`` for one test, its process group destroyed
    after (the next test file in this process may start its own)."""

    def __init__(self, axes, **kw):
        self.axes, self.kw = axes, kw

    def __enter__(self):
        return make_fake_world(self.axes, **self.kw)

    def __exit__(self, *exc):
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The port's host arithmetic, on plan caches of its own."""
    return host_arithmetic(dryrun, sweep.ARCHS, sweep.SHAPES, get_config, get_shape,
                           str(tmp_path_factory.mktemp("port_plans")))


@pytest.mark.parametrize("section", ["specs", "model_flops", "a2a", "guard", "chaos",
                                     "elastic"])
def test_host_arithmetic_equals_the_reference(host, results, section):
    assert host[section] == results[0][section]


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_auto_plan_equals_the_reference(host, results, case):
    assert host["plans"][case] == results[0]["plans"][case]


def test_auto_plan_oracle(results):
    """tests/test_a2a_schedule.py's oracle, through the port's auto_plan."""
    plans = results[0]["plans"]
    assert plans["moe_scarce"]["a2a"][0] == "hier_a2a"
    assert plans["moe_rich"]["a2a"][0] == "flat"
    assert plans["dense_no_shape"]["a2a"] is None


def _executed(by_kind: dict) -> dict:
    return {k: (v["executed"], v["wire_bytes"], v["ici_bytes"], v["dcn_bytes"])
            for k, v in by_kind.items()}


def test_recorder_prices_check_hlo_analysis_program(results):
    """Rank 0 of (2, 2, 2): its data group [0, 2], pod group [0, 4] and
    (pod, data) group [0, 2, 4, 6] carry the reference program's
    collectives; the recorder prices them as analyze_module does."""
    ref = results[0]
    with fake_world(AXES_8) as rt, FakeTensorMode():
        podxdata = dist.new_group([0, 2, 4, 6])
        got = {}
        for name in ("check", "permute"):
            rec = analysis.StepRecorder(pod_size=4)
            x = torch.empty((N_CHECK,), dtype=torch.float32)
            with rec:
                if name == "check":
                    for _ in range(TRIPS):
                        x = primitives.hom_psum(primitives.hom_psum(x, rt.data_group),
                                                rt.pod_group) * 0.5
                    primitives.hom_all_gather(x, podxdata)
                else:
                    primitives.shift([x], rt.pod_group)
            ops = analysis.summarize_ops(rec.collectives)
            got[name] = {k: (v["count"], v["wire_bytes"], v["ici_bytes"], v["dcn_bytes"])
                         for k, v in ops.items()}
    for name in ("check", "permute"):
        want = _executed(ref[name])
        assert set(got[name]) == set(want), (got[name], want)
        for kind in want:
            assert got[name][kind] == pytest.approx(want[kind], rel=1e-12), (kind, got, want)


def _trace_smoke_step(mode, codec) -> dict:
    cfg = get_config("qwen2.5-3b", smoke=True)
    if mode == "fsdp":
        cfg = dataclasses.replace(cfg, d_ff=FSDP_D_FF, dtype=torch.float32)
    with fake_world(AXES_8, fsdp=mode == "fsdp") as rt:
        return dryrun.trace_cell(cfg, ShapeConfig("smoke", "train", S, GB), rt, AXES_8,
                                 comm_mode=mode, compression=codec, device="cpu")


@pytest.fixture(scope="module")
def smoke_steps():
    return {mode: _trace_smoke_step(mode, codec) for mode, codec in STEP_CASES}


@pytest.mark.parametrize("mode, codec", STEP_CASES)
def test_step_prices_like_the_reference(smoke_steps, results, mode, codec):
    ref = results[0][f"step/{mode}"]
    cell = smoke_steps[mode]
    got, want = cell["collectives"], ref["kinds"]
    table = "\n".join(f"{k:20s} port {got.get(k, {}).get('count', 0):4d} "
                      f"{got.get(k, {}).get('wire_bytes', 0):12.0f} | reference "
                      f"{want.get(k, {}).get('executed', 0):4d} "
                      f"{want.get(k, {}).get('wire_bytes', 0):12.0f}"
                      for k in sorted(set(got) | set(want)))
    print(f"\n{mode} {codec}:\n{table}")
    dcn = sum(v["dcn_bytes"] for v in got.values())
    want_dcn = sum(v["dcn_bytes"] for v in want.values())
    assert dcn == pytest.approx(want_dcn, rel=0.01), table
    assert cell["flops"] == pytest.approx(ref["flops"], rel=0.05)
    # the port's own structure, per step (L layers): each layer's TP
    # all-reduce after attention and after the MLP in the forward, the
    # attention's again in the recompute (the MLP's output is no input of
    # the backward, so the recompute stops before it), and the backward's
    # two copy_to_tp sums; the embedding's vocab-parallel sum and the LM
    # head's copy_to_tp; the vocab-sharded loss's three raw psums and the
    # backward sums of two of them; the metrics over the data-parallel
    # group
    L = get_config("qwen2.5-3b", smoke=True).n_layers
    model_side = 5 * L + 2 + 3 + 2 + 1
    if mode == "hier":
        # the packed segment: reduce-scatter and all-gather over data; the
        # pod hop's shared scale (a max) and its int8 ring (one shift over
        # two pods); the grad norm's sum over TP
        assert {k: v["count"] for k, v in got.items()} == {
            "all-reduce": model_side + 1 + 1, "reduce-scatter": 1, "all-gather": 1,
            "collective-permute": 1}
    else:
        # fsdp: each sharded leaf gathered per layer in the forward and the
        # recompute and reduce-scattered in the backward; each replicated
        # leaf through AllReduceH (reduce-scatter, pod sum, all-gather);
        # every leaf's pod sum; the grad norm's sums over TP, over FSDP
        # and over both
        with fake_world(AXES_8, fsdp=True) as rt, FakeTensorMode():
            cfg = dataclasses.replace(get_config("qwen2.5-3b", smoke=True), d_ff=FSDP_D_FF)
            specs = list(dryrun._fake_model(cfg, rt, torch.device("cpu"), 2)
                         .param_specs().values())
        sharded = sum("data" in spec for spec in specs)
        replicated = len(specs) - sharded
        assert {k: v["count"] for k, v in got.items()} == {
            "all-reduce": model_side + 3 + len(specs),
            "all-gather": 2 * L * sharded + replicated,
            "reduce-scatter": L * sharded + replicated}


def test_r25_reference_counts_bf16_collectives_at_f32_bytes(smoke_steps, results):
    """ROADMAP R25: the reference prices the HLO that XLA's CPU backend
    compiled, which widens a bf16 collective to f32: its packed bf16
    gradient segment crosses the intra reduce-scatter and all-gather at
    twice the bytes a bf16 wire moves (the int8 pod hop is unchanged)."""
    got, want = smoke_steps["hier"]["collectives"], results[0]["step/hier"]["kinds"]
    for kind in ("reduce-scatter", "all-gather"):
        assert want[kind]["wire_bytes"] == 2 * got[kind]["wire_bytes"]
    assert want["collective-permute"]["wire_bytes"] == got["collective-permute"]["wire_bytes"]


def test_remat_policy_saves_the_tp_collective(results):
    ref, want, ranks, _ = results
    L = ref["n_layers"]
    for got in ranks:
        assert bool(got["grads_equal"])
        np.testing.assert_array_equal(got["remat/none"], got["remat/save_collectives"])
        for pol in POLICIES:
            np.testing.assert_allclose(got[f"remat/{pol}"], want[f"remat/{pol}"],
                                       rtol=0, atol=1e-3)
        # the loss's two backward sums and the LM head's copy_to_tp, then
        # per layer two copy_to_tp sums and (none) the recompute of the
        # attention's reduce_from_tp
        assert int(got["bwd_tp_all_reduces/none"]) == 3 + 3 * L
        assert int(got["bwd_tp_all_reduces/save_collectives"]) == 3 + 2 * L
        # ROADMAP C2: the attention's output kept, the MLP's not; none of
        # an SSM layer, whose values and gradients stay bit-equal too
        assert int(got["fwd_saved_all_reduces/none"]) == 0
        assert int(got["fwd_saved_all_reduces/save_collectives"]) == L
        assert int(got["ssm_fwd_saved_all_reduces/none"]) == 0
        assert int(got["ssm_fwd_saved_all_reduces/save_collectives"]) == 0
        assert int(got["ssm_n_layers"]) > 0 and bool(got["ssm_equal"])
        # an SSM layer's recompute stops before its one TP sum under both
        assert (int(got["ssm_bwd_tp_all_reduces/none"])
                == int(got["ssm_bwd_tp_all_reduces/save_collectives"]))
    # the reference's whole step saves as many TP all-reduces
    assert (ref["remat_tp_all_reduces/none"] - ref["remat_tp_all_reduces/save_collectives"]
            == L)


def test_remat_policy_is_checked():
    from repro_torch.parallel.sharding import Runtime, remat_policy_for
    assert remat_policy_for(Runtime()) is None
    assert remat_policy_for(Runtime(remat_policy="save_collectives")) is not None
    with pytest.raises(ValueError):
        remat_policy_for(Runtime(remat_policy="save_everything"))
