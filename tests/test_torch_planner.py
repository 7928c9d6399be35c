"""The port's planner layer against the JAX package's.

* ``topology``, ``cost_model``, ``transport_sim`` and ``skew`` are
  verbatim copies (the file text equal), and ``planner`` and
  ``plan_cache`` differ only by their seams.
* ``planner.plan`` gives the reference's plan, ``summary()``,
  ``describe()`` and ``_plan_key`` equal, over topologies (the paper
  testbed, the three-vendor testbed, two TPU multipods, the border-scarce
  multipod, and the paper testbed with a cluster dropped, shrunk and
  derated), collectives (all_reduce, reduce_scatter, all_gather) and
  knobs (the backward window, the packed pricing with a leaf count, the
  balanced subgroups).
* The cost model, the event simulator, ``skew.optimize``,
  ``integer_split`` / ``proportional_split`` (R1's tie-break inherited as
  it is) and the data pipeline's ``shares_for_hosts`` agree exactly:
  ``==`` on floats, since the code is the same numpy.
* ``BoundPlan`` resolves a bucket to the port's ``CommConfig`` on the
  runtime's groups; a bare ``CommPlan`` refuses to.
* The plan cache: a disk round trip gives a hit on the second ``plan``; a
  file written by the reference's ``PlanCache`` is a cold cache, and a
  process that imports only the port has neither ``repro`` nor ``jax``
  in ``sys.modules`` after reading it.
* The launcher's ``make_plan`` equals the reference's planner called
  with the arguments the reference's launcher computes, for 1 and 2 pods
  on worlds of 1, 4 and 8 ranks, and with a model axis of 2; the CPU
  entry point prints its ``[plan]`` lines and the plan's summary, and a
  second launch on the same cache file reports a hit.
"""

import dataclasses
import json
import os
import pathlib
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.core import cost_model as jcost
from repro.core import overlap as joverlap
from repro.core import plan_cache as jcache
from repro.core import planner as jplanner
from repro.core import schedule as jsched
from repro.core import skew as jskew
from repro.core import topology as jtopo
from repro.core import transport_sim as jsim
from repro.data import pipeline as jpipe
from repro.models import Model as JaxModel
from repro.models import moe as jmoe
from repro.parallel.sharding import Runtime as JaxRuntime
from repro_torch.configs import get_config
from repro_torch.core import collectives as tcoll
from repro_torch.core import cost_model as tcost
from repro_torch.core import plan_cache as tcache
from repro_torch.core import planner as tplanner
from repro_torch.core import schedule as tsched
from repro_torch.core import skew as tskew
from repro_torch.core import topology as ttopo
from repro_torch.core import transport_sim as tsim
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as train_cli
from repro_torch.parallel.sharding import Runtime

ROOT = pathlib.Path(__file__).resolve().parent.parent
MiB = 1 << 20
SIZES = [256 << 10, 8 * MiB, 96 * MiB]
TOPOLOGIES = {
    "paper": lambda t: t.paper_testbed(),
    "three_vendor": lambda t: t.three_vendor_testbed(4.0),
    "multipod_2x4": lambda t: t.tpu_multipod(2, 4),
    "multipod_1x1": lambda t: t.tpu_multipod(1, 1),
    "scarce_2x4": lambda t: t.tpu_multipod_scarce(2, 4),
    "paper_drop1": lambda t: t.paper_testbed().drop_cluster(1),
    "paper_shrink0": lambda t: t.paper_testbed().shrink_cluster(0, 2),
    "paper_derate2": lambda t: t.paper_testbed().derate_cluster(2, 10e9),
}
COLLS = ("all_reduce", "reduce_scatter", "all_gather")
KNOBS = {
    "plain": {},
    "overlap": {"backward_compute_s": 0.02},
    "packed": {"packed": True, "n_leaves": 14},
    "balanced": {"try_balanced": True},
}
COPIED = ("topology", "cost_model", "transport_sim", "skew", "schedule")


def _pod_axis(topo) -> str | None:
    return "pod" if topo.n_clusters > 1 else None


def _both(name: str):
    return TOPOLOGIES[name](ttopo), TOPOLOGIES[name](jtopo)


@pytest.mark.parametrize("module", COPIED)
def test_planner_modules_are_verbatim_copies(module):
    ref = (ROOT / "src/repro/core" / f"{module}.py").read_text()
    assert (ROOT / "src/repro_torch/core" / f"{module}.py").read_text() == ref


@pytest.mark.parametrize("knob", KNOBS)
@pytest.mark.parametrize("coll", COLLS)
@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_plan_is_the_reference(topo, coll, knob):
    tt, jt = _both(topo)
    kw = dict(coll=coll, pod_axis=_pod_axis(tt), intra_axis="data", cache=None, **KNOBS[knob])
    got = tplanner.plan(tt, SIZES, **kw)
    want = jplanner.plan(jt, SIZES, **kw)
    assert got.summary() == want.summary()
    assert got.describe() == want.describe()
    assert got.recommended_mode() == want.recommended_mode()
    assert got.data_path == want.data_path
    key = dict(sizes=SIZES, coll=coll, pod_axis=_pod_axis(tt), intra_axis="data",
               max_chunks=32, compressions=(None, "bf16", "int8"), tol=0.25,
               flat_mechanism="host", try_balanced=True, chunk_bytes=4 << 20,
               backward_compute_s=KNOBS[knob].get("backward_compute_s"),
               packed=KNOBS[knob].get("packed", False),
               n_leaves=KNOBS[knob].get("n_leaves"), vectorized=True, level="auto")
    assert tplanner._plan_key(tt, **key) == jplanner._plan_key(jt, **key)


@pytest.mark.parametrize("topo", ["paper", "three_vendor", "multipod_2x4", "scarce_2x4",
                                  "paper_derate2"])
def test_cost_model_is_the_reference(topo):
    tt, jt = _both(topo)

    def outputs(cost, sched, t):
        out = {}
        for coll in COLLS:
            for mode in ("hier", "hier_pipelined", "hier_border_rs"):
                for codec in (None, "bf16"):
                    s = sched.build_schedule(coll, mode, 8, codec)
                    est = cost.estimate_schedule(t, s, 64 * MiB)
                    out[coll, mode, codec] = (dataclasses.astuple(est), est.sequential_s,
                                              est.pipelined_s, est.bandwidth(64 * MiB))
            out[coll, "hier_k4"] = dataclasses.astuple(
                cost.estimate_hier_collective(t, coll, 8 * MiB, n_chunks=4))
            out[coll, "chunks"] = cost.optimal_chunks(t, coll, 32 * MiB)
            out[coll, "volume"] = cost.c2c_volume(coll, 4 * MiB, t, 0)
        out["straggler"] = cost.straggler_step_time(t, 1e15, comm_s=0.01)
        out["backward"] = cost.backward_compute_time(t, 1e15)
        out["packed"] = cost.packed_overhead_time(t, 64 * MiB)
        out["flat_host"] = cost.flat_host_forwarding_time(t, "all_reduce", 64 * MiB)
        out["p2p"] = [cost.p2p_time(t.clusters[0], t.clusters[-1], 8 * MiB, m)
                      for m in ("native", "hetccl", "host")]
        return out

    assert outputs(tcost, tsched, tt) == outputs(jcost, jsched, jt)


@pytest.mark.parametrize("topo", ["paper", "three_vendor", "multipod_2x4", "scarce_2x4"])
def test_transport_sim_is_the_reference(topo):
    tt, jt = _both(topo)

    def outputs(sim, sched, t):
        out = {}
        for mode in ("hier", "hier_pipelined", "hier_border_rs"):
            s = sched.build_schedule("all_reduce", mode, 4, None)
            out[mode] = sim.simulate_schedule(s, t, 16 * MiB)
            out[mode, "cluster"] = sim.simulate_schedule(s, t, 16 * MiB, level="cluster")
            comp = [0.001 * (i + 1) for i in range(t.n_clusters)]
            out[mode, "step"] = sim.simulate_step(t, s, 16 * MiB, comp)
        src, dst = t.clusters[0], t.clusters[-1]
        for mech in ("native", "hetccl", "host"):
            tr = sim.simulate_p2p(src, dst, 8 * MiB, mech)
            out["p2p", mech] = (tr.time_s, tr.bandwidth_Bps, tr.per_chunk_events)
        out["c2c"] = sim.simulate_c2c_cpy(src, dst, 32 * MiB)
        out["fit"] = sim.fit_alpha_beta([1 << 10, 1 << 20, 1 << 24], [1e-5, 2e-4, 3e-3])
        return out

    assert outputs(tsim, tsched, tt) == outputs(jsim, jsched, jt)


@pytest.mark.parametrize("topo", ["three_vendor", "paper", "multipod_2x4"])
def test_skew_optimize_is_the_reference(topo):
    tt, jt = _both(topo)
    kw = dict(total_microbatches=24, coll="all_reduce", pod_axis="pod", intra_axis="data",
              compressions=(None, "int8"), cache=None)
    got = tskew.optimize(tt, 4e15, SIZES, **kw)
    want = jskew.optimize(jt, 4e15, SIZES, **kw)
    assert got.summary() == want.summary()
    assert got.describe() == want.describe()
    assert got.split.weights == want.split.weights
    assert got.plan.describe() == want.plan.describe()


SPLITS = [(10, [1.0, 2.5, 0.1], 1), (7, [1.0, 1.0, 1.0], 0), (9, [1.0, 1.0], 0),
          (5, [3.0, 1.0, 1.0, 1.0], 1), (100, [0.3, 0.3, 0.4], 1), (4, [1e-9, 1.0], 1)]


@pytest.mark.parametrize("total, weights, floor", SPLITS)
def test_integer_and_proportional_split_are_the_reference(total, weights, floor):
    """R1's tie-break (the earlier index wins an equal remainder) is
    inherited as it is, so splits stay bit-equal."""
    assert (ttopo.integer_split(total, weights, floor=floor)
            == jtopo.integer_split(total, weights, floor=floor))
    assert (ttopo.proportional_split(total * 1000 + 3, weights)
            == jtopo.proportional_split(total * 1000 + 3, weights))


@pytest.mark.parametrize("total, weights", [(s[0], s[1]) for s in SPLITS])
def test_shares_for_hosts_is_the_reference(total, weights):
    assert tpipe.shares_for_hosts(total, weights) == jpipe.shares_for_hosts(total, weights)
    shares = tpipe.shares_for_hosts(total, weights)
    for h in range(len(weights)):
        kw = dict(vocab_size=500, global_batch=total, seq_len=9, seed=2,
                  n_hosts=len(weights), host_id=h, host_shares=shares)
        got = tpipe.synth_batch(tpipe.DataConfig(**kw), 3)
        want = jpipe.synth_batch(jpipe.DataConfig(**kw), 3)
        assert got["tokens"].shape[0] == shares[h]
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("pod_axis", ["pod", None])
def test_bound_plan_resolves_on_the_groups(pod_axis):
    topo = ttopo.tpu_multipod(2, 4) if pod_axis else ttopo.tpu_multipod(1, 4)
    plan = tplanner.plan(topo, [64 << 10, 256 * MiB], pod_axis=pod_axis,
                         compressions=(None, "int8"), flat_mechanism="native",
                         try_balanced=False, cache=None)
    plan = dataclasses.replace(plan, cluster_weights=(1.0,) * topo.n_clusters)
    rt = Runtime(pod_group="P", data_group="D", dp_group="W")
    bound = tplanner.BoundPlan.of(plan, rt)
    for b in plan.buckets:
        c = bound.config_for(b.nbytes)
        assert isinstance(c, tcoll.CommConfig)
        assert (c.mode, c.n_chunks, c.compression) == (
            b.candidate.mode, b.candidate.n_chunks, b.candidate.compression)
        assert (c.pod_group, c.intra_group, c.dp_group) == (
            "P" if pod_axis else None, "D", "W")
        assert c.cluster_weights == plan.cluster_weights
        assert tcoll.resolve_config(bound, b.nbytes) == c
    assert bound.cluster_weights == plan.cluster_weights
    with pytest.raises(TypeError, match="bind it"):
        plan.config_for(1 << 20)


def test_plan_cache_round_trip_hits(tmp_path):
    path = str(tmp_path / "plans.pkl")
    kw = dict(pod_axis="pod", compressions=(None, "int8"), try_balanced=False)
    first = tplanner.plan(ttopo.tpu_multipod(2, 4), SIZES,
                          cache=tplanner.PlanCache(path=path), **kw)
    cache = tplanner.PlanCache(path=path)
    assert len(cache) == 1
    again = tplanner.plan(ttopo.tpu_multipod(2, 4), SIZES, cache=cache, **kw)
    assert (cache.hits, cache.misses) == (1, 0)
    assert again.summary() == first.summary()


def test_reference_plan_cache_file_is_cold(tmp_path):
    path = str(tmp_path / "reference.pkl")
    jplanner.plan(jtopo.tpu_multipod(2, 4), SIZES, pod_axis="pod",
                  cache=jcache.PlanCache(path=path))
    assert len(jcache.PlanCache(path=path)) == 1
    assert len(tcache.PlanCache(path=path)) == 0
    with open(path, "rb") as f:
        with pytest.raises(pickle.UnpicklingError, match="not a class of the port"):
            tcache._PortUnpickler(f).load()
    code = ("import sys\n"
            "from repro_torch.core import planner, topology\n"
            f"c = planner.PlanCache(path={path!r})\n"
            "assert len(c) == 0, len(c)\n"
            "p = planner.plan(topology.tpu_multipod(2, 4), [1 << 20], pod_axis='pod', cache=c)\n"
            "assert (c.hits, c.misses) == (0, 1)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('repro', 'jax')))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
    # the port's write replaced the reference's lines with its own
    assert len(tcache.PlanCache(path=path)) == 1


@pytest.fixture(scope="module")
def full_width_leaves():
    """The stacked-leaf count of full-width qwen2.5-3b on both sides, from
    shapes alone."""
    cfg = jax_config("qwen2.5-3b")
    shapes = jax.eval_shape(JaxModel(cfg, JaxRuntime()).init, jax.random.key(0))
    return train_cli.n_train_leaves(get_config("qwen2.5-3b")), len(jax.tree.leaves(shapes))


def _reference_launcher_plan(arch: str, n_leaves: int, pods: int, world: int, mode: str,
                             compression, plan: str, skew: str, cache, tp: int = 1,
                             smoke: bool = False):
    """The reference launcher's planning block (src/repro/launch/train.py)
    for a (pods, world // pods) mesh whose model axis is ``tp``, with its
    mode override and per-leaf fallback, and for an MoE model its All2All
    plan: (plan, mode, packed, cluster_weights, MoE a2a mode, MoE capacity
    weights, the a2a plan and its log line, or None)."""
    cfg = jax_config(arch, smoke=smoke)
    topo = jtopo.tpu_multipod(pods, world // pods)
    grad_bytes = max(1, cfg.param_count() * 4 // tp)
    plan_kw = dict(cache=cache, coll="reduce_scatter" if mode == "hier_zero1" else "all_reduce",
                   pod_axis="pod" if pods > 1 else None, intra_axis="data",
                   compressions=(None, compression) if compression else (None, "bf16"),
                   flat_mechanism="native", try_balanced=False, packed=True,
                   n_leaves=n_leaves)
    step_flops = 6.0 * cfg.active_param_count() * 4 * 1024
    backward_s, sizes = None, [grad_bytes]
    if mode not in ("fsdp", "hier_zero1"):
        backward_s = jcost.backward_compute_time(topo, step_flops)
        sizes = joverlap.bucket_sizes_for_volume(grad_bytes, cfg.n_layers,
                                                 joverlap.DEFAULT_CAP_BYTES)
    sim: dict = {}
    result = split = comp = weights = None
    if skew == "auto":
        sp = jskew.optimize(topo, step_flops, sizes,
                            total_microbatches=max(topo.n_clusters, 4),
                            backward_frac=0.0 if mode in ("fsdp", "hier_zero1") else 2.0 / 3.0,
                            _sim_cache=sim, **plan_kw)
        split, comp, weights = sp.split, sp.compute_s, sp.split.weights
        if any(abs(w - 1.0) > 1e-9 for w in weights):
            weights = None
        if plan == "auto":
            result = sp.plan
    if plan == "auto" and result is None:
        result = jplanner.plan(topo, sizes, backward_compute_s=backward_s, skew=split,
                               skew_compute_s=comp, _sim_cache=sim, **plan_kw)
    if (result is not None and result.overlap is not None
            and result.recommended_mode() != "hier_overlap"):
        result = jplanner.plan(topo, [grad_bytes], skew=split, skew_compute_s=comp,
                               _sim_cache=sim, **plan_kw)
    if result is not None and weights is None and result.cluster_weights is not None:
        result = dataclasses.replace(result, cluster_weights=None)
    moe_mode, moe_weights, a2a = "flat", None, None
    if plan == "auto" and cfg.n_experts:
        t_loc = max(1, 4 * 1024 // max(1, topo.n_ranks))
        a2a_bytes = cfg.n_experts * jmoe._capacity(t_loc, cfg.top_k, cfg.n_experts,
                                                   1.25) * cfg.d_model * 4
        a2a_plan = jplanner.plan(topo, [a2a_bytes] * cfg.n_layers, coll="all_to_all",
                                 pod_axis="pod" if pods > 1 else None, intra_axis="data",
                                 compressions=(None, "bf16"), flat_mechanism="native",
                                 try_balanced=False, cache=cache, _sim_cache=sim)
        moe_mode = a2a_plan.recommended_mode()
        if split is not None:
            moe_weights = tuple(split.weights)
        a2a = (a2a_plan, f"[plan] MoE dispatch/combine All2All -> {moe_mode} "
                         f"({a2a_bytes / 2 ** 20:.1f} MiB/layer)")
    packed = True
    if result is not None and mode not in ("fsdp", "hier_zero1"):
        mode = "hier_overlap" if result.recommended_mode() == "hier_overlap" else "hier"
    if result is not None and result.data_path == "per_leaf":
        packed = False
    return result, mode, packed, weights, moe_mode, moe_weights, a2a


LAUNCH_CASES = [(1, 1, "hier", None, "auto", "auto"), (2, 4, "hier", "int8", "auto", "auto"),
                (2, 8, "hier", "int8", "auto", "none"), (2, 4, "hier_zero1", "int8", "auto", "auto"),
                (1, 4, "fsdp", "int8", "auto", "none"), (2, 2, "hier", None, "manual", "auto")]


TP_LAUNCH_CASES = [(2, 8, "hier", "int8", "auto", "auto"), (1, 4, "hier_zero1", "int8", "auto", "none")]


def _check_make_plan(full_width_leaves, pods, world, mode, codec, plan, skew, tp=1):
    n_leaves, jn_leaves = full_width_leaves
    assert n_leaves == jn_leaves == 14
    lines: list[str] = []
    got = train_cli.make_plan(get_config("qwen2.5-3b"), pods, world, mode, codec, plan=plan,
                              skew=skew, global_batch=4, seq=1024, tp=tp, log=lines.append)
    cache = jcache.PlanCache()
    want, wmode, wpacked, wweights, _, _, _ = _reference_launcher_plan(
        "qwen2.5-3b", jn_leaves, pods, world, mode, codec, plan, skew, cache, tp=tp)
    assert (got.mode, got.packed, got.cluster_weights) == (
        wmode, wpacked, None if wweights is None else tuple(wweights))
    if want is None:
        assert got.plan is None
    else:
        assert got.plan.summary() == want.summary()
        assert got.plan.describe() == want.describe()
        assert got.plan.describe() in lines
    assert any(line.startswith("[plan] cache: ") for line in lines)
    return got


@pytest.mark.parametrize("pods, world, mode, codec, plan, skew", LAUNCH_CASES)
def test_make_plan_is_the_reference_launchers(full_width_leaves, pods, world, mode, codec,
                                              plan, skew):
    _check_make_plan(full_width_leaves, pods, world, mode, codec, plan, skew)


@pytest.mark.parametrize("pods, world, mode, codec, plan, skew", TP_LAUNCH_CASES)
def test_make_plan_is_the_reference_launchers_at_tp2(full_width_leaves, pods, world, mode,
                                                     codec, plan, skew):
    """With a model axis of 2 each rank syncs half the gradients: the
    buckets are priced at half the bytes, as the reference divides them
    by its model axis."""
    got = _check_make_plan(full_width_leaves, pods, world, mode, codec, plan, skew, tp=2)
    half = get_config("qwen2.5-3b").param_count() * 4 // 2
    assert sum(b.nbytes for b in got.plan.buckets) == half


@pytest.mark.parametrize("pods, world, skew, smoke", [(2, 8, "none", True), (2, 8, "auto", True),
                                                     (1, 4, "auto", True),
                                                     (2, 8, "none", False)])
def test_make_plan_plans_the_moe_all_to_all_as_the_reference(pods, world, skew, smoke):
    """An MoE model with --plan auto: the reference launcher's All2All plan,
    its mode, its log line and table, and the skew weights that steer
    expert capacity; the gradient plan as before.  Full-width
    qwen3-moe-30b-a3b's 40 MiB per layer on 2 pods x 4 ranks rides
    ``hier_a2a``."""
    cfg = get_config("qwen3-moe-30b-a3b", smoke=smoke)
    shapes = jax.eval_shape(JaxModel(jax_config("qwen3-moe-30b-a3b", smoke=smoke),
                                     JaxRuntime()).init, jax.random.key(0))
    n_leaves = len(jax.tree.leaves(shapes))
    assert train_cli.n_train_leaves(cfg) == n_leaves
    lines: list[str] = []
    got = train_cli.make_plan(cfg, pods, world, "hier", "int8", plan="auto", skew=skew,
                              log=lines.append)
    want, wmode, wpacked, _, moe_mode, moe_weights, (a2a, line) = _reference_launcher_plan(
        "qwen3-moe-30b-a3b", n_leaves, pods, world, "hier", "int8", "auto", skew,
        jcache.PlanCache(), smoke=smoke)
    assert (got.mode, got.packed) == (wmode, wpacked)
    assert got.plan.describe() == want.describe()
    assert (got.moe_a2a_mode, got.moe_cluster_weights) == (moe_mode, moe_weights)
    if (pods, smoke) == (2, False):
        assert moe_mode == "hier_a2a"
    assert line in lines and a2a.describe() in lines
    assert any(x.startswith("[plan] cache: ") for x in lines[lines.index(line):])


def test_planned_path_of_the_issue_plans(full_width_leaves):
    """What the reference plans for qwen2.5-3b: hier_overlap on the per-leaf
    path with 32-chunk int8 buckets for 2 pods x 4 ranks; in a world of one
    the overlap plan loses to one sync, re-planned as one bucket with no
    pod axis and no codec, per leaf."""
    got = train_cli.make_plan(get_config("qwen2.5-3b"), 2, 8, "hier", "int8", plan="auto",
                              log=lambda line: None)
    assert (got.mode, got.packed) == ("hier_overlap", False)
    cands = {(b.candidate.mode, b.candidate.n_chunks, b.candidate.compression)
             for b in got.plan.buckets}
    assert ("hier_pipelined", 32, "int8") in cands
    one = train_cli.make_plan(get_config("qwen2.5-3b"), 1, 1, "hier", None, plan="auto",
                              skew="auto", log=lambda line: None)
    assert (one.mode, one.packed) == ("hier", False)
    assert one.plan.pod_axis is None and one.plan.overlap is None
    assert [b.candidate.compression for b in one.plan.buckets] == [None]


def test_entry_point_plans_on_cpu_and_hits_its_cache(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), GLOO_SOCKET_IFNAME="lo")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--smoke", "--device", "cpu",
           "--steps", "2", "--seq", "64", "--plan", "auto", "--skew", "auto",
           "--plan-cache", str(tmp_path / "plans.pkl")]
    summaries = []
    for launch in range(2):
        res = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=180)
        assert res.returncode == 0, res.stdout + res.stderr
        lines = res.stdout.splitlines()
        plan_lines = [line for line in lines if line.startswith("[plan]")]
        assert plan_lines[0].startswith("[plan] flat (biggest bucket: flat")
        assert any(line.startswith("[skew] ") for line in lines)
        assert any(line.startswith("CommPlan[all_reduce] over 1 cluster(s)") for line in lines)
        steps = [json.loads(line) for line in lines if line.startswith('{"step"')]
        assert [s["step"] for s in steps] == [0, 1]
        assert all(np.isfinite(s["loss"]) and not s["gated"] for s in steps)
        summary = json.loads(lines[-1])
        assert summary["plan"]["recommended_mode"] == "flat"
        assert summary["mode"] == "hier" and summary["world"] == 1
        summaries.append(summary)
    # the skew optimizer's splits share cache lines, so the first launch
    # may hit too; the second finds every line on disk
    assert summaries[0]["plan_cache"]["misses"] > 0
    assert summaries[1]["plan_cache"]["hits"] > 0 == summaries[1]["plan_cache"]["misses"]
    assert summaries[0]["plan"] == summaries[1]["plan"]
