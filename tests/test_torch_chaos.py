"""The chaos engine and the collective guard on eight gloo ranks: the
analog of the reference's ``tests/mdscripts/check_chaos.py``.

Eight ranks as 2 pods x 4 data train the f32 smoke qwen2.5-3b with
``hier`` on the f32 wire (no codec), 16 steps, under the reference's
``GuardConfig`` of that script; seed 8's ``FaultPlan`` places one fault
per class (the reference's plan: transient @ 3, degraded link @ 4, NaN
payload @ 8, hang @ 13, bit flip @ 14).  Each rank runs the script's
loop in the port: the guard's retry around the injector's transfer
wrapper, the hang stall and heartbeats, the payload check (the NaN
surfaces in the synced grad norm through the finite gate), the CRC
against the fault-free run's (the bit flip), the emulated link-health
feed escalating to the elastic controller's re-plan.  A corrupted step
is re-run from the state before it (the port updates in place, so the
state is cloned before every step that carries a corruption hook).

* Every class is detected at its step with the reference's attribution,
  and the committed trajectory (losses and state checksums) is bit-equal
  to the fault-free run's; the same seed replays the same faults,
  detections and losses; a divergent digest is named before launch.
* The guarded fault-free ``flat`` and ``hier_pipelined`` runs raise no
  event.
* Against the reference (its step built with ``donate=False`` on a
  (2, 4) mesh of host devices, from the same parameters and batches):
  the fault-free losses within 1e-3, as the four-rank training cases
  hold them; the NaN step's and the bit-flip step's metrics, each from
  the same pre-step state in both packages, within 1e-3, the NaN step's
  grad norm NaN and its update skipped in both.
* The trainer's CLI with ``--guard --chaos 8 --ckpt-dir --resume
  --elastic --inject-pod-failure`` on eight ranks.
"""

import dataclasses
import datetime
import json
import os
import sys
import time

import numpy as np

WORLD, PODS, GB, S = 8, 2, 8, 32
SEED, N_STEPS = 8, 16
LR, WARMUP = 5e-3, 1
# tests/mdscripts/check_chaos.py's GuardConfig
GUARD_KW = dict(warmup_steps=3, min_deadline_s=0.25, deadline_margin=4.0, max_retries=3,
                backoff_base_s=0.0, link_window=4, ewma_alpha=0.7, degraded_factor=2.0,
                degraded_patience=2)
PLAN_KW = dict(coll="all_reduce", pod_axis="pod", intra_axis="data",
               compressions=(None, "bf16"), flat_mechanism="native", try_balanced=False)
MATRIX_STEPS = 6


def batch(step: int, vocab: int) -> dict:
    rng = np.random.default_rng(1000 + step)
    return {"tokens": rng.integers(0, vocab, (GB, S), dtype=np.int32),
            "labels": rng.integers(0, vocab, (GB, S), dtype=np.int32)}


def _jax_main(out_dir: str, part: str) -> None:
    """The reference's fault-free hier run on (2, 4), and its NaN and
    bit-flip steps run under its hook from the fault-free state before
    them."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from _torch_world import nest
    from repro.configs import get_config as jax_config
    from repro.core import primitives as jprim
    from repro.launch.mesh import runtime_for_mesh
    from repro.models import Model as JaxModel
    from repro.runtime.faults import FaultInjector as JInjector
    from repro.runtime.faults import FaultPlan as JPlan
    from repro.train import TrainConfig as JaxTrainConfig
    from repro.train import make_train_step as jax_train_step
    from repro.train import optimizer as jopt
    from repro.train.optimizer import OptConfig as JaxOpt

    cfg = dataclasses.replace(jax_config("qwen2.5-3b", smoke=True), dtype=jnp.float32)
    mesh = jax.make_mesh((PODS, WORLD // PODS), ("pod", "data"))
    model = JaxModel(cfg, runtime_for_mesh(mesh))
    build, _ = jax_train_step(model, JaxTrainConfig(comm_mode="hier", opt=JaxOpt(
        lr=LR, warmup_steps=WARMUP)), mesh=mesh, donate=False)
    params = jax.tree.map(jnp.asarray, nest(np.load(os.path.join(out_dir, "params.npz"))))
    shapes = jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape, p.dtype), params)
    step_fn, _ = build(shapes)
    params = jax.tree.map(lambda p, s: jax.device_put(p, NamedSharding(mesh, s)), params,
                          model.param_specs(shapes))
    opt = jopt.adam_init(params)
    plan = JPlan.generate(SEED, N_STEPS, n_clusters=PODS, n_ranks=WORLD)
    faulted = {e.step: e.kind for e in plan.events if e.kind in ("nan_payload", "bitflip")}
    out = {"losses": np.zeros(N_STEPS)}
    for i in range(N_STEPS):
        b = {k: jnp.asarray(v) for k, v in batch(i, cfg.vocab_size).items()}
        if i in faulted:
            hook = JInjector(plan).corruption_hook(i, axes=mesh.axis_names)
            with jprim.inject_hook(hook):
                f_step, _ = build(shapes)
                new_p, _, m = f_step(params, opt, b)
            kind = faulted[i]
            out[f"{kind}/metrics"] = np.array([float(m["loss"]), float(m["grad_norm"])])
            out[f"{kind}/unchanged"] = np.array(all(
                np.array_equal(np.asarray(a), np.asarray(c))
                for a, c in zip(jax.tree.leaves(params), jax.tree.leaves(new_p))))
        params, opt, m = step_fn(params, opt, b)
        out["losses"][i] = float(m["loss"])
    np.savez(os.path.join(out_dir, f"jax_{part}.npz"), **out)


def _gloo_rank(rank: int, store_path: str, out_dir: str) -> None:
    """One rank: the fault-free guarded run, two chaos runs, the desync
    check and the fault-free matrix, as tests/mdscripts/check_chaos.py."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist

    from _torch_world import nest
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.core import planner, primitives, topology
    from repro_torch.core.collectives import CommConfig
    from repro_torch.core.plan_cache import PlanCache
    from repro_torch.launch.mesh import runtime_for_groups
    from repro_torch.launch.train import dp_rows
    from repro_torch.runtime import elastic
    from repro_torch.runtime.faults import FaultInjector, FaultPlan
    from repro_torch.runtime.guard import (CollectiveGuard, GuardConfig, GuardEvent,
                                           payload_checksum, schedule_digest)
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import TrainConfig, make_train_step

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    try:
        cfg = dataclasses.replace(get_config("qwen2.5-3b", smoke=True), dtype=torch.float32)
        rt = runtime_for_groups(pods=PODS, data_per_pod=WORLD // PODS)
        tree = nest(np.load(os.path.join(out_dir, "params.npz")))
        rows = dp_rows(rank, GB, PODS, WORLD // PODS, 1)
        topo = topology.tpu_multipod(PODS, WORLD // PODS)
        grad_bytes = cfg.param_count() * 4
        gcfg = GuardConfig(**GUARD_KW)

        def local(i):
            return {k: torch.from_numpy(v[rows]).long() for k, v in
                    batch(i, cfg.vocab_size).items()}

        def trainer(mode="hier"):
            model = params_from_jax(tree, cfg, rt, device="cpu")
            step_fn, _ = make_train_step(model, TrainConfig(comm_mode=mode, opt=opt_lib.OptConfig(
                lr=LR, warmup_steps=WARMUP)))
            return model, step_fn, opt_lib.adam_init(opt_lib.flat_params(model.train_leaves())[0])

        def make_guard(ctl=None):
            return CollectiveGuard(gcfg, nominal_Bps={i: c.nic_Bps for i, c in
                                                      enumerate(topo.clusters)},
                                   expected_ranks=range(WORLD), elastic=ctl)

        def snapshot(model, opt):
            return ([p.clone() for p in opt_lib.flat_params(model.train_leaves())[0]],
                    [m.clone() for m in opt.mu], [v.clone() for v in opt.nu], opt.step)

        def restore(model, opt, snap):
            with torch.no_grad():
                for dst, src in zip(opt_lib.flat_params(model.train_leaves())[0], snap[0]):
                    dst.copy_(src)
            for dst, src in zip(opt.mu + opt.nu, snap[1] + snap[2]):
                dst.copy_(src)
            opt.step = snap[3]

        def run(inj=None, ctl=None, ref_sums=None):
            model, step_fn, opt = trainer()
            guard = make_guard(ctl)
            digest = schedule_digest(CommConfig(mode="hier", pod_group=rt.pod_group,
                                                intra_group=rt.data_group, n_chunks=4))
            assert guard.check_agreement(0, {r: digest for r in range(WORLD)}) is None
            losses, sums, detections, corrupted = [], [], [], {}
            for step in range(N_STEPS):
                b = local(step)
                stalled = (inj.sleep_s(step, guard.deadline_s or gcfg.min_deadline_s)
                           if inj else 0.0)
                hook = inj.corruption_hook(step, rank=rank) if inj else None
                snap = snapshot(model, opt) if hook is not None else None
                timing = {}

                def _run(b=b, hook=hook):
                    t0 = time.monotonic()
                    if hook is not None:
                        with primitives.inject_hook(hook):
                            out = step_fn(opt, b)
                    else:
                        out = step_fn(opt, b)
                    timing["dt"] = time.monotonic() - t0
                    return out

                thunk = inj.wrap_transfer(step, _run) if inj else _run
                n_ev = len(guard.events)
                m = guard.retry(step, thunk, sleep=lambda s: None)
                hung = inj.hung_ranks(step) if inj else ()
                for r in range(WORLD):
                    if r not in hung:
                        guard.heartbeat(step, r)
                if hook is None and step > 0:
                    guard.observe_step_time(step, timing.get("dt", 0.0) + stalled)
                gev = guard.check_payload(step, {"loss": np.float32(m["loss"]),
                                                 "grad_norm": np.float32(m["grad_norm"]),
                                                 "params": model.param_tree()})
                corrupt = gev is not None
                if (not corrupt and ref_sums is not None
                        and guard.checksum_at(step) != ref_sums[step]):
                    corrupt = True
                    guard.events.append(GuardEvent(
                        kind="corrupt_payload", step=step, attribution="checksum",
                        detail="finite payload, CRC32 mismatch vs reference"))
                if hook is not None:
                    corrupted[step] = (m["loss"], m["grad_norm"], m["gated"])
                if corrupt:
                    # retransmission: the one-shot corruption has fired, so the
                    # step re-run from the state before it is clean
                    restore(model, opt, snap)
                    m = step_fn(opt, b)
                nbytes = int(grad_bytes * (1.0 + 0.25 * (step % 4))) + 1
                for ci, cl in enumerate(topo.clusters):
                    t_obs = nbytes / cl.nic_Bps
                    if inj is not None:
                        t_obs = inj.perturb_transfer_time(step, ci, t_obs)
                    guard.observe_transfer(step, ci, nbytes, t_obs)
                if ctl is not None and ctl.state == "replanned":
                    ctl.resumed(step)
                losses.append(m["loss"])
                sums.append(payload_checksum({"loss": np.float32(m["loss"]),
                                              "grad_norm": np.float32(m["grad_norm"]),
                                              "params": model.param_tree()}))
                if inj is not None:
                    for ev in guard.events[n_ev:]:
                        kind = {"transient_retry": "transient",
                                "corrupt_payload": "nan_payload" if ev.attribution != "checksum"
                                else "bitflip"}.get(ev.kind, ev.kind)
                        inj_step = next((e.step for e in inj.plan.events if e.kind == kind), step)
                        detections.append((kind, inj_step, step, ev.attribution))
            return losses, sums, guard, detections, corrupted

        ref_losses, ref_sums, ref_guard, _, _ = run()
        plan = FaultPlan.generate(SEED, N_STEPS, n_clusters=topo.n_clusters, n_ranks=WORLD)

        def chaos_run():
            inj = FaultInjector(plan)
            cache = PlanCache()
            planner.plan(topo, [grad_bytes], cache=cache, **PLAN_KW)
            ctl = elastic.ElasticController(topo, [grad_bytes], plan_cache=cache,
                                            plan_kw=PLAN_KW)
            losses, sums, guard, detections, corrupted = run(inj, ctl, ref_sums)
            return inj, cache, ctl, losses, sums, guard, detections, corrupted

        runs = [chaos_run() for _ in range(2)]
        inj, cache, ctl, losses, sums, guard, detections, corrupted = runs[0]
        good = schedule_digest(CommConfig(mode="hier", n_chunks=4))
        digests = {r: good for r in range(WORLD)}
        digests[5] = schedule_digest(CommConfig(mode="hier", n_chunks=8))
        desync = make_guard().check_agreement(0, digests)
        matrix = {}
        for mode in ("flat", "hier_pipelined"):
            model, step_fn, opt = trainer(mode)
            g = make_guard()
            for step in range(MATRIX_STEPS):
                t0 = time.monotonic()
                m = step_fn(opt, local(step))
                dt = time.monotonic() - t0
                for r in range(WORLD):
                    g.heartbeat(step, r)
                if step > 0:
                    g.observe_step_time(step, dt)
                g.check_payload(step, {"loss": np.float32(m["loss"]),
                                       "grad_norm": np.float32(m["grad_norm"])})
                nbytes = int(grad_bytes * (1.0 + 0.25 * (step % 4))) + 1
                for ci, cl in enumerate(topo.clusters):
                    g.observe_transfer(step, ci, nbytes, nbytes / cl.nic_Bps)
            matrix[mode] = [e.summary() for e in g.events]

        def events(g):
            return [(e.kind, e.step, e.attribution, e.measured if e.kind == "transient_retry"
                     else None) for e in g.events]

        report = {
            "plan": plan.summary(), "ref_losses": ref_losses, "ref_sums": ref_sums,
            "ref_events": events(ref_guard), "losses": [r[3] for r in runs],
            "sums": [r[4] for r in runs], "detections": [r[6] for r in runs],
            "events": [events(r[5]) for r in runs],
            "injected": [r[0].injected for r in runs],
            "corrupted": {str(k): v for k, v in corrupted.items()},
            "invalidations": cache.stats()["invalidations"],
            "replan": [e.replan.summary() for e in guard.events if e.kind == "degraded_link"],
            "derated": (ctl.topo.clusters[0].nic_Bps, ctl.topo.clusters[1].nic_Bps),
            "nominal": (topo.clusters[0].nic_Bps, topo.clusters[1].nic_Bps),
            "ctl_state": ctl.state,
            "desync": None if desync is None else [desync.kind, desync.attribution],
            "matrix": matrix}
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), report=np.array(json.dumps(report)))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    _jax_main(sys.argv[1], sys.argv[2])
    sys.exit(0)


import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402

from _torch_world import flat_tree, run_world  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.parallel.sharding import Runtime as JaxRuntime  # noqa: E402
from repro.runtime.faults import FaultPlan as JPlan  # noqa: E402
from test_torch_tp import _run_ranks  # noqa: E402

# the four-rank training cases' tolerance on losses and grad norms
LOSS_TOL = 1e-3


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("chaos")
    cfg = dataclasses.replace(jax_config("qwen2.5-3b", smoke=True), dtype=jnp.float32)
    params = JaxModel(cfg, JaxRuntime()).init(jax.random.key(0))
    np.savez(tmp / "params.npz", **flat_tree(jax.tree.map(np.asarray, params)))
    want, ranks = run_world(__file__, tmp, ("ref",), WORLD, _gloo_rank, WORLD)
    return want, [json.loads(str(r["report"])) for r in ranks]


def test_plan_is_the_references(results):
    _, ranks = results
    ref = JPlan.generate(SEED, N_STEPS, n_clusters=PODS, n_ranks=WORLD).summary()
    assert all(r["plan"] == json.loads(json.dumps(ref)) for r in ranks)
    kinds = {e["kind"]: e["step"] for e in ref["events"]}
    assert kinds == {"transient": 3, "degraded_link": 4, "nan_payload": 8, "hang": 13,
                     "bitflip": 14}


def test_fault_free_guarded_run_raises_no_event(results):
    _, ranks = results
    for r in ranks:
        assert r["ref_events"] == []
        assert r["ref_losses"] == ranks[0]["ref_losses"] and r["ref_sums"] == ranks[0]["ref_sums"]


def test_every_fault_class_is_detected_and_attributed(results):
    _, ranks = results
    plan = {e["kind"]: e for e in ranks[0]["plan"]["events"]}
    for r in ranks:
        det = {d[0]: d for d in r["detections"][0]}
        assert set(det) == set(plan)
        for kind in ("hang", "transient", "nan_payload", "bitflip"):
            assert det[kind][2] == plan[kind]["step"], (kind, det[kind])
        assert det["hang"][3] == f"rank {plan['hang']['rank']}"
        assert "grad_norm" in det["nan_payload"][3]
        assert det["bitflip"][3] == "checksum"
        retry = [e for e in r["events"][0] if e[0] == "transient_retry"]
        assert len(retry) == 1 and retry[0][3] == 1.0
        deg = plan["degraded_link"]
        assert det["degraded_link"][3] == f"link {deg['cluster']}"
        assert deg["step"] < det["degraded_link"][2] <= deg["step"] + 8
        assert len(r["replan"]) == 1 and r["replan"][0]["trigger"] == "degraded_link"
        assert r["replan"][0]["invalidated_entries"] >= 1 and r["invalidations"] == 1
        assert r["derated"][deg["cluster"]] < r["nominal"][deg["cluster"]]
        assert r["ctl_state"] == "healthy"
        fault_steps = {e["step"] for e in r["plan"]["events"]}
        for kind, step, _, _ in r["events"][0]:
            if kind == "degraded_link":
                assert deg["step"] <= step
            else:
                assert step in fault_steps


def test_committed_trajectory_is_the_fault_free_one(results):
    _, ranks = results
    for r in ranks:
        assert r["losses"][0] == r["ref_losses"]
        assert r["sums"][0] == r["ref_sums"]


def test_same_seed_replays_the_same_story(results):
    _, ranks = results
    for r in ranks:
        assert r["losses"][1] == r["losses"][0] and r["sums"][1] == r["sums"][0]
        assert r["detections"][1] == r["detections"][0]
        assert r["events"][1] == r["events"][0]
        assert r["injected"][1] == r["injected"][0]


def test_desync_and_fault_free_matrix(results):
    _, ranks = results
    for r in ranks:
        assert r["desync"] == ["desync", "rank 5"]
        assert r["matrix"] == {"flat": [], "hier_pipelined": []}


def test_losses_and_corrupted_steps_match_the_reference(results):
    want, ranks = results
    np.testing.assert_allclose(ranks[0]["ref_losses"], want["losses"], rtol=0, atol=LOSS_TOL)
    nan_loss, nan_gnorm, nan_gated = ranks[0]["corrupted"]["8"]
    jl, jg = want["nan_payload/metrics"]
    assert nan_gated and np.isnan(nan_gnorm) and np.isnan(jg)
    assert bool(want["nan_payload/unchanged"])        # the reference skipped it too
    assert abs(nan_loss - jl) <= LOSS_TOL
    flip_loss, flip_gnorm, flip_gated = ranks[0]["corrupted"]["14"]
    assert not flip_gated and np.isfinite(flip_gnorm)
    np.testing.assert_allclose([flip_loss, flip_gnorm], want["bitflip/metrics"], rtol=0,
                               atol=LOSS_TOL)


def test_trainer_cli_with_every_runtime_flag(tmp_path):
    """``python -m repro_torch.launch.train`` on eight ranks (2 pods x 4
    data) with the guard, seed 8's chaos, checkpoints and the elastic
    pod failure: every rank reports the guard, the injected faults and the
    checkpoints; the last pod's ranks leave at the failure and the
    survivors finish on the re-planned world."""
    ck = tmp_path / "ck"
    outs = _run_ranks("repro_torch.launch.train",
                      ["--smoke", "--device", "cpu", "--steps", "8", "--seq", "32",
                       "--global-batch", "8", "--pods", "2", "--guard", "--chaos", "8",
                       "--ckpt-dir", str(ck), "--ckpt-every", "2", "--resume", "--elastic",
                       "--inject-pod-failure", "6"], WORLD)
    for r, lines in enumerate(outs):
        summary = lines[-1]
        alive = r < WORLD // PODS
        assert summary["alive"] == alive and summary["world"] == WORLD
        assert summary["chaos"]["plan"]["seed"] == 8
        assert {i["kind"] for i in summary["chaos"]["injected"]} >= {"transient", "nan_payload"}
        assert summary["guard"]["counts"]["transient_retry"] == 1
        reports = {rep["trigger"]: rep for rep in summary["elastic"]}
        assert reports["pod_failure"]["step_detected"] == 6
        steps = [s["step"] for s in lines[:-1]]
        assert steps == (list(range(8)) if alive else list(range(6)))
        assert all(np.isfinite(s["loss"]) for s in lines[:-1])
        if alive:
            assert reports["pod_failure"]["remap_path"] == "slot_map"
            assert summary["checkpoints"] == [2, 4, 6, 8]
    assert sorted(p.name for p in ck.iterdir()) == ["step_4", "step_6", "step_8"]
