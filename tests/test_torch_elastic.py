"""Elastic re-planning and elastic restarts on eight gloo ranks: the
analogs of the reference's ``tests/mdscripts/check_elastic_replan.py``
and ``check_elastic.py``, and the trainer's runtime knobs through
``launch.train.run``.

The f32 smoke qwen2.5-3b, lr 5e-3 with one warm-up step, the reference
scripts' data stream (``synth_batch``, global batch 4 x 32, seed 9), its
parameters drawn by the reference at TP 2 (TP 1 for the data-only leg).

* Leg A: ``hier_zero1`` on (2, 2, 2), two steps, a checkpoint at step 2;
  pod 1 is reported lost (the controller's plan-cache invalidation and
  validated survivor plan), the survivor groups are cut
  (``launch.mesh.survivor_mesh``: every rank takes part, pod 1's ranks
  get none), and the ZeRO-1 master crosses onto (2, 2) through the slot
  map with ``packing.pack`` patched to raise.  The three resumed losses
  are bit-equal to a survivor run restored from the step-2 checkpoint.
* Leg B: ``hier_zero1`` on a data-only (4,) world (ranks 0-3), two
  steps; three slow steps confirm a straggler and shrink the world to
  (2,).  The remapped master and moments are bit-equal to the
  reference's ``remap_zero_state`` of the same host state (and to an
  independent gather / slice / repad), and the two resumed losses are
  bit-equal to a run from that ground truth.
* Both legs' losses are within 1e-3 of the reference's on a mesh of the
  same shape (its steps built with ``donate=False``).
* The ``check_elastic.py`` analog: ``hier`` on (2, 2, 2), a checkpoint,
  two steps in a world of one (rank 0 alone, no sync), a checkpoint, two
  steps back on (2, 2, 2): the six losses within 0.05 of an uninterrupted
  world-of-one run, the script's bound.
* ``launch.train.run`` with ``guard``, ``chaos=8``, checkpoints,
  ``elastic`` and ``inject_pod_failure=6`` on 2 pods x 4 data
  (``hier_zero1`` + int8), then ``resume`` from its last checkpoint.
* ``launch.train.run``'s other recovery paths on 2 pods x 4 data: the
  watchdog's rollback to the last checkpoint (``hier``, a spike factor
  of 0.5 that flags every loss past the ninth), its losses after the
  rollback bit-equal to steps from that checkpoint; and a pod failure of
  ``hier_zero1`` with ``packing.remap_shard_ops`` raising, which falls
  back to the checkpoint restore (losses bit-equal to the slot map's,
  the checkpoint being the state the failure interrupted) and, with no
  checkpoint, to the optimizer's re-bootstrap (losses bit-equal to a
  survivor run bootstrapped from the same parameters).
"""

import dataclasses
import datetime
import json
import os
import sys

import numpy as np

WORLD = 8
LR, WARMUP = 5e-3, 1
GB, S, DATA_SEED = 4, 32, 9
LOSS_TOL = 1e-3
# check_elastic.py's bound on the losses of the interrupted run
RESTART_TOL = 0.05


def _batch(step: int, vocab: int) -> dict:
    from repro_torch.data.pipeline import DataConfig, synth_batch
    return synth_batch(DataConfig(vocab_size=vocab, global_batch=GB, seq_len=S,
                                  seed=DATA_SEED), step)


def _jax_main(out_dir: str, part: str) -> None:
    """The reference's legs on meshes of the same shapes: "A" (pod
    failure, (2, 2, 2) -> (2, 2)), "B" (straggler shrink, (4,) -> (2,)),
    "E" (the mesh -> single device -> mesh restart)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from _torch_world import nest
    from repro.configs import get_config as jax_config
    from repro.models import Model as JaxModel
    from repro.parallel.sharding import Runtime as JaxRuntime
    from repro.runtime import elastic as jelastic
    from repro.train import TrainConfig as JaxTrainConfig
    from repro.train import make_train_step as jax_train_step
    from repro.train.optimizer import OptConfig as JaxOpt
    from repro.train.optimizer import ZeroState as JZero

    cfg = dataclasses.replace(jax_config("qwen2.5-3b", smoke=True), dtype=jnp.float32)
    opt_cfg = JaxOpt(lr=LR, warmup_steps=WARMUP)

    def load(name):
        return jax.tree.map(jnp.asarray, nest(np.load(os.path.join(out_dir, name))))

    def batch(i):
        return {k: jnp.asarray(v) for k, v in _batch(i, cfg.vocab_size).items()}

    def steps(fn, p, o, lo, hi):
        losses = []
        for i in range(lo, hi):
            p, o, m = fn(p, o, batch(i))
            losses.append(float(m["loss"]))
        return p, o, losses

    def host(tree):
        return jax.tree.map(lambda x: np.asarray(jax.device_get(x)), tree)

    def put(params, model, shapes, mesh):
        return jax.tree.map(lambda x, sp: jax.device_put(np.asarray(x), NamedSharding(mesh, sp)),
                            params, model.param_specs(shapes))

    def put_zero(st, mesh, spec):
        sh, rep = NamedSharding(mesh, spec), NamedSharding(mesh, P())
        return JZero(jax.device_put(st.flat_param, sh), jax.device_put(st.mu, sh),
                     jax.device_put(st.nu, sh), jax.device_put(np.asarray(st.step), rep))

    zero = JaxTrainConfig(comm_mode="hier_zero1", opt=opt_cfg)
    out = {}
    if part == "A":
        params = load("params_tp2.npz")
        shapes = jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape, p.dtype), params)
        mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
        model = JaxModel(cfg, JaxRuntime(tp_axis="model", dp_axis="data", pod_axis="pod",
                                         tp_size=2))
        build, _ = jax_train_step(model, zero, mesh=mesh, donate=False)
        step, boot = build(shapes)
        p = put(params, model, shapes, mesh)
        p, o, pre = steps(step, p, boot(p), 0, 2)
        mesh_s = jelastic.survivor_mesh(mesh, "pod", 1)
        model_s = JaxModel(cfg, JaxRuntime(tp_axis="model", dp_axis="data", tp_size=2))
        step_s, _ = jax_train_step(model_s, zero, mesh=mesh_s, donate=False)[0](shapes)
        lay = [jelastic.zero1_master_layout(shapes, m.param_specs(shapes), sizes)
               for m, sizes in ((model, {"pod": 2, "data": 2, "model": 2}),
                                (model_s, {"data": 2, "model": 2}))]
        rem = jelastic.remap_zero_state(host(o), *lay, old_world=2, new_world=2, n_columns=2)
        _, _, live = steps(step_s, put(host(p), model_s, shapes, mesh_s),
                           put_zero(rem, mesh_s, P(("data", "model"))), 2, 5)
        out["A"] = np.array(pre + live)
    elif part == "B":
        params = load("params_tp1.npz")
        shapes = jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape, p.dtype), params)
        devs = np.asarray(jax.devices())
        mesh4, mesh2 = (jax.sharding.Mesh(devs[:n], ("data",)) for n in (4, 2))
        model = JaxModel(cfg, JaxRuntime(dp_axis="data"))
        step4, boot4 = jax_train_step(model, zero, mesh=mesh4, donate=False)[0](shapes)
        p = put(params, model, shapes, mesh4)
        p, o, pre = steps(step4, p, boot4(p), 0, 2)
        specs = model.param_specs(shapes)
        lay4, lay2 = (jelastic.zero1_master_layout(shapes, specs, {"data": n}) for n in (4, 2))
        rem = jelastic.remap_zero_state(host(o), lay4, lay2, old_world=4, new_world=2)
        step2 = jax_train_step(model, zero, mesh=mesh2, donate=False)[0](shapes)[0]
        _, _, live = steps(step2, put(host(p), model, shapes, mesh2),
                           put_zero(rem, mesh2, P("data")), 2, 4)
        out["B"] = np.array(pre + live)
    else:
        params = load("params_tp2.npz")
        shapes = jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape, p.dtype), params)
        model1 = JaxModel(cfg, JaxRuntime())
        step1, init1 = jax_train_step(model1, JaxTrainConfig(comm_mode="flat", opt=opt_cfg),
                                      mesh=None)
        from repro.train import optimizer as jopt
        _, _, one = steps(step1, params, jopt.adam_init(params), 0, 6)
        out["E"] = np.array(one)
    np.savez(os.path.join(out_dir, f"jax_{part}.npz"), **out)


def _gloo_rank(rank: int, store_path: str, out_dir: str) -> None:
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist

    from _torch_world import nest
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.core import packing, planner, topology
    from repro_torch.core.plan_cache import PlanCache
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.launch import train as train_launch
    from repro_torch.launch.mesh import runtime_for_groups, survivor_mesh
    from repro_torch.models.model import Model
    from repro_torch.parallel.sharding import Runtime
    from repro_torch.runtime import CheckpointManager, elastic
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import (TrainConfig, load_state, make_train_step,
                                              state_like, state_tree, zero_bootstrap)

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=150))
    cfg = dataclasses.replace(get_config("qwen2.5-3b", smoke=True), dtype=torch.float32)
    opt_cfg = opt_lib.OptConfig(lr=LR, warmup_steps=WARMUP)
    zero = TrainConfig(comm_mode="hier_zero1", opt=opt_cfg)
    out: dict = {}

    def tree(name):
        return nest(np.load(os.path.join(out_dir, name)))

    def run_steps(model, tcfg, opt, lo, hi, rows):
        step_fn, _ = make_train_step(model, tcfg)
        losses = []
        for i in range(lo, hi):
            b = {k: torch.from_numpy(v[rows]).long()
                 for k, v in _batch(i, cfg.vocab_size).items()}
            losses.append(step_fn(opt, b)["loss"])
        return losses

    def poisoned_remap(state, old, new, **kw):
        real = packing.pack

        def boom(*a, **k):
            raise AssertionError("remap must not re-flatten (packing.pack)")

        packing.pack = boom
        try:
            return elastic.remap_zero_state(state, old, new, **kw)
        finally:
            packing.pack = real

    def zero_tensors(st):
        return opt_lib.ZeroState(*(torch.from_numpy(np.asarray(x)) for x in
                                   (st.flat_param, st.mu, st.nu)), step=int(st.step))

    try:
        ckdir = os.path.join(out_dir, "ck")
        # ---- leg A: pod failure on (2, 2, 2) -> (2, 2) ------------------------
        rt = runtime_for_groups(pods=2, data_per_pod=2, tp=2)
        model = params_from_jax(tree("params_tp2.npz"), cfg, rt, device="cpu")
        opt = zero_bootstrap(model, zero)
        rows = train_launch.dp_rows(rank, GB, 2, 2, 2)
        pre = run_steps(model, zero, opt, 0, 2, rows)
        state = state_tree(model, opt, zero)
        ckpt = CheckpointManager(os.path.join(ckdir, "A")) if rank == 0 else None
        if ckpt:
            ckpt.save(2, state)
        cache = PlanCache()
        topo = topology.tpu_multipod(2, 4)
        kw = dict(coll="reduce_scatter", pod_axis="pod", intra_axis="data",
                  compressions=(None, "bf16"), flat_mechanism="native", try_balanced=False)
        planner.plan(topo, [cfg.param_count() * 4 // 2], cache=cache, **kw)
        ctl = elastic.ElasticController(topo, [cfg.param_count() * 4 // 2], plan_cache=cache,
                                        plan_kw=kw)
        rep = ctl.report_pod_failure(2, 1)
        out["A/replan"] = np.array([cache.stats()["invalidations"], rep.invalidated_entries,
                                    int(rep.validated), ctl.topo.n_clusters])
        new_rt, new_pods = survivor_mesh(2, 2, 2, 1)
        dist.barrier()
        if new_rt is not None:
            assert new_pods == 1 and new_rt.pod_group is None
            old = elastic.zero1_master_layout(model.train_leaves(), 2)
            live = Model(cfg, new_rt, "cpu")
            load_state(live, (state[0], None), zero)
            new = elastic.zero1_master_layout(live.train_leaves(), 2)
            rem = poisoned_remap(state[1], old, new, old_world=2, new_world=2, n_columns=2)
            live_opt = load_state(live, (state[0], zero_tensors(rem)), zero)
            me = [0, 1, 2, 3].index(rank)
            srows = train_launch.dp_rows(me, GB, 1, 2, 2)
            live_losses = run_steps(live, zero, live_opt, 2, 5, srows)
            rep = ctl.resumed(2)
            # the survivor run restored from the step-2 checkpoint
            ref = Model(cfg, new_rt, "cpu").init(0)
            reader = CheckpointManager(os.path.join(ckdir, "A"))
            _, restored, _ = reader.restore(state_like(ref, train_launch._zero_like(ref, zero),
                                                       zero))
            ref_opt = load_state(ref, restored, zero)
            ref_losses = run_steps(ref, zero, ref_opt, 2, 5, srows)
            out["A/losses"] = np.array(pre + live_losses)
            out["A/ref_losses"] = np.array(pre + ref_losses)
            out["A/steps_lost"] = np.array(rep.steps_lost)
        dist.barrier()

        # ---- leg B: straggler shrink on (4,) -> (2,) ----------------------------
        g4, g2 = dist.new_group([0, 1, 2, 3]), dist.new_group([0, 1])
        if rank < 4:
            rt4 = Runtime(data_group=g4, dp_group=g4)
            model4 = params_from_jax(tree("params_tp1.npz"), cfg, rt4, device="cpu")
            opt4 = zero_bootstrap(model4, zero)
            pre_b = run_steps(model4, zero, opt4, 0, 2, slice(rank, rank + 1))
            params_b, host_b = state_tree(model4, opt4, zero)
            cache_b = PlanCache()
            topo_b = topology.tpu_multipod(1, 4)
            kw_b = dict(kw, pod_axis=None)
            planner.plan(topo_b, [cfg.param_count() * 4], cache=cache_b, **kw_b)
            ctl_b = elastic.ElasticController(
                topo_b, [cfg.param_count() * 4], plan_cache=cache_b,
                config=elastic.ElasticConfig(straggler_patience=3,
                                             on_straggler=lambda t: t.shrink_cluster(0, 2)),
                plan_kw=kw_b)
            verdicts = [ctl_b.observe_step(s, slow=True) for s in (2, 3, 4)]
            assert verdicts[:2] == [None, None] and verdicts[2].trigger == "straggler"
            lay4 = elastic.zero1_master_layout(model4.train_leaves(), 4)
            lay2 = elastic.zero1_master_layout(model4.train_leaves(), 2)
            rem_b = poisoned_remap(host_b, lay4, lay2, old_world=4, new_world=2)
            if rank == 0:
                for name in ("flat_param", "mu", "nu"):
                    out[f"B/host/{name}"] = np.asarray(getattr(host_b, name))
                    out[f"B/remap/{name}"] = getattr(rem_b, name)
                out["B/step"] = np.array(int(host_b.step))
            if rank < 2:
                rt2 = Runtime(data_group=g2, dp_group=g2)
                rows2 = slice(2 * rank, 2 * rank + 2)
                live_b = Model(cfg, rt2, "cpu")
                opt_b = load_state(live_b, (params_b, zero_tensors(rem_b)), zero)
                live_losses_b = run_steps(live_b, zero, opt_b, 2, 4, rows2)
                truth = opt_lib.ZeroState(*(_slice_repad(getattr(host_b, n), lay4, lay2, 4, 2)
                                            for n in ("flat_param", "mu", "nu")),
                                          step=host_b.step)
                ref_b = Model(cfg, rt2, "cpu")
                ref_opt_b = load_state(ref_b, (params_b, zero_tensors(truth)), zero)
                ref_losses_b = run_steps(ref_b, zero, ref_opt_b, 2, 4, rows2)
                out["B/losses"] = np.array(pre_b + live_losses_b)
                out["B/ref_losses"] = np.array(pre_b + ref_losses_b)
                out["B/within"] = np.array(ctl_b.resumed(2).within_bound)
        dist.barrier()

        # ---- check_elastic.py: (2, 2, 2) -> world of one -> (2, 2, 2) ---------
        hier = TrainConfig(comm_mode="hier", opt=opt_cfg)
        adam = opt_lib.adam_init
        mesh_model = params_from_jax(tree("params_tp2.npz"), cfg, rt, device="cpu")
        mesh_opt = adam(opt_lib.flat_params(mesh_model.train_leaves())[0])
        losses = run_steps(mesh_model, hier, mesh_opt, 0, 2, rows)
        state = state_tree(mesh_model, mesh_opt, hier)
        if rank == 0:
            ck = CheckpointManager(os.path.join(ckdir, "E"))
            ck.save(2, state)
            one = params_from_jax(tree("params_tp2.npz"), cfg, Runtime(), device="cpu")
            one_opt = adam(opt_lib.flat_params(one.train_leaves())[0])
            _, restored, _ = ck.restore(state_like(one, one_opt, hier))
            one_opt = load_state(one, restored, hier)
            losses += run_steps(one, hier, one_opt, 2, 4, slice(None))
            ck.save(4, state_tree(one, one_opt, hier))
            # the uninterrupted world of one
            fresh = params_from_jax(tree("params_tp2.npz"), cfg, Runtime(), device="cpu")
            out["E/uninterrupted"] = np.array(run_steps(
                fresh, hier, adam(opt_lib.flat_params(fresh.train_leaves())[0]), 0, 6,
                slice(None)))
        dist.barrier()
        reader = CheckpointManager(os.path.join(ckdir, "E"))
        step_e, restored, _ = reader.restore(state_like(mesh_model, mesh_opt, hier))
        mesh_opt = load_state(mesh_model, restored, hier)
        tail = run_steps(mesh_model, hier, mesh_opt, 4, 6, rows)
        if rank == 0:
            out["E/losses"] = np.array(losses + tail)
            out["E/step"] = np.array(step_e)

        # ---- the trainer: run() with every runtime knob, then resume ----------
        logs: list = []
        common = dict(smoke=True, device="cpu", seq=S, global_batch=8, pods=2,
                      mode="hier_zero1", compression="int8", ckpt_dir=os.path.join(ckdir, "T"),
                      ckpt_every=2, log=logs.append)
        res = train_launch.run(steps=8, guard=True, chaos=8, elastic=True,
                               inject_pod_failure=6, **common)
        again = train_launch.run(steps=10, resume=True, **common)
        out["T/run"] = np.array(json.dumps({k: res[k] for k in (
            "alive", "checkpoints", "losses", "guard", "chaos", "elastic", "watchdog")}
            | {"steps": [r["step"] for r in res["records"]]}))
        out["T/resume"] = np.array(json.dumps({k: again[k] for k in (
            "resumed_from", "checkpoints", "losses")}
            | {"steps": [r["step"] for r in again["records"]]}))
        out["T/logs"] = np.array(json.dumps([line for line in logs
                                             if not line.startswith("{")]))

        # ---- run(): the watchdog's rollback, the failover's fallbacks ---------
        run_cfg = get_config("qwen2.5-3b", smoke=True)
        run_opt = opt_lib.OptConfig(lr=3e-3, warmup_steps=20)      # run()'s defaults
        run_data = DataConfig(vocab_size=run_cfg.vocab_size, global_batch=8, seq_len=S)

        def run_steps_on(model, tcfg, opt, batches, rows):
            step_fn, _ = make_train_step(model, tcfg)
            return [step_fn(opt, {k: torch.from_numpy(v[rows]).long()
                                  for k, v in synth_batch(run_data, i).items()})["loss"]
                    for i in batches]

        def trainer(name, **kw):
            logs: list = []
            res = train_launch.run(smoke=True, device="cpu", seq=S, global_batch=8, pods=2,
                                   log=logs.append, **kw)
            out[f"{name}/run"] = np.array(json.dumps(
                {k: res[k] for k in ("alive", "losses", "watchdog", "checkpoints",
                                     "failover")}
                | {"steps": [r["step"] for r in res["records"]],
                   "record_losses": [r["loss"] for r in res["records"]],
                   "restores": [o["step"] for o in res["checkpoint_ops"]
                                if o["op"] == "restore"]}))
            out[f"{name}/logs"] = np.array(json.dumps([line for line in logs
                                                       if not line.startswith("{")]))
            return res

        # one bad step rolls back, and past the ninth loss every loss is a
        # spike at factor 0.5: step 8 rolls back to the step-6 checkpoint,
        # and the loop goes on from there with the stream's batches 9-12
        trainer("R", mode="hier", steps=10, ckpt_dir=os.path.join(ckdir, "R"), ckpt_every=6,
                watchdog_max_bad_steps=1, watchdog_spike_factor=0.5)
        # the same seven steps with no rollback: its step-6 checkpoint is the
        # state the rollback restores (the rolled-back run writes step 6 again)
        trainer("R7", mode="hier", steps=7, ckpt_dir=os.path.join(ckdir, "R7"), ckpt_every=6)
        hier_run = TrainConfig(comm_mode="hier", opt=run_opt)
        rt8 = runtime_for_groups(pods=2, data_per_pod=4)
        m8 = Model(run_cfg, rt8, "cpu")
        _, init8 = make_train_step(m8, hier_run)
        o8 = init8(0)
        _, restored, _ = CheckpointManager(os.path.join(ckdir, "R7")).restore(
            state_like(m8, o8, hier_run), 6)
        o8 = load_state(m8, restored, hier_run)
        out["R/expected"] = np.array(run_steps_on(m8, hier_run, o8, range(9, 13),
                                                  train_launch.dp_rows(rank, 8, 2, 4, 1)))

        # pod 1 lost before step 3 of hier_zero1 on 2 pods x 4 data: the slot
        # map as it is; with remap_shard_ops raising, the checkpoint restore
        # (the step-2 checkpoint holds the state the failure interrupted), and
        # with no checkpoint either, the optimizer re-bootstrapped
        fail = dict(mode="hier_zero1", steps=5, elastic=True, inject_pod_failure=3)
        trainer("F/slot_map", **fail)

        def not_remappable(*a, **k):
            raise ValueError("layouts not remappable")

        real_ops = packing.remap_shard_ops
        packing.remap_shard_ops = not_remappable
        try:
            trainer("F/restore", ckpt_dir=os.path.join(ckdir, "F"), ckpt_every=2, **fail)
            trainer("F/bootstrap", **fail)
        finally:
            packing.remap_shard_ops = real_ops
        zero_run = TrainConfig(comm_mode="hier_zero1", opt=run_opt)
        rt_s, _ = survivor_mesh(2, 4, 1, 1)
        if rt_s is not None:
            ms = Model(run_cfg, rt_s, "cpu").init(0)
            _, restored, _ = CheckpointManager(os.path.join(ckdir, "F")).restore(
                state_like(ms, train_launch._zero_like(ms, zero_run), zero_run), 2)
            load_state(ms, (restored[0], None), zero_run)
            out["F/expected_bootstrap"] = np.array(run_steps_on(
                ms, zero_run, zero_bootstrap(ms, zero_run), (3, 4),
                train_launch.dp_rows(rank, 8, 1, 4, 1)))
        dist.barrier()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _slice_repad(flat, old_lay, new_lay, old_world, new_world):
    """Independent ground truth of the remap (check_elastic_replan.py's):
    gather each segment from the old per-rank shards, repad to the new
    extent, re-slice per new rank."""
    old_shards = np.asarray(flat).reshape(old_world, -1)
    segs, base = {}, 0
    for s in old_lay.segments:
        per = s.padded // old_world
        segs[s.dtype] = np.concatenate([old_shards[r][base:base + per]
                                        for r in range(old_world)])
        base += per
    out = []
    for r in range(new_world):
        parts = []
        for so, sn in zip(old_lay.segments, new_lay.segments):
            buf = np.zeros(sn.padded, old_shards.dtype)
            n = min(so.padded, sn.padded)
            buf[:n] = segs[so.dtype][:n]
            per = sn.padded // new_world
            parts.append(buf[r * per:(r + 1) * per])
        out.append(np.concatenate(parts))
    return np.concatenate(out)


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
from repro.runtime import elastic as jelastic  # noqa: E402
from repro.train.optimizer import ZeroState as JZero  # noqa: E402


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    cfg = dataclasses.replace(jax_config("qwen2.5-3b", smoke=True), dtype=jnp.float32)
    for name, rt in (("tp2", JaxRuntime(tp_axis="model", tp_size=2)), ("tp1", JaxRuntime())):
        params = JaxModel(cfg, rt).init(jax.random.key(0))
        np.savez(tmp / f"params_{name}.npz", **flat_tree(jax.tree.map(np.asarray, params)))
    return run_world(__file__, tmp, ("A", "B", "E"), WORLD, _gloo_rank, WORLD)


def test_leg_a_pod_failure_resumes_bit_for_bit(results):
    want, ranks = results
    for r, got in enumerate(ranks):
        inval, entries, validated, clusters = got["A/replan"]
        assert inval == 1 and entries >= 1 and validated and clusters == 1
        if r < 4:
            np.testing.assert_array_equal(got["A/losses"], got["A/ref_losses"])
            assert int(got["A/steps_lost"]) == 0
            np.testing.assert_allclose(got["A/losses"], want["A"], rtol=0, atol=LOSS_TOL)
        else:
            assert "A/losses" not in got


def test_leg_b_remap_equals_the_references(results):
    _, ranks = results
    got = ranks[0]
    cfg = jax_config("qwen2.5-3b", smoke=True)
    model = JaxModel(dataclasses.replace(cfg, dtype=jnp.float32), JaxRuntime(dp_axis="data"))
    shapes = jax.eval_shape(model.init, jax.random.key(0))
    specs = model.param_specs(shapes)
    lay4, lay2 = (jelastic.zero1_master_layout(shapes, specs, {"data": n}) for n in (4, 2))
    host = JZero(*(got[f"B/host/{n}"] for n in ("flat_param", "mu", "nu")), got["B/step"])
    ref = jelastic.remap_zero_state(host, lay4, lay2, old_world=4, new_world=2)
    for name in ("flat_param", "mu", "nu"):
        np.testing.assert_array_equal(got[f"B/remap/{name}"], getattr(ref, name), err_msg=name)
        np.testing.assert_array_equal(got[f"B/remap/{name}"],
                                      _slice_repad(got[f"B/host/{name}"], lay4, lay2, 4, 2))


def test_leg_b_straggler_shrink_resumes_bit_for_bit(results):
    want, ranks = results
    for got in ranks[:2]:
        np.testing.assert_array_equal(got["B/losses"], got["B/ref_losses"])
        assert bool(got["B/within"])
        assert got["B/losses"][-1] < got["B/losses"][0]
        np.testing.assert_allclose(got["B/losses"], want["B"], rtol=0, atol=LOSS_TOL)
    np.testing.assert_array_equal(ranks[0]["B/losses"], ranks[1]["B/losses"])


def test_restart_across_world_sizes_lines_up(results):
    want, ranks = results
    got = ranks[0]
    assert int(got["E/step"]) == 4
    assert np.abs(got["E/losses"] - got["E/uninterrupted"]).max() < RESTART_TOL
    np.testing.assert_allclose(got["E/uninterrupted"], want["E"], rtol=0, atol=LOSS_TOL)


def test_trainer_run_with_every_runtime_knob_then_resume(results):
    _, ranks = results
    for r, got in enumerate(ranks):
        run = json.loads(str(got["T/run"]))
        again = json.loads(str(got["T/resume"]))
        logs = json.loads(str(got["T/logs"]))
        alive = r < 4
        assert run["alive"] == alive
        assert run["steps"] == (list(range(8)) if alive else list(range(6)))
        reports = {rep["trigger"]: rep for rep in run["elastic"]}
        assert reports["pod_failure"]["step_detected"] == 6
        assert run["guard"]["counts"]["transient_retry"] == 1
        assert any(line.startswith("[chaos] seed 8") for line in logs)
        assert any(line.startswith("[run] watchdog") for line in logs)
        assert any(line.startswith("[guard] schedule digest") for line in logs)
        assert any(line.startswith("[elastic] pod_failure") for line in logs)
        if alive:
            assert reports["pod_failure"]["remap_path"] == "slot_map"
            assert run["checkpoints"] == [2, 4, 6, 8]
        assert any(line == "resumed from step 8" for line in logs)
        assert again["resumed_from"] == 8 and again["steps"] == [8, 9]
        assert again["checkpoints"] == [8, 10]
        assert all(np.isfinite(again["losses"]))


def test_trainer_watchdog_rolls_back_to_the_last_checkpoint(results):
    _, ranks = results
    for got in ranks:
        run = json.loads(str(got["R/run"]))
        plain = json.loads(str(got["R7/run"]))
        logs = json.loads(str(got["R/logs"]))
        assert run["steps"] == list(range(9)) + list(range(6, 10))
        assert [tuple(v) for v in run["watchdog"] if v[1] != "ok"] == [(8, "rollback")]
        assert run["restores"] == [6]
        assert "[health] non-finite/spiking loss -> rolled back to 6" in logs
        assert run["checkpoints"] == [6, 6, 10]
        assert plain["watchdog"] == [[s, "ok"] for s in range(7)]
        # up to the rollback the run is the plain one, after it the steps
        # from the restored checkpoint on the stream's next batches
        assert run["record_losses"][:7] == plain["record_losses"]
        np.testing.assert_array_equal(run["record_losses"][9:], got["R/expected"])
        assert run["losses"] == run["record_losses"][:8] + run["record_losses"][9:]
    assert len({json.loads(str(got["R/run"]))["losses"][-1] for got in ranks}) == 1


def test_trainer_failover_falls_back_to_restore_then_rebootstrap(results):
    _, ranks = results
    fallback = "[elastic] slot-map remap not applicable (layouts not remappable); " \
               "falling back to checkpoint restore"
    bootstrap = "[elastic] re-bootstrapping the optimizer from the resharded params " \
                "(moments reset)"
    for r, got in enumerate(ranks):
        runs = {k: json.loads(str(got[f"F/{k}/run"]))
                for k in ("slot_map", "restore", "bootstrap")}
        logs = {k: json.loads(str(got[f"F/{k}/logs"])) for k in runs}
        for k, run in runs.items():
            assert run["alive"] == (r < 4), k
            assert run["steps"] == (list(range(5)) if r < 4 else [0, 1, 2]), k
            assert any(line.startswith("[elastic] pod_failure") for line in logs[k]), k
        if r >= 4:
            continue
        assert runs["slot_map"]["failover"]["remap_path"] == "slot_map"
        assert fallback not in logs["slot_map"]
        assert runs["restore"]["failover"]["remap_path"] == "restore_fallback"
        assert fallback in logs["restore"] and bootstrap not in logs["restore"]
        assert runs["restore"]["restores"] == [2]
        np.testing.assert_array_equal(runs["restore"]["losses"], runs["slot_map"]["losses"])
        assert runs["bootstrap"]["failover"]["remap_path"] == "restore_fallback"
        assert fallback in logs["bootstrap"] and bootstrap in logs["bootstrap"]
        assert runs["bootstrap"]["restores"] == []
        assert runs["bootstrap"]["losses"][:3] == runs["slot_map"]["losses"][:3]
        np.testing.assert_array_equal(runs["bootstrap"]["losses"][3:],
                                      got["F/expected_bootstrap"])
        assert runs["bootstrap"]["losses"][3:] != runs["slot_map"]["losses"][3:]
