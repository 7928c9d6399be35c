"""The port's runtime (``src/repro_torch/runtime/``) against the JAX
package's, on their host-side cores.

* The parts that import no JAX are verbatim copies: ``health.py`` whole,
  the plan, the events and the injector's host seams of ``faults.py``,
  the detectors of ``guard.py``, the controller and the remap of
  ``elastic.py``, the publish and recovery of ``checkpoint.py``, the
  shard-remap ops of ``core/packing.py`` and ``data.Prefetcher``: each
  definition's text equals the reference's (its ``repro.core`` imports
  read as ``repro_torch.core``).
* Analogs of ``tests/test_runtime.py``, ``test_faults.py``,
  ``test_guard.py`` and ``test_elastic.py``, case for case, on the port.
* Shared outputs equal the reference's: the same seed gives the same
  ``FaultPlan``, the same tree the same ``payload_checksum``, the same
  schedule the same ``schedule_digest`` (a ``CommConfig`` per mode, a
  plan, its ``BoundPlan`` and a ``Schedule``), the same layouts the same
  ``remap_shard_ops`` and ``remap_zero_state``, and a checkpoint of a
  dict of arrays (bf16 among them) written by either package reads back
  bit-equal in the other.
* The corruption bodies on tensors against the reference's on arrays:
  NaN and bit flip in f32, bf16, int8 and int32 and on the ``(q, scale)``
  pair, bit-equal; NaN on an int8 buffer is a no-op in both (ROADMAP
  R19), and a NaN on the int8 wire of a sync decodes to the same finite
  block in both (R20).
* The pod-less pipelined sync passes its payload through the ``"flat"``
  seam, as the reference's does (its repair).
"""

import ast
import dataclasses
import pathlib
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _hypothesis_compat import hypothesis, st
from repro.configs import get_config as jax_config
from repro.core import collectives as jcoll
from repro.core import packing as jpacking
from repro.core import planner as jplanner
from repro.core import primitives as jprim
from repro.core import topology as jtopo
from repro.core.plan_cache import PlanCache as JPlanCache
from repro.core.schedule import build_schedule as jbuild
from repro.models import Model as JaxModel
from repro.parallel.sharding import Runtime as JaxRuntime
from repro.parallel.sharding import shard_map
from repro.runtime import checkpoint as jckpt
from repro.runtime import elastic as jelastic
from repro.runtime import faults as jfaults
from repro.runtime import guard as jguard
from repro.train.optimizer import ZeroState as JZeroState
from repro_torch import runtime as trt
from repro_torch.configs import get_config
from repro_torch.core import collectives as tcoll
from repro_torch.core import packing, planner, primitives, topology
from repro_torch.core.collectives import CommConfig
from repro_torch.core.plan_cache import PlanCache
from repro_torch.core.schedule import build_schedule
from repro_torch.data.pipeline import DataConfig, Prefetcher, synth_batch
from repro_torch.models.model import Model
from repro_torch.runtime import checkpoint as ckpt_mod
from repro_torch.runtime import elastic, faults
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.faults import (FaultEvent, FaultInjector, FaultPlan,
                                        TransientTransferError, corrupt_bitflip, corrupt_nan)
from repro_torch.runtime.guard import (CollectiveGuard, GuardConfig, LinkHealth,
                                       PersistentCommFailure, digest_agreement,
                                       nonfinite_leaves, payload_checksum, schedule_digest)
from repro_torch.runtime.health import NaNWatchdog, StragglerMonitor, WatchdogConfig
from repro_torch.train.optimizer import ZeroState

given, settings = hypothesis.given, hypothesis.settings
ROOT = pathlib.Path(__file__).resolve().parent.parent
REF, PORT = ROOT / "src/repro", ROOT / "src/repro_torch"


# ---------------------------------------------------------------------------
# Verbatim copies
# ---------------------------------------------------------------------------

def _defs(path: pathlib.Path) -> dict[str, str]:
    """Source text of each top-level definition and each method
    ("Class.method") of a module."""
    text = path.read_text()
    out = {}
    for node in ast.parse(text).body:
        if isinstance(node, (ast.ClassDef, ast.FunctionDef)):
            out[node.name] = ast.get_source_segment(text, node)
        if isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef):
                    out[f"{node.name}.{sub.name}"] = ast.get_source_segment(text, sub)
    return out


VERBATIM = {
    "core/packing.py": ("ShardRemapOp", "remap_shard_ops", "apply_remap_ops"),
    "data/pipeline.py": ("Prefetcher",),
    "runtime/faults.py": (
        "TransientTransferError", "FaultEvent", "FaultPlan", "FaultInjector.__init__",
        "FaultInjector._log", "FaultInjector.sleep_s", "FaultInjector.stall",
        "FaultInjector.hung_ranks", "FaultInjector.transient_attempts",
        "FaultInjector.wrap_transfer", "FaultInjector.perturb_transfer_time",
        "FaultInjector.summary"),
    "runtime/guard.py": ("PersistentCommFailure", "digest_agreement", "LinkHealth",
                         "GuardConfig", "GuardEvent", "CollectiveGuard"),
    "runtime/elastic.py": ("fingerprint_digest", "_layout_of", "remap_flat", "ElasticConfig",
                           "ReplanReport", "ElasticController"),
    "runtime/checkpoint.py": ("_crashpoint", "_fsync_file", "_fsync_dir",
                              "CheckpointManager.__init__", "CheckpointManager._recover",
                              "CheckpointManager.wait", "CheckpointManager._gc",
                              "CheckpointManager.steps", "CheckpointManager.latest_step"),
}


def test_health_is_a_verbatim_copy():
    assert (PORT / "runtime/health.py").read_text() == (REF / "runtime/health.py").read_text()


@pytest.mark.parametrize("module", sorted(VERBATIM))
def test_runtime_definitions_are_verbatim_copies(module):
    ref, port = _defs(REF / module), _defs(PORT / module)
    for name in VERBATIM[module]:
        assert port[name] == ref[name].replace("from repro.core", "from repro_torch.core"), name


def test_runtime_exports_what_the_reference_exports():
    import repro.runtime as jrt
    names = {n for n in dir(jrt) if not n.startswith("_")} - {
        "checkpoint", "elastic", "faults", "guard", "health"}
    assert names <= set(dir(trt))


# ---------------------------------------------------------------------------
# Checkpointing (analogs of tests/test_runtime.py)
# ---------------------------------------------------------------------------

def _tree():
    return {"w": torch.arange(12.0).reshape(3, 4),
            "b": {"x": torch.ones((5,), dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _flat(t):
    return trt.tree.leaves(t)


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path)
    t = _tree()
    mgr.save(10, t, extra={"note": "hi"})
    step, back, extra = mgr.restore(t)
    assert step == 10 and extra["note"] == "hi"
    for a, b in zip(_flat(t), _flat(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_async_and_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    t = _tree()
    for s in (1, 2, 3, 4):
        mgr.save_async(s, {k: v + s for k, v in t.items() if k != "b"} | {"b": t["b"]})
    mgr.wait()
    assert mgr.steps() == [3, 4]
    step, back, _ = mgr.restore(t)
    assert step == 4
    torch.testing.assert_close(back["w"], t["w"] + 4)


def test_checkpoint_atomicity_ignores_partial(tmp_path):
    mgr = CheckpointManager(tmp_path)
    t = _tree()
    mgr.save(5, t)
    (tmp_path / "step_9.tmp").mkdir()
    (tmp_path / "step_7").mkdir()  # no manifest -> invalid
    assert mgr.latest_step() == 5
    step, _, _ = mgr.restore(t)
    assert step == 5


def test_checkpoint_elastic_restore_resharding(tmp_path):
    """Restore onto explicit placements: a device, and a function that
    keeps this rank's slice (rows 1:3 of w)."""
    mgr = CheckpointManager(tmp_path)
    t = _tree()
    mgr.save(1, t)
    cpu = torch.device("cpu")
    sh = {"w": lambda g: g[1:3], "b": {"x": cpu}, "step": cpu}
    step, back, _ = mgr.restore(t, shardings=sh)
    assert step == 1
    assert torch.equal(back["w"], t["w"][1:3]) and back["b"]["x"].device == cpu


def test_checkpoint_restore_into_meta_like(tmp_path):
    """A ``like`` of meta tensors (shape and dtype only) restores the
    values in its dtypes."""
    mgr = CheckpointManager(tmp_path)
    t = _tree()
    mgr.save(3, t)
    like = trt.tree.tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), t)
    _, back, _ = mgr.restore(like)
    for a, b in zip(_flat(t), _flat(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_crash_between_renames_recovers(tmp_path):
    mgr = CheckpointManager(tmp_path)
    t = _tree()
    mgr.save(5, t, extra={"gen": 1})

    def boom(tag):
        raise RuntimeError(f"injected crash at {tag}")

    ckpt_mod._CRASH_HOOK = boom
    try:
        with pytest.raises(RuntimeError, match="injected crash"):
            mgr.save(5, trt.tree.tree_map(lambda x: x * 0, t), extra={"gen": 2})
    finally:
        ckpt_mod._CRASH_HOOK = None
    assert not (tmp_path / "step_5").exists()
    assert list(tmp_path.glob("step_5.old.*"))
    mgr2 = CheckpointManager(tmp_path)   # runs _recover()
    assert mgr2.steps() == [5]
    step, back, extra = mgr2.restore(t)
    assert step == 5 and extra["gen"] == 1
    assert torch.equal(back["w"], t["w"])
    assert not list(tmp_path.glob("step_*.old.*"))


def test_checkpoint_crash_on_first_publish_keeps_older_step(tmp_path):
    mgr = CheckpointManager(tmp_path)
    t = _tree()
    mgr.save(1, t)
    ckpt_mod._CRASH_HOOK = lambda tag: (_ for _ in ()).throw(OSError("kill"))
    try:
        with pytest.raises(OSError):
            mgr.save(2, t)
    finally:
        ckpt_mod._CRASH_HOOK = None
    assert mgr.steps() == [1]
    assert CheckpointManager(tmp_path).steps() == [1]


def test_checkpoint_restore_names_mismatch_is_clear(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"w": torch.ones((2,)), "b": torch.zeros((3,))})
    with pytest.raises(ValueError) as ei:
        mgr.restore({"w": torch.ones((2,)), "scale": torch.zeros((3,))})
    msg = str(ei.value)
    assert "scale" in msg and "b" in msg and "does not match" in msg


def test_checkpoint_bf16_restore_to_new_sharding(tmp_path):
    mgr = CheckpointManager(tmp_path)
    vals = torch.arange(16, dtype=torch.float32).to(torch.bfloat16)
    t = {"p": vals, "s": torch.tensor(3.0)}
    mgr.save(2, t)
    step, back, _ = mgr.restore(t, shardings={"p": lambda g: g[8:], "s": torch.device("cpu")})
    assert step == 2 and back["p"].dtype == torch.bfloat16
    assert torch.equal(back["p"].view(torch.int16), vals[8:].view(torch.int16))


def _np_tree():
    rng = np.random.default_rng(4)
    return {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"x": rng.standard_normal(5).astype(ml_dtypes.bfloat16),
                  "q": np.arange(-3, 3, dtype=np.int8)},
            "step": np.int32(7)}


def test_checkpoint_written_by_the_reference_reads_back_in_the_port(tmp_path):
    t = _np_tree()
    jckpt.CheckpointManager(tmp_path).save(4, jax.tree.map(jnp.asarray, t), extra={"k": 1})
    like = {"w": torch.empty((3, 4)), "b": {"x": torch.empty(5, dtype=torch.bfloat16),
                                             "q": torch.empty(6, dtype=torch.int8)},
            "step": torch.empty((), dtype=torch.int32)}
    step, back, extra = CheckpointManager(tmp_path).restore(like)
    assert (step, extra) == (4, {"k": 1})
    np.testing.assert_array_equal(back["w"].numpy(), t["w"])
    np.testing.assert_array_equal(back["b"]["x"].view(torch.int16).numpy().view(np.uint16),
                                  t["b"]["x"].view(np.uint16))
    np.testing.assert_array_equal(back["b"]["q"].numpy(), t["b"]["q"])
    assert int(back["step"]) == 7


def test_checkpoint_written_by_the_port_reads_back_in_the_reference(tmp_path):
    t = _np_tree()
    CheckpointManager(tmp_path).save(4, t, extra={"k": 1})
    step, back, extra = jckpt.CheckpointManager(tmp_path).restore(jax.tree.map(jnp.asarray, t))
    assert (step, extra) == (4, {"k": 1})
    assert back["b"]["x"].dtype == jnp.bfloat16
    for a, b in zip(jax.tree.leaves(t), jax.tree.leaves(back)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    # a bf16 tensor writes the same words as the ml_dtypes array
    words = torch.from_numpy(t["b"]["x"].view(np.uint16).view(np.int16)).view(torch.bfloat16)
    CheckpointManager(tmp_path / "t").save(1, {"x": words})
    _, back, _ = jckpt.CheckpointManager(tmp_path / "t").restore(
        {"x": jnp.asarray(t["b"]["x"])})
    assert np.asarray(back["x"]).tobytes() == t["b"]["x"].tobytes()


# ---------------------------------------------------------------------------
# Data and health
# ---------------------------------------------------------------------------

def test_data_determinism_and_host_sharding():
    base = DataConfig(vocab_size=100, global_batch=8, seq_len=16, seed=3)
    full = synth_batch(base, step=5)
    parts = [synth_batch(DataConfig(vocab_size=100, global_batch=8, seq_len=16, seed=3,
                                    n_hosts=4, host_id=h), step=5) for h in range(4)]
    np.testing.assert_array_equal(full["tokens"], synth_batch(base, step=5)["tokens"])
    assert len({p["tokens"].tobytes() for p in parts}) == 4
    np.testing.assert_array_equal(full["tokens"][:, 1:], full["labels"][:, :-1])


def test_prefetcher_straggler_skip():
    pre = Prefetcher(DataConfig(vocab_size=50, global_batch=2, seq_len=8, prefetch=1),
                     inject_delay_s=0.4)
    try:
        sid, batch = pre.get(timeout=0.05)   # too short -> logs a skip
        assert pre.skipped, "bounded-wait should have recorded a skip"
        assert batch["tokens"].shape == (2, 8)
    finally:
        pre.close()


def test_prefetcher_stream_is_synth_batch():
    cfg = DataConfig(vocab_size=50, global_batch=2, seq_len=8)
    pre = Prefetcher(cfg, start_step=3)
    try:
        for want in (3, 4):
            sid, batch = pre.get(timeout=5.0)
            assert sid == want
            np.testing.assert_array_equal(batch["tokens"], synth_batch(cfg, want)["tokens"])
    finally:
        pre.close()


def test_watchdog_rollback_on_nans():
    wd = NaNWatchdog(WatchdogConfig(max_bad_steps=2))
    assert wd.observe(1.0) == "ok"
    assert wd.observe(float("nan")) == "skip"
    assert wd.observe(float("inf")) == "rollback"
    assert wd.observe(1.0) == "ok"


def test_watchdog_spike_detection():
    wd = NaNWatchdog(WatchdogConfig(max_bad_steps=1, loss_spike_factor=5.0))
    for _ in range(10):
        assert wd.observe(1.0) == "ok"
    assert wd.observe(50.0) == "rollback"


def test_watchdog_rollback_clears_history():
    wd = NaNWatchdog(WatchdogConfig(max_bad_steps=3))
    for loss in (100, 50, 20, 10, 5, 2, 1, 0.5, 0.2, 0.1):
        assert wd.observe(float(loss)) == "ok"
    assert [wd.observe(float("nan")) for _ in range(3)] == ["skip", "skip", "rollback"]
    assert wd.history == [] and wd.bad_streak == 0
    assert wd.observe(100.0) == "ok"


def test_watchdog_spike_rollback_resets_streak():
    wd = NaNWatchdog(WatchdogConfig(max_bad_steps=2, loss_spike_factor=5.0))
    for _ in range(10):
        assert wd.observe(1.0) == "ok"
    assert wd.observe(50.0) == "skip"
    assert wd.observe(60.0) == "rollback"
    assert wd.history == [] and wd.bad_streak == 0
    assert wd.observe(1.0) == "ok"


def test_straggler_monitor_flags_slow_steps():
    mon = StragglerMonitor(factor=5.0)
    for _ in range(8):
        mon.start()
        time.sleep(0.01)
        assert not mon.stop()
    mon.start()
    time.sleep(0.2)
    assert mon.stop() and mon.flagged


def test_straggler_monitor_synthetic_skewed_trace():
    mon = StragglerMonitor(factor=3.0)
    for _ in range(8):
        assert not mon.observe(0.1)
    assert mon.observe(0.4)
    assert not mon.observe(0.1)
    assert mon.flagged == [8]
    steady = StragglerMonitor(factor=3.0)
    for _ in range(12):
        steady.observe(0.4)
    assert steady.flagged == []


def test_straggler_stop_without_start_and_reset():
    mon = StragglerMonitor()
    assert mon.stop() is False and mon.times == []
    mon = StragglerMonitor(factor=3.0)
    for _ in range(8):
        mon.observe(0.1)
    assert mon.observe(0.4) and mon.flagged
    mon.start()
    mon.reset()
    assert mon.times == [] and mon.flagged == [] and mon.stop() is False
    before = mon._step
    mon.observe(0.1)
    assert mon._step == before + 1


def test_straggler_ignores_bad_durations():
    mon = StragglerMonitor(factor=3.0)
    for _ in range(6):
        assert not mon.observe(0.1)
    for bad in (float("nan"), float("inf"), 0.0, -0.5):
        assert mon.observe(bad) is False
    assert mon.times == [0.1] * 6
    assert mon.observe(1.0) and mon.flagged == [10]
    mon2 = StragglerMonitor(factor=3.0)
    mon2._t0 = time.monotonic() + 100.0
    assert mon2.stop() is False and mon2.times == []


# ---------------------------------------------------------------------------
# The chaos engine (analogs of tests/test_faults.py)
# ---------------------------------------------------------------------------

@settings(max_examples=25, deadline=None)
@given(st.integers(0, 1 << 16), st.integers(8, 64))
def test_fault_plan_is_deterministic_and_the_references(seed, n_steps):
    a = FaultPlan.generate(seed, n_steps)
    assert a == FaultPlan.generate(seed, n_steps)
    steps = [e.step for e in a.events]
    assert len(set(steps)) == len(steps) == len(faults.FAULT_KINDS)
    assert all(1 <= s < n_steps for s in steps)
    ref = jfaults.FaultPlan.generate(seed, n_steps, n_clusters=3, n_ranks=5)
    assert FaultPlan.generate(seed, n_steps, n_clusters=3, n_ranks=5).summary() == ref.summary()


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 1 << 16))
def test_injector_replay_is_identical(seed):
    plan = FaultPlan.generate(seed, 24)
    runs = []
    for _ in range(2):
        inj = FaultInjector(plan)
        seq = [(inj.sleep_s(s, 1.0), inj.transient_attempts(s), plan.link_factors(s),
                inj.hung_ranks(s)) for s in range(24)]
        runs.append((seq, inj.injected))
    assert runs[0] == runs[1]


def test_fault_event_validation():
    for bad in (lambda: FaultEvent("solar_flare", 3), lambda: FaultEvent("hang", -1),
                lambda: FaultEvent("hang", 3, duration=0), lambda: FaultPlan.generate(0, 3),
                lambda: FaultPlan.generate(0, 64, classes=("hang", "gamma_ray"))):
        with pytest.raises(ValueError):
            bad()


def test_event_windows_and_degraded_persistence():
    plan = FaultPlan.generate(11, 30)
    deg = next(e for e in plan.events if e.kind == "degraded_link")
    assert deg.step + deg.duration == 30
    assert plan.link_factors(deg.step - 1) == {}
    assert plan.link_factors(29).get(deg.cluster) == deg.factor
    assert plan.link_scale(29)[deg.cluster] == pytest.approx(1 / deg.factor)
    assert deg in plan.events_at(deg.step) and plan.starting_at(deg.step) == (deg,)
    hang = next(e for e in plan.events if e.kind == "hang")
    assert hang.active_at(hang.step) and not hang.active_at(hang.step + 1)


def test_degrade_topology_changes_fingerprint():
    topo = topology.tpu_multipod(2, 8)
    plan = FaultPlan.generate(5, 16)
    deg = next(e for e in plan.events if e.kind == "degraded_link")
    d = plan.degrade_topology(topo, deg.step)
    assert d.fingerprint() != topo.fingerprint()
    assert d.clusters[deg.cluster].nic_Bps == pytest.approx(
        topo.clusters[deg.cluster].nic_Bps / deg.factor)
    assert plan.degrade_topology(topo, 0).fingerprint() == topo.fingerprint()
    ref = jfaults.FaultPlan.generate(5, 16).degrade_topology(jtopo.tpu_multipod(2, 8), deg.step)
    assert d.fingerprint() == ref.fingerprint()


def _wire(dtype, n=8):
    rng = np.random.default_rng(7)
    if dtype in (np.int8, np.int32):
        return rng.integers(-100, 100, n).astype(dtype)
    return rng.standard_normal(n).astype(dtype)


def _as_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bytes(t):
    if isinstance(t, torch.Tensor):
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
    return np.asarray(t).tobytes()


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16, np.int8, np.int32],
                         ids=["f32", "bf16", "int8", "int32"])
@pytest.mark.parametrize("kind", ["nan_payload", "bitflip"])
def test_corruption_matches_the_reference(kind, dtype):
    """The port's corruption of a tensor is bit-equal to the reference's
    of the same array; the flip changes one bit of element 0, and NaN
    leaves an integer buffer as it is (R19)."""
    a = _wire(dtype)
    got = faults._corrupt_payload(_as_torch(a), kind)
    want = np.asarray(jfaults._corrupt_payload(jnp.asarray(a), kind))
    assert _bytes(got) == want.tobytes()
    diff = np.frombuffer(_bytes(got), np.uint8) ^ np.frombuffer(a.tobytes(), np.uint8)
    if kind == "bitflip":
        assert sum(bin(int(d)).count("1") for d in diff) == 1
        assert not diff[a.itemsize:].any()
    elif dtype in (np.int8, np.int32):
        assert not diff.any()                       # R19: NaN on an integer wire
    else:
        assert torch.isnan(got[0].float()) and not diff[a.itemsize:].any()


@pytest.mark.parametrize("kind", ["nan_payload", "bitflip"])
def test_corruption_of_the_int8_pair_hits_q(kind):
    q = np.arange(-8, 8, dtype=np.int8).reshape(2, 8)
    scale = np.array([0.5, 2.0], np.float32)
    got = faults._corrupt_payload((torch.from_numpy(q.copy()), torch.from_numpy(scale)), kind)
    want = jfaults._corrupt_payload((jnp.asarray(q), jnp.asarray(scale)), kind)
    assert _bytes(got[0]) == np.asarray(want[0]).tobytes()
    assert torch.equal(got[1], torch.from_numpy(scale))
    assert (kind == "bitflip") == (not np.array_equal(got[0].numpy(), q))


def test_corrupt_nan_and_bitflip_leave_the_input():
    x = torch.arange(8.0) + 1
    y = corrupt_nan(x)
    assert not torch.isfinite(y[0]) and torch.isfinite(y[1:]).all() and torch.isfinite(x).all()
    z = corrupt_bitflip(x)
    assert not torch.equal(z, x) and torch.equal(x, torch.arange(8.0) + 1)


def test_hang_stalls_past_deadline():
    plan = FaultPlan.generate(4, 20)
    h = next(e for e in plan.events if e.kind == "hang")
    inj = FaultInjector(plan)
    assert inj.sleep_s(h.step, 0.1) == pytest.approx(h.factor * 0.1)
    assert inj.sleep_s(0, 0.1) == 0.0
    assert inj.hung_ranks(h.step) == (h.rank,) and inj.hung_ranks(0) == ()


def test_wrap_transfer_fails_then_succeeds():
    plan = FaultPlan.generate(2, 20)
    t = next(e for e in plan.events if e.kind == "transient")
    inj = FaultInjector(plan)
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        return "ok"

    wrapped = inj.wrap_transfer(t.step, fn)
    with pytest.raises(TransientTransferError):
        wrapped()
    assert wrapped() == "ok" and calls["n"] == 1
    assert inj.wrap_transfer(0, fn)() == "ok"
    assert any(i["kind"] == "transient" for i in inj.injected)


def test_perturb_transfer_time_inflates_degraded_cluster_only():
    plan = FaultPlan.generate(11, 30)
    deg = next(e for e in plan.events if e.kind == "degraded_link")
    inj = FaultInjector(plan)
    other = 1 - deg.cluster if deg.cluster in (0, 1) else 0
    assert inj.perturb_transfer_time(deg.step, deg.cluster, 0.5) == pytest.approx(
        0.5 * deg.factor)
    assert inj.perturb_transfer_time(deg.step, other, 0.5) == pytest.approx(0.5)
    assert inj.perturb_transfer_time(0, deg.cluster, 0.5) == pytest.approx(0.5)


def test_corruption_hook_phases_and_one_shot():
    plan = FaultPlan(seed=0, events=(FaultEvent("bitflip", 3, rank=0),))
    inj = FaultInjector(plan, corrupt_phases=("c2c",))
    hook = inj.corruption_hook(3)
    x = torch.arange(4.0) + 1
    assert torch.equal(hook(x, "intra_rs"), x)
    assert not torch.equal(hook(x, "c2c"), x)
    assert torch.equal(hook(x, "c2c"), x)
    assert inj.corruption_hook(2) is None


def test_corruption_hook_is_gated_to_the_events_rank():
    """Only the planned rank corrupts; every rank logs and spends the
    event alike."""
    plan = FaultPlan(seed=0, events=(FaultEvent("bitflip", 3, rank=2),))
    x = torch.arange(4.0) + 1
    outs = []
    for rank in range(4):
        inj = FaultInjector(plan)
        hook = inj.corruption_hook(3, rank=rank)
        outs.append(hook(x, "c2c"))
        assert torch.equal(hook(x, "c2c"), x) and len(inj.injected) == 1
    assert [not torch.equal(o, x) for o in outs] == [False, False, True, False]


def test_inject_hook_nests_and_restores():
    assert primitives.apply_inject(1, "c2c") == 1
    with primitives.inject_hook(lambda b, p: b + 1):
        assert primitives.apply_inject(1, "c2c") == 2
        with primitives.inject_hook(lambda b, p: b + 10):
            assert primitives.apply_inject(1, "c2c") == 11
        assert primitives.apply_inject(1, "c2c") == 2
    assert primitives.apply_inject(1, "c2c") == 1


# ---------------------------------------------------------------------------
# The collective guard (analogs of tests/test_guard.py)
# ---------------------------------------------------------------------------

PLAN_KW = dict(coll="all_reduce", pod_axis="pod", intra_axis="data",
               compressions=(None, "bf16"), flat_mechanism="native", try_balanced=False)
SIZES = (8 << 20, 12 << 20, 16 << 20, 24 << 20)


def test_deadline_calibration_and_hang_attribution():
    g = CollectiveGuard(GuardConfig(warmup_steps=3, min_deadline_s=0.0, deadline_margin=2.0))
    assert g.deadline_s is None and g.observe_step_time(0, 99.0) is None
    g = CollectiveGuard(GuardConfig(warmup_steps=3, min_deadline_s=0.0, deadline_margin=2.0))
    for s in range(3):
        assert g.observe_step_time(s, 0.1) is None
    assert g.deadline_s == pytest.approx(0.2)
    g2 = CollectiveGuard(GuardConfig(warmup_steps=3, min_deadline_s=0.0, deadline_margin=2.0),
                         predicted_step_s=1.0)
    assert g2.deadline_s is None
    for s in range(3):
        g2.observe_step_time(s, 0.1)
    assert g2.deadline_s == pytest.approx(2.0)
    g3 = CollectiveGuard(GuardConfig(warmup_steps=1, min_deadline_s=0.0, deadline_margin=2.0),
                         expected_ranks=range(4))
    g3.observe_step_time(0, 0.1)
    for r in (0, 1, 3):
        g3.heartbeat(5, r)
    ev = g3.observe_step_time(5, 1.0)
    assert ev.kind == "hang" and ev.attribution == "rank 2" and ev.measured == 1.0
    assert g3.observe_step_time(6, 0.1) is None


def test_no_false_positive_on_steady_steps():
    g = CollectiveGuard(GuardConfig(warmup_steps=5, min_deadline_s=0.05))
    assert all(g.observe_step_time(s, 0.01 + 0.001 * (s % 3)) is None for s in range(50))
    assert g.observe_step_time(50, float("nan")) is None
    assert g.observe_step_time(51, -1.0) is None


def _configs():
    """Each mode's CommConfig in both packages, with and without a pod
    axis (the port's pod group any group; the digest only asks whether
    there is one)."""
    pod = object()
    out = []
    for mode in ("flat", "hier", "hier_pipelined", "hier_border_rs"):
        for pods in (True, False):
            for comp, chunks, w in ((None, 4, None), ("int8", 8, None), ("bf16", 4, (1.25, 0.75))):
                out.append((CommConfig(mode=mode, pod_group=pod if pods else None,
                                       n_chunks=chunks, compression=comp, cluster_weights=w),
                            jcoll.CommConfig(mode=mode, pod_axis="pod" if pods else None,
                                             intra_axis="data", n_chunks=chunks,
                                             compression=comp, cluster_weights=w)))
    return out


def test_schedule_digest_equals_the_references():
    for port, ref in _configs():
        assert schedule_digest(port) == jguard.schedule_digest(ref), port
    for mode in ("hier", "hier_pipelined", "hier_border_rs", "flat"):
        assert schedule_digest(build_schedule("all_reduce", mode, 4, None)) == \
            jguard.schedule_digest(jbuild("all_reduce", mode, 4, None))
    topo, jt = topology.tpu_multipod(2, 8), jtopo.tpu_multipod(2, 8)
    p = planner.plan(topo, [64 << 20, 3 << 20], cache=PlanCache(), **PLAN_KW)
    jp = jplanner.plan(jt, [64 << 20, 3 << 20], cache=JPlanCache(), **PLAN_KW)
    assert schedule_digest(p) == jguard.schedule_digest(jp)
    bound = planner.BoundPlan(p, object(), None, None)
    assert schedule_digest(bound) == schedule_digest(p)
    assert len({schedule_digest(c) for c, _ in _configs()}) == len(_configs())
    with pytest.raises(TypeError):
        schedule_digest(object())


def test_schedule_digest_ignores_timing_floats():
    topo = topology.tpu_multipod(2, 8)
    p1 = planner.plan(topo, [64 << 20], cache=PlanCache(), **PLAN_KW)
    b = p1.buckets[0]
    p3 = dataclasses.replace(p1, buckets=(dataclasses.replace(
        b, simulated_c2c_s=(b.simulated_c2c_s or 0.0) * 7 + 1.0),) + p1.buckets[1:])
    assert schedule_digest(p3) == schedule_digest(p1)


def test_digest_agreement_and_desync_event():
    ok, major, out = digest_agreement({0: "a", 1: "a", 2: "a", 3: "b"})
    assert not ok and major == "a" and out == (3,)
    assert digest_agreement({r: "a" for r in range(8)}) == (True, "a", ())
    ok, major, out = digest_agreement({0: "a", 1: "b", 2: "a", 3: "b"})
    assert not ok and len(out) == 2
    with pytest.raises(ValueError):
        digest_agreement({})
    g = CollectiveGuard(expected_ranks=range(4))
    assert g.check_agreement(3, {r: "x" for r in range(4)}) is None
    ev = g.check_agreement(4, {0: "x", 1: "x", 2: "y", 3: "x"})
    assert ev.kind == "desync" and ev.attribution == "rank 2"


def test_payload_checksum_equals_the_references():
    rng = np.random.default_rng(2)
    t = {"w": rng.standard_normal(16).astype(np.float32),
         "b": np.arange(4, dtype=np.int8),
         "h": {"bf": rng.standard_normal(6).astype(ml_dtypes.bfloat16),
               "l": [np.float32(1.5), rng.standard_normal(3).astype(np.float32)]}}
    ref = jguard.payload_checksum(jax.tree.map(jnp.asarray, t))
    assert payload_checksum(trt.tree.tree_map(_as_torch_leaf, t)) == ref
    assert payload_checksum(t) == ref
    flipped = dict(t, w=corrupt_bitflip(torch.from_numpy(t["w"].copy())).numpy())
    assert payload_checksum(flipped) != ref
    zero = {"w": torch.zeros(16)}
    assert payload_checksum({"w": corrupt_bitflip(zero["w"])}) != payload_checksum(zero)


def _as_torch_leaf(a):
    return _as_torch(np.asarray(a)) if np.ndim(a) else np.asarray(a)


def test_check_payload_flags_nonfinite_leaves():
    g = CollectiveGuard()
    clean = {"a": torch.ones(4), "q": torch.ones(2, dtype=torch.int8)}
    assert g.check_payload(1, clean) is None and g.checksum_at(1) is not None
    bad = {"a": torch.tensor([1.0, float("nan"), 3.0]), "q": torch.ones(2, dtype=torch.int8),
           "grad_norm": np.float32("nan")}
    ev = g.check_payload(2, bad)
    assert ev.kind == "corrupt_payload" and ev.attribution == "2 leaves"
    assert nonfinite_leaves(bad) == jguard.nonfinite_leaves(
        {"a": jnp.asarray([1.0, np.nan, 3.0]), "q": jnp.ones(2, jnp.int8),
         "grad_norm": jnp.float32(np.nan)})
    assert nonfinite_leaves(clean) == ()


def _failing(times, error=TransientTransferError):
    n = {"left": times}

    def fn():
        if n["left"]:
            n["left"] -= 1
            raise error("injected")
        return "payload"
    return fn


def test_retry_absorbs_transients_and_exhaustion_raises():
    logs = []
    for _ in range(2):
        g = CollectiveGuard(GuardConfig(max_retries=3, backoff_base_s=0.01, seed=5))
        slept = []
        assert g.retry(1, _failing(2), sleep=slept.append) == "payload"
        assert g.events[-1].kind == "transient_retry" and g.events[-1].measured == 2.0
        logs.append(slept)
    assert logs[0] == logs[1] and len(logs[0]) == 2 and logs[0][1] > logs[0][0]
    jg = jguard.CollectiveGuard(jguard.GuardConfig(max_retries=3, backoff_base_s=0.01, seed=5))
    jslept = []
    jg.retry(1, _failing(2, jfaults.TransientTransferError), sleep=jslept.append)
    assert jslept == logs[0]
    g = CollectiveGuard(GuardConfig(max_retries=2, backoff_base_s=0.0))
    with pytest.raises(PersistentCommFailure):
        g.retry(3, _failing(99), sleep=lambda s: None)
    assert g.events[-1].kind == "persistent_failure"
    g2 = CollectiveGuard()
    assert g2.retry(0, _failing(0), sleep=lambda s: None) == "payload" and g2.events == []


def test_link_health_detects_sustained_degradation_only():
    B = 100e9
    lh = LinkHealth({0: B}, window=4, ewma_alpha=0.7, degraded_factor=2.0, patience=2)
    for s in SIZES * 2:
        lh.observe(0, s, s / B)
        assert not lh.degraded(0)
    lh.observe(0, SIZES[0], 4 * SIZES[0] / B)
    assert not lh.degraded(0)
    for s in SIZES * 4:
        lh.observe(0, s, 4 * s / B)
    assert lh.ewma_Bps[0] < B / 2 and lh.degraded(0) and not lh.degraded(0)
    lh.rebase(0, lh.ewma_Bps[0])
    for s in SIZES * 2:
        lh.observe(0, s, 4 * s / B)
        assert not lh.degraded(0)
    lh2 = LinkHealth({0: 1e9}, window=4)
    assert lh2.observe(0, 1 << 20, float("nan")) is None
    assert lh2.observe(0, 0, 1.0) is None and lh2.ewma_Bps == {}
    with pytest.raises(ValueError):
        LinkHealth({0: 1e9}, ewma_alpha=0.0)


def test_degraded_link_escalates_to_elastic_replan():
    topo = topology.tpu_multipod(2, 8)
    cache = PlanCache()
    grad = 64 << 20
    planner.plan(topo, [grad], cache=cache, **PLAN_KW)
    ctl = elastic.ElasticController(topo, [grad], plan_cache=cache, plan_kw=PLAN_KW)
    g = CollectiveGuard(GuardConfig(link_window=4, ewma_alpha=0.7, degraded_factor=2.0,
                                    degraded_patience=2),
                        nominal_Bps={i: c.nic_Bps for i, c in enumerate(topo.clusters)},
                        elastic=ctl)
    B = topo.clusters[1].nic_Bps
    for step in range(8):
        for s in SIZES:
            g.observe_transfer(step, 1, s, 4 * s / B)
    evs = [e for e in g.events if e.kind == "degraded_link"]
    assert len(evs) == 1
    rep = evs[0].replan
    assert rep.trigger == "degraded_link" and rep.invalidated_entries >= 1
    assert ctl.state == "replanned" and ctl.topo.clusters[1].nic_Bps < B
    assert g.links.nominal[1] == pytest.approx(evs[0].measured)
    report = g.report()
    assert report["counts"] == {"degraded_link": 1}


# ---------------------------------------------------------------------------
# Elastic re-planning (analogs of tests/test_elastic.py)
# ---------------------------------------------------------------------------

ZERO_KW = dict(PLAN_KW, coll="reduce_scatter")


def _controller(n_pods=2, *, cache=None, straggler=None, config=None):
    topo = topology.tpu_multipod(n_pods, 8)
    cache = cache if cache is not None else PlanCache()
    grad = 64 << 20
    planner.plan(topo, [grad], cache=cache, **ZERO_KW)
    return elastic.ElasticController(topo, [grad], plan_cache=cache, straggler=straggler,
                                     config=config, plan_kw=ZERO_KW), cache


def test_pod_failure_replan_invalidates_and_validates():
    ctl, cache = _controller(2)
    old_fp = ctl.topo.fingerprint()
    rep = ctl.report_pod_failure(7, 1)
    assert rep.trigger == "pod_failure" and cache.stats()["invalidations"] == 1
    assert rep.old_fingerprint == elastic.fingerprint_digest(old_fp) != rep.new_fingerprint
    assert rep.validated and rep.validated_via is not None
    assert ctl.topo.n_clusters == 1 and ctl.state == "replanned"
    jctl = jelastic.ElasticController(jtopo.tpu_multipod(2, 8), [64 << 20],
                                      plan_cache=JPlanCache(), plan_kw=ZERO_KW)
    jrep = jctl.report_pod_failure(7, 1)
    assert (rep.new_fingerprint, rep.plan_mode, rep.validated_via) == (
        jrep.new_fingerprint, jrep.plan_mode, jrep.validated_via)
    assert ctl.resumed(9) is rep
    assert rep.steps_lost == 2 and rep.within_bound and rep.remap_path == "slot_map"
    assert ctl.state == "healthy" and "pod_failure" in rep.describe()
    with pytest.raises(RuntimeError, match="without a pending re-plan"):
        ctl.resumed(10)


def test_straggler_needs_consecutive_slow_steps():
    cfg = elastic.ElasticConfig(straggler_patience=3, on_straggler=lambda t: t.shrink_cluster(
        0, max(1, t.clusters[0].n_nodes // 2)))
    ctl, cache = _controller(2, config=cfg)
    for s, slow in enumerate((True, True, False, True, True)):
        assert ctl.observe_step(s, slow=slow) is None
    rep = ctl.observe_step(5, slow=True)
    assert rep.trigger == "straggler" and ctl.topo.clusters[0].n_nodes == 4
    assert cache.stats()["invalidations"] == 1
    assert ctl.observe_step(6, slow=True) is None
    assert ctl.resumed(6).steps_lost == 1
    ctl2, cache2 = _controller(2)
    assert all(ctl2.observe_step(s, slow=True) is None for s in range(10))
    assert ctl2.state == "healthy" and cache2.stats()["invalidations"] == 0


def test_replan_resets_straggler_monitor():
    mon = StragglerMonitor(factor=3.0)
    for _ in range(8):
        mon.observe(0.1)
    mon.observe(0.9)
    ctl, _ = _controller(2, straggler=mon)
    ctl.report_pod_failure(1, 0)
    assert mon.times == [] and mon.flagged == []


def test_degraded_link_replan_derates_without_reshard():
    ctl, cache = _controller(2)
    B = ctl.topo.clusters[1].nic_Bps
    rep = ctl.report_degraded_link(5, 1, B / 4)
    assert rep.trigger == "degraded_link" and ctl.topo.n_clusters == 2
    assert ctl.report_degraded_link(6, 1, B / 8) is None
    ctl.resumed(6)
    assert ctl.report_degraded_link(7, 1, B / 4) is None


def _layouts(metas, old_world, new_world, pack=packing):
    return (pack.plan_layout(metas, world=old_world, block=1),
            pack.plan_layout(metas, world=new_world, block=1))


def _global_master(layout, world, rng):
    """A global ZeRO-1 buffer of ``layout`` over ``world`` ranks: each
    segment drawn with a zero tail, cut per rank, the ranks' shards (each
    the concatenation of its slice of every segment) laid end to end."""
    segs = [np.concatenate([rng.standard_normal(s.used), np.zeros(s.padded - s.used)])
            .astype(np.float32) for s in layout.segments]
    return np.concatenate([seg.reshape(world, -1)[r] for r in range(world) for seg in segs])


def _zero_tails(a, layout):
    base = 0
    for s in layout.segments:
        a[base + s.used:base + s.padded] = 0.0
        base += s.padded
    return a


@pytest.mark.parametrize("old_world, new_world", [(4, 2), (2, 4), (3, 1), (2, 2)])
def test_remap_ops_and_flat_equal_the_references(old_world, new_world):
    metas = [("float32", (1000,), 1000), ("bfloat16", (37,), 37), ("float32", (5,), 5)]
    old, new = _layouts(metas, old_world * 2, new_world * 2)
    jold, jnew = _layouts(metas, old_world * 2, new_world * 2, jpacking)
    ops = packing.remap_shard_ops(old, new, old_world=old_world, new_world=new_world)
    jops = jpacking.remap_shard_ops(jold, jnew, old_world=old_world, new_world=new_world)
    assert [[dataclasses.astuple(o) for o in r] for r in ops] == \
        [[dataclasses.astuple(o) for o in r] for r in jops]
    flat = _global_master(old, old_world, np.random.default_rng(3))
    out = elastic.remap_flat(flat, old, new, old_world=old_world, new_world=new_world)
    np.testing.assert_array_equal(out, jelastic.remap_flat(
        flat, jold, jnew, old_world=old_world, new_world=new_world))
    back = elastic.remap_flat(out, new, old, old_world=new_world, new_world=old_world)
    np.testing.assert_array_equal(back, flat)


def test_remap_flat_identity_with_tp_columns_and_bad_size():
    lay = packing.plan_layout([("float32", (256,), 256)], world=2, block=1)
    flat = np.random.default_rng(5).standard_normal(2 * lay.padded_total).astype(np.float32)
    np.testing.assert_array_equal(
        elastic.remap_flat(flat, lay, lay, old_world=2, new_world=2, n_columns=2), flat)
    old, new = _layouts([("float32", (64,), 64)], 2, 1)
    with pytest.raises(ValueError, match="elements"):
        elastic.remap_flat(np.zeros(7, np.float32), old, new, old_world=2, new_world=1)


def test_remap_zero_state_equals_the_references():
    metas = [("float32", (500,), 500)]
    old, new = _layouts(metas, 4, 2)
    rng = np.random.default_rng(9)
    bufs = [_zero_tails(rng.standard_normal(old.padded_total).astype(np.float32), old)
            for _ in range(3)]
    out = elastic.remap_zero_state(ZeroState(*bufs, step=np.int32(11)), old, new,
                                   old_world=4, new_world=2)
    jout = jelastic.remap_zero_state(JZeroState(*bufs, np.int32(11)),
                                     *_layouts(metas, 4, 2, jpacking), old_world=4, new_world=2)
    assert int(out.step) == 11
    for name in ("flat_param", "mu", "nu"):
        np.testing.assert_array_equal(getattr(out, name), getattr(jout, name))
    bad_old = packing.plan_layout(metas, world=2, block=1)
    bad_new = packing.plan_layout([("float32", (65,), 65)], world=2, block=1)
    with pytest.raises(ValueError):
        elastic.remap_zero_state(ZeroState(*bufs[:1] * 3), bad_old, bad_new,
                                 old_world=2, new_world=2)


@pytest.mark.parametrize("data", [1, 2, 4])
def test_zero1_master_layout_equals_the_references(data):
    """The layout from the port's local leaves (TP 1) places every leaf
    where the reference's from the parameters' shapes and specs does (its
    slots name flat shapes), and is the port's ZeRO-1 bootstrap layout."""
    cfg = get_config("qwen2.5-3b", smoke=True)
    leaves = Model(cfg, device="cpu").init(0).train_leaves()
    jm = JaxModel(jax_config("qwen2.5-3b", smoke=True), JaxRuntime())
    pshape = jax.eval_shape(jm.init, jax.random.key(0))
    want = jelastic.zero1_master_layout(pshape, jm.param_specs(pshape), {"data": data})
    got = elastic.zero1_master_layout(leaves, data)

    def placed(lay):     # what the remap reads: segments, and where each leaf lies
        return ([dataclasses.astuple(s) for s in lay.segments],
                [(s.segment, s.offset, s.size) for s in lay.slots])

    assert placed(got) == placed(want)
    assert got == tcoll._zero1_layout(leaves, data)


def test_reshard_tree_places_host_leaves():
    t = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": torch.ones(4)}
    out = elastic.reshard_tree(t, torch.device("cpu"),
                               {"a": lambda g: g[1:], "b": lambda g: g})
    assert torch.equal(out["a"], torch.tensor([[3.0, 4.0, 5.0]])) and torch.equal(out["b"],
                                                                                 t["b"])


# ---------------------------------------------------------------------------
# The chaos seams of the syncs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world_of_one():
    started = not dist.is_initialized()
    if started:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    yield dist.new_group([0])
    if started:
        dist.destroy_process_group()


def _jax_psum(x, cfg, hook=None):
    mesh = jax.make_mesh((1,), ("data",))
    from jax.sharding import PartitionSpec as P

    def body(v):
        return jcoll.hier_psum(v, cfg)

    f = shard_map(body, mesh=mesh, in_specs=P(), out_specs=P())
    if hook is None:
        return np.asarray(f(jnp.asarray(x)))
    with jprim.inject_hook(hook):
        return np.asarray(jax.jit(f)(jnp.asarray(x)))


def test_podless_pipelined_sync_corrupts_the_flat_payload(world_of_one):
    """A pipelined sync with no pod group is one intra all-reduce whose
    payload passes the "flat" seam, as in the reference; a NaN planned
    there lands in element 0 of the result in both."""
    x = np.random.default_rng(1).standard_normal(4096).astype(np.float32)
    plan = FaultPlan(0, (FaultEvent("nan_payload", 1, rank=0),))
    seen, jseen = [], []

    def recording(phases, inner):
        def hook(buf, phase):
            phases.append(phase)
            return inner(buf, phase)
        return hook

    cfg = CommConfig(mode="hier_pipelined", pod_group=None, intra_group=world_of_one,
                     n_chunks=4)
    with primitives.inject_hook(recording(seen, FaultInjector(plan).corruption_hook(1, rank=0))):
        got = tcoll.hier_psum(torch.from_numpy(x.copy()), cfg).numpy()
    jcfg = jcoll.CommConfig(mode="hier_pipelined", pod_axis=None, intra_axis="data", n_chunks=4)
    want = _jax_psum(x, jcfg, recording(jseen, jfaults.FaultInjector(plan).corruption_hook(1)))
    assert seen == jseen == ["flat"]
    assert np.isnan(got[0]) and np.isnan(want[0])
    np.testing.assert_array_equal(got[1:], want[1:])


def test_nan_on_the_int8_wire_is_silenced_as_in_the_reference(world_of_one):
    """ROADMAP R20: the shared scale maps a block whose max is NaN to
    scale 1 (``where(amax > 0, ...)``), so a NaN payload on the int8 wire
    decodes to a finite block, bit-equal in both packages, and no NaN
    reaches the finite gate."""
    from repro.core import compression as jcomp
    from repro_torch.core import compression as tcomp

    x = (np.random.default_rng(0).standard_normal(2048) * 1e-2).astype(np.float32)
    x[0] = np.nan
    got = tcomp.compressed_psum(torch.from_numpy(x.copy()), world_of_one, "int8").numpy()
    mesh = jax.make_mesh((1,), ("pod",))
    from jax.sharding import PartitionSpec as P
    want = np.asarray(shard_map(lambda v: jcomp.compressed_psum(v, "pod", "int8"), mesh=mesh,
                                in_specs=P(), out_specs=P())(jnp.asarray(x)))
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_array_equal(got, want)


def test_periodic_checkpoint_label_is_the_references(world_of_one, tmp_path):
    """ROADMAP R21: both launchers label a periodic checkpoint with the
    step just taken, so over 3 steps with ``--ckpt-every 2`` the
    checkpoints of steps 2 and 3 hold the same state; the port's training
    checkpoint names its leaves as the reference's does."""
    import json as _json

    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain

    jtrain.main(["--smoke", "--steps", "3", "--seq", "32", "--mesh", "none", "--ckpt-dir",
                 str(tmp_path / "ref"), "--ckpt-every", "2", "--log-every", "1"])
    ttrain.run(smoke=True, steps=3, seq=32, device="cpu", ckpt_dir=str(tmp_path / "port"),
               ckpt_every=2, log=lambda line: None)
    for side in ("ref", "port"):
        a, b = (np.load(tmp_path / side / f"step_{s}" / "arrays.npz") for s in (2, 3))
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[k], b[k]) for k in a.files), side
    names = [_json.loads((tmp_path / side / "step_3" / "manifest.json").read_text())
             for side in ("ref", "port")]
    assert names[0]["names"] == names[1]["names"]
    assert names[0]["dtypes"] == names[1]["dtypes"]
