"""Mamba2 training: the port against the JAX package.

* The plain chunked SSD and causal conv under autograd: the gradients of
  the port's ``ref.ssd_chunked`` (to x, dt, A, B and C, through y and the
  final state) against ``jax.grad`` of the reference's, at the SSD cases
  of ``tests/test_torch_ssm.py``, and of ``ref.causal_conv1d``.  The
  reference trains through its plain SSD because ``jax.grad`` through its
  Pallas ``ssd_chunked`` fails (ROADMAP R15): checked here too.
* The f32 smoke model, three steps at TP 1 (one process, no sync)
  against the reference's single-device ``make_train_step``: losses and
  grad norms within 1e-4 (relative), parameters within 1e-4.
* Eight gloo ranks, spawned once, as (pod 2, data 2, model 2) against
  the reference on a mesh of the same shape (8 host devices, its step
  built with ``donate=False``, ROADMAP R12): ``hier`` + int8 with
  sequence parallelism off and on, and ``fsdp`` + int8 at d_model 256
  (the SSM leaves at TP 2 reach FSDP_MIN_SIZE and are sharded over the
  data group too).  Three steps at lr 1e-3 on a 160-token sequence (two
  chunks of 128, the second padded): every rank's losses and grad norms
  within 1e-3 of its own device's in the reference (as
  ``tests/test_torch_tp.py`` holds them), and its parameters after the
  steps against its device's shards: all within 2 lr, and all but 0.1%
  within 1e-4.  The int8 codec rounds each gradient value to a step of
  its block's scale; where the two packages' f32 gradients (summed in
  another order) straddle a rounding boundary, the value crosses one
  step apart, and Adam turns that into an update up to lr apart (at lr
  1e-2 the random smoke model amplifies such flips over three steps).  The B/C projection and
  its conv are replicated over the model axis, and neither package sums
  their gradients over it (ROADMAP R16): after a step the two model
  columns hold different copies, in both packages alike, and so do their
  grad norms.
* The training entry point with ``--arch mamba2-2.7b`` at ``--tp 2
  --sp`` as two processes, and the trainer through every ``--mode`` and
  ``--plan auto`` on the smoke mamba2 and hymba in a world of one.
"""

import dataclasses
import datetime
import json
import os
import sys

import numpy as np

WORLD, GB, S, N_STEPS = 8, 4, 160, 3
LR, WARMUP = 1e-3, 1
ARCH = "mamba2-2.7b"
WIDE = 256            # fsdp's d_model: w_z at TP 2 is 2 x 256 x 256 = 2^17 values
# (comm mode, pod-hop codec, sequence parallelism) of the eight-rank runs
TRAIN_CASES = [("hier", "int8", False), ("hier", "int8", True), ("fsdp", "int8", False)]


def case_id(mode: str, codec, sp: bool) -> str:
    return f"{mode}_{codec}{'_sp' if sp else ''}"


def batch(step: int, vocab: int) -> dict:
    rng = np.random.default_rng(300 + step)
    return {"tokens": rng.integers(0, vocab, (GB, S), dtype=np.int32),
            "labels": rng.integers(0, vocab, (GB, S), dtype=np.int32)}


def _jax_main(out_dir: str, part: str) -> None:
    """The reference on (pod 2, data 2, model 2): the case ``part`` names
    (its index in TRAIN_CASES), every device's metrics and parameters."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from _torch_world import nest
    from repro.configs import get_config as jax_config
    from repro.launch.mesh import runtime_for_mesh
    from repro.models import Model as JaxModel
    from repro.train import TrainConfig as JaxTrainConfig
    from repro.train import make_train_step as jax_train_step
    from repro.train import optimizer as jopt
    from repro.train.optimizer import OptConfig as JaxOpt

    mode, codec, sp = TRAIN_CASES[int(part)]
    fsdp = mode == "fsdp"
    cfg = dataclasses.replace(jax_config(ARCH, smoke=True), dtype=jnp.float32,
                              **({"d_model": WIDE} if fsdp else {}))
    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
    order = list(mesh.devices.flat)             # rank (p * 2 + d) * 2 + m
    model = JaxModel(cfg, runtime_for_mesh(mesh, fsdp=fsdp, sp=sp))
    if fsdp:
        model = model.with_fsdp(2)
    tcfg = JaxTrainConfig(comm_mode=mode, dcn_compression=codec,
                          opt=JaxOpt(lr=LR, warmup_steps=WARMUP))
    params = jax.tree.map(jnp.asarray, nest(np.load(
        os.path.join(out_dir, f"params_{'wide' if fsdp else 'base'}.npz"))))
    build, _ = jax_train_step(model, tcfg, mesh=mesh, donate=False)
    shapes = jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape, p.dtype), params)
    step, _ = build(shapes)
    specs, _ = jax.tree_util.tree_flatten_with_path(model.param_specs(shapes),
                                                    is_leaf=lambda x: isinstance(x, P))
    params = jax.tree.map(lambda p, s: jax.device_put(p, NamedSharding(mesh, s)), params,
                          model.param_specs(shapes))
    opt = jopt.adam_init(params)
    out = {}
    key = case_id(mode, codec, sp)
    metrics = np.zeros((len(order), N_STEPS, 2))
    for i in range(N_STEPS):
        b = {k: jnp.asarray(v) for k, v in batch(i, cfg.vocab_size).items()}
        params, opt, m = step(params, opt, b)
        for j, name in enumerate(("loss", "grad_norm")):
            for sh in m[name].addressable_shards:      # each device's own value
                metrics[order.index(sh.device), i, j] = float(sh.data)
    out[f"{key}/metrics"] = metrics
    for (path, _), leaf in zip(specs, jax.tree.leaves(params)):
        name = "/".join(str(k.key) for k in path)
        for sh in leaf.addressable_shards:
            out[f"{key}/param/rank{order.index(sh.device)}/{name}"] = np.asarray(sh.data)
    np.savez(os.path.join(out_dir, f"jax_{part}.npz"), **out)


def _gloo_rank(rank: int, store_path: str, out_dir: str) -> None:
    """One rank of the eight-rank world: every case's metrics and final
    parameter shards."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist

    from _torch_world import nest
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.mesh import runtime_for_groups
    from repro_torch.launch.train import dp_rows
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import TrainConfig, make_train_step

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    out = {}
    try:
        rt = runtime_for_groups(pods=2, data_per_pod=2, tp=2)
        rows = dp_rows(rank, GB, 2, 2, 2)
        for mode, codec, sp in TRAIN_CASES:
            fsdp = mode == "fsdp"
            cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=torch.float32,
                                      **({"d_model": WIDE} if fsdp else {}))
            case_rt = dataclasses.replace(rt, sp=sp, fsdp_group=rt.data_group if fsdp else None)
            tree = nest(np.load(os.path.join(out_dir, f"params_{'wide' if fsdp else 'base'}.npz")))
            model = params_from_jax(tree, cfg, case_rt, device="cpu", fsdp=2 if fsdp else 1)
            step_fn, _ = make_train_step(model, TrainConfig(
                comm_mode=mode, dcn_compression=codec,
                opt=opt_lib.OptConfig(lr=LR, warmup_steps=WARMUP)))
            opt = opt_lib.adam_init(opt_lib.flat_params(model.train_leaves())[0])
            metrics = []
            for i in range(N_STEPS):
                b = {k: torch.from_numpy(v[rows]).long() for k, v in batch(i, cfg.vocab_size).items()}
                m = step_fn(opt, b)
                assert not m["gated"]
                metrics.append((m["loss"], m["grad_norm"]))
            key = case_id(mode, codec, sp)
            out[f"{key}/metrics"] = np.asarray(metrics)
            for path, leaf in zip(model.param_specs(), model.train_leaves()):
                out[f"{key}/param/{'/'.join(path)}"] = (
                    torch.stack(leaf) if isinstance(leaf, list) else leaf).detach().numpy()
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

from _torch_world import flat_tree, run_world  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.parallel.sharding import Runtime as JaxRuntime  # noqa: E402
from repro.train import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.train import make_train_step as jax_train_step  # noqa: E402
from repro.train.optimizer import OptConfig as JaxOpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402
from repro_torch.train.train_step import TrainConfig, make_train_step  # noqa: E402
from test_torch_ssm import SSD_CASES, _first_ssd_call, _ssd_inputs  # noqa: E402,F401
from test_torch_tp import _run_ranks  # noqa: E402

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_GRAD_TOL = dict(atol=8e-2, rtol=8e-2)
# as tests/test_torch_train.py's one-process parity: at lr 1e-3 Adam's
# first steps on rounding noise stay below the parameters' 1e-4
PARITY_LR = 1e-3


def _cotangents(case, seed=1):
    b, s, h, p, g, n = case[:6]
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, p)).astype(np.float32),
            rng.normal(size=(b, h, p, n)).astype(np.float32))


@pytest.mark.parametrize("case", SSD_CASES)
def test_ref_ssd_chunked_gradients_vs_jax(case):
    """d/d(x, dt, A, B, C) of <y, ct_y> + <h_final, ct_h>, the port's plain
    SSD under autograd against ``jax.grad`` of the reference's."""
    j, t, tol = _ssd_inputs(case)
    chunk = case[6]
    cy, ch = _cotangents(case)
    names = ("x", "dt", "A", "B", "C")

    def jloss(*args):
        y, h = jref.ssd_chunked(*args, chunk=chunk)
        return jnp.sum(y.astype(jnp.float32) * cy) + jnp.sum(h * ch)

    jgrads = jax.jit(jax.grad(jloss, argnums=tuple(range(5))))(*(j[k] for k in names))
    leaves = [t[k].clone().requires_grad_(True) for k in names]
    y, h = ref.ssd_chunked(*leaves, chunk=chunk)
    loss = (y.float() * torch.from_numpy(cy)).sum() + (h * torch.from_numpy(ch)).sum()
    grads = torch.autograd.grad(loss, leaves)
    gtol = F32_TOL if case[7] == jnp.float32 else BF16_GRAD_TOL
    for name, got, want in zip(names, grads, jgrads):
        # an f32 gradient of a sum over the sequence: scale the tolerance
        # by the largest magnitude, as a bound on the summation order's error
        scale = max(1.0, float(np.abs(np.asarray(want, np.float32)).max()))
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=gtol["rtol"], atol=gtol["atol"] * scale, err_msg=name)


@pytest.mark.parametrize("bias", [False, True])
def test_ref_causal_conv1d_gradients_vs_jax(bias):
    rng = np.random.default_rng(5)
    x, w = rng.normal(size=(2, 37, 24)), rng.normal(size=(24, 4))
    bb, ct = rng.normal(size=(24,)), rng.normal(size=(2, 37, 24))
    args = [x, w] + ([bb] if bias else [])
    jgrads = jax.grad(lambda *a: jnp.sum(jref.causal_conv1d(*a) * ct),
                      argnums=tuple(range(len(args))))(*(jnp.asarray(a, jnp.float32)
                                                         for a in args))
    leaves = [torch.tensor(a, dtype=torch.float32, requires_grad=True) for a in args]
    grads = torch.autograd.grad((ref.causal_conv1d(*leaves) * torch.from_numpy(ct)).sum(),
                                leaves)
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_reference_cannot_differentiate_its_ssd_kernel():
    """ROADMAP R15: ``jax.grad`` through the reference's Pallas
    ``ssd_chunked`` fails, while its plain ``ref.ssd_chunked`` has a
    gradient, so the reference trains through the plain one (its
    ``Runtime.use_pallas`` is False in training) and the port does too."""
    j, _, _ = _ssd_inputs(SSD_CASES[1])
    chunk = SSD_CASES[1][6]

    def loss(fn, x):
        return jnp.sum(fn(x, j["dt"], j["A"], j["B"], j["C"], chunk=chunk)[0])

    with pytest.raises(ValueError, match="Linearization failed"):
        jax.grad(lambda x: loss(jops.ssd_chunked, x))(j["x"])
    assert np.isfinite(np.asarray(jax.grad(lambda x: loss(jref.ssd_chunked, x))(j["x"]))).all()


def test_forward_only_kernels_refuse_autograd():
    """The guard the SSD and flash wrappers run on a CUDA tensor before
    launching (their kernels return tensors with no ``grad_fn``)."""
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(_build.NoBackwardError, match="ssd_chunk: the kernel has no backward"):
        _build.refuse_autograd("ssd_chunk", x, torch.zeros(3))
    with torch.no_grad():
        _build.refuse_autograd("ssd_chunk", x)
    with torch.inference_mode():
        _build.refuse_autograd("flash_attention", x)
    _build.refuse_autograd("flash_attention", x.detach(), None)


def test_train_step_one_process_matches_jax():
    """TP 1: no mesh and no sync in either package; the SSD runs its plain
    path under autograd in both."""
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), dtype=jnp.float32)
    jm = JaxModel(jcfg, JaxRuntime())
    params = jm.init(jax.random.key(0))
    tm = params_from_jax(jax.tree.map(np.asarray, params),
                         dataclasses.replace(get_config(ARCH, smoke=True), dtype=torch.float32),
                         device="cpu")
    jstep, jinit = jax_train_step(jm, JaxTrainConfig(
        comm_mode="flat", opt=JaxOpt(lr=PARITY_LR, warmup_steps=WARMUP)))
    jopt = jinit(jax.random.key(0))[1]
    step_fn, _ = make_train_step(tm, TrainConfig(
        comm_mode="flat", opt=opt_lib.OptConfig(lr=PARITY_LR, warmup_steps=WARMUP)))
    opt = opt_lib.adam_init(opt_lib.flat_params(tm.train_leaves())[0])
    for i in range(N_STEPS):
        b = batch(i, jcfg.vocab_size)
        params, jopt, jm_ = jstep(params, jopt, {k: jnp.asarray(v) for k, v in b.items()})
        m = step_fn(opt, {k: torch.from_numpy(v).long() for k, v in b.items()})
        assert not m["gated"]
        np.testing.assert_allclose(m["loss"], float(jm_["loss"]), rtol=1e-4)
        np.testing.assert_allclose(m["grad_norm"], float(jm_["grad_norm"]), rtol=1e-4)
    for got, want in zip(tm.train_leaves(), jax.tree.leaves(params)):
        got = torch.stack(got) if isinstance(got, list) else got
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4)


def _jax_params(**overrides) -> dict:
    cfg = dataclasses.replace(jax_config(ARCH, smoke=True), dtype=jnp.float32, **overrides)
    params = JaxModel(cfg, JaxRuntime(tp_axis="model", tp_size=2)).init(jax.random.key(0))
    return flat_tree(jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every case on 8 gloo ranks and in JAX on 8 host devices, one
    process per case: (the reference's results, each rank's)."""
    tmp = tmp_path_factory.mktemp("ssm_train")
    np.savez(tmp / "params_base.npz", **_jax_params())
    np.savez(tmp / "params_wide.npz", **_jax_params(d_model=WIDE))
    parts = tuple(str(i) for i in range(len(TRAIN_CASES)))
    return run_world(__file__, tmp, parts, WORLD, _gloo_rank, WORLD)


@pytest.mark.parametrize("mode, codec, sp", TRAIN_CASES)
def test_training_2x2x2_matches_jax(results, mode, codec, sp):
    want, ranks = results
    key = case_id(mode, codec, sp)
    for rank, got in enumerate(ranks):
        np.testing.assert_allclose(got[f"{key}/metrics"], want[f"{key}/metrics"][rank],
                                   rtol=0, atol=1e-3, err_msg=f"rank {rank}")
        names = sorted(k.split("/", 2)[2] for k in got.files if k.startswith(f"{key}/param/"))
        assert names == sorted(k.split("/", 3)[3] for k in want
                               if k.startswith(f"{key}/param/rank{rank}/"))
        far = total = 0
        for name in names:
            a, b = got[f"{key}/param/{name}"], want[f"{key}/param/rank{rank}/{name}"]
            np.testing.assert_allclose(a, b, rtol=0, atol=2 * LR, err_msg=f"rank {rank} {name}")
            far += int((np.abs(a - b) > 1e-4).sum())
            total += a.size
        assert far <= 1e-3 * total, f"rank {rank}: {far} of {total} parameters beyond 1e-4"
    if mode == "fsdp":
        # the SSM's column-parallel leaves are sharded over model and data
        assert ranks[0][f"{key}/param/layers/ssm/w_z"].shape == (2, WIDE // 2, WIDE)


def test_replicated_ssm_leaves_drift_apart_as_in_the_reference(results):
    """ROADMAP R16: w_bc, conv_w_bc and conv_b_bc are replicated over the
    model axis, and their gradients are summed over the data-parallel
    ranks of a model index only (the reference's ``check_vma=False``
    step sums no replicated leaf over the model axis).  B and C feed only
    the local SSM heads, so each model column's copy steps on its own
    heads' gradient: after the steps ranks 0 and 1 (one TP group) hold
    different copies, in both packages, and the grad norms they report
    differ; the loss, a sum over the TP group, stays one value."""
    want, ranks = results
    key = case_id("hier", "int8", False)
    for leaf in ("w_bc", "conv_w_bc", "conv_b_bc"):
        name = f"{key}/param/layers/ssm/{leaf}"
        assert not np.allclose(ranks[0][name], ranks[1][name], rtol=0, atol=1e-6), leaf
        assert not np.allclose(want[f"{key}/param/rank0/layers/ssm/{leaf}"],
                               want[f"{key}/param/rank1/layers/ssm/{leaf}"], rtol=0, atol=1e-6)
        # the model columns keep their copies in step across data-parallel ranks
        np.testing.assert_array_equal(ranks[0][name], ranks[6][name])
    m0, m1 = ranks[0][f"{key}/metrics"], ranks[1][f"{key}/metrics"]
    np.testing.assert_array_equal(m0[:, 0], m1[:, 0])
    assert not np.allclose(m0[:, 1], m1[:, 1], rtol=0, atol=1e-7)
    w = want[f"{key}/metrics"]
    assert not np.allclose(w[0, :, 1], w[1, :, 1], rtol=0, atol=1e-7)


def test_train_entry_point_at_tp2_with_sp_on_cpu():
    """``--arch mamba2-2.7b --tp 2 --sp``: both ranks log the same finite
    losses (a sum over the TP group)."""
    outs = _run_ranks("repro_torch.launch.train",
                      ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2", "--seq",
                       "64", "--mode", "hier", "--compression", "int8", "--tp", "2", "--sp"], 2)
    for lines in outs:
        steps, summary = lines[:-1], lines[-1]
        assert (summary["tp"], summary["sp"], summary["arch"]) == (2, True, "mamba2-2.7b-smoke")
        assert all(np.isfinite(s["loss"]) and not s["gated"] for s in steps)
        assert [s["loss"] for s in steps] == [s["loss"] for s in outs[0][:-1]]


_EVERY_MODE = """
import json, sys, torch
from repro_torch.launch.mesh import init_world
from repro_torch.launch.train import MODES, run
init_world(torch.device("cpu"))
for mode in MODES + ("plan",):
    kw = dict(plan="auto") if mode == "plan" else dict(mode=mode)
    codec = "bf16" if mode == "hier_border_rs" else "int8"
    res = run(sys.argv[1], smoke=True, steps=2, seq=48, compression=codec, device="cpu",
              log=lambda line: None, **kw)
    print(json.dumps({"mode": mode, "ran": res["mode"],
                      "losses": [r["loss"] for r in res["records"]],
                      "gated": [r["gated"] for r in res["records"]]}))
"""


@pytest.mark.parametrize("arch", [ARCH, "hymba-1.5b"])
def test_trainer_runs_every_mode_on_cpu(arch):
    """``launch.train.run`` on the smoke model in a world of one, through
    every ``--mode`` (bf16 on hier_border_rs's pod hop, which refuses
    int8) and ``--plan auto``: finite losses, the gate open."""
    import subprocess

    from _torch_world import ROOT
    from repro_torch.launch.train import MODES

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", _EVERY_MODE, arch], env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = [json.loads(line) for line in res.stdout.splitlines() if line.startswith("{")]
    assert [line["mode"] for line in lines] == list(MODES) + ["plan"]
    for line in lines:
        assert np.isfinite(line["losses"]).all() and not any(line["gated"]), line
