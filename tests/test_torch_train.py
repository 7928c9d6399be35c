"""The port's training path against the JAX package's, smoke qwen2.5-3b.

* One process, no groups: three steps of ``make_train_step`` (``flat``)
  against the reference's ``make_train_step(mesh=None)`` from the same
  f32 parameters and batches: losses and grad norms within 1e-4
  relative, parameters within 1e-4.
* Four gloo ranks (2 pods x 2 data), ``hier`` with int8 on the pod hop,
  against the reference on a 4-device (pod 2, data 2) mesh: losses
  within 1e-3 over three steps.  The JAX side runs this file as a
  script with 4 host devices.
* Chunked training attention (forward and gradient) against the
  reference's ``chunked_attention``: within 1e-5.
* The synthetic data is the reference's token stream, bit for bit.
* The entry point prints finite JSON lines on the CPU, and refuses to
  run without a card unless told to use the CPU.
"""

import dataclasses
import datetime
import json
import multiprocessing
import os
import pathlib
import subprocess
import sys

import numpy as np

GB, S, N_STEPS, WORLD = 4, 32, 3, 4
LR, WARMUP = 1e-2, 1


def batch(step: int, vocab: int) -> dict:
    rng = np.random.default_rng(100 + step)
    return {"tokens": rng.integers(0, vocab, (GB, S), dtype=np.int32),
            "labels": rng.integers(0, vocab, (GB, S), dtype=np.int32)}


def _flat_tree(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _nest(flat) -> dict:
    tree: dict = {}
    for path in flat:
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = np.asarray(flat[path])
    return tree


def _jax_main(out_dir: str) -> None:
    import jax

    from repro.configs import get_config as jax_config
    from repro.launch.mesh import runtime_for_mesh
    from repro.models import Model as JaxModel
    from repro.train import TrainConfig as JaxTrainConfig
    from repro.train import make_train_step as jax_train_step
    from repro.train.optimizer import OptConfig as JaxOpt

    mesh = jax.make_mesh((2, 2), ("pod", "data"))
    cfg = dataclasses.replace(jax_config("qwen2.5-3b", smoke=True), dtype=jax.numpy.float32)
    model = JaxModel(cfg, runtime_for_mesh(mesh))
    tcfg = JaxTrainConfig(comm_mode="hier", dcn_compression="int8",
                          opt=JaxOpt(lr=LR, warmup_steps=WARMUP))
    build, init = jax_train_step(model, tcfg, mesh=mesh)
    params, opt = init(jax.random.key(0))
    step, _ = build(jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape, p.dtype), params))
    losses = []
    for i in range(N_STEPS):
        b = {k: jax.numpy.asarray(v) for k, v in batch(i, cfg.vocab_size).items()}
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
    np.save(os.path.join(out_dir, "jax_losses.npy"), np.asarray(losses))


def _gloo_rank(rank: int, store_path: str, out_dir: str) -> None:
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.mesh import runtime_for_groups
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import TrainConfig, make_train_step

    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=60))
    try:
        rt = runtime_for_groups(pods=2, data_per_pod=2)
        cfg = dataclasses.replace(get_config("qwen2.5-3b", smoke=True), dtype=torch.float32)
        model = params_from_jax(_nest(np.load(os.path.join(out_dir, "params.npz"))),
                                cfg, rt, device="cpu")
        step_fn, _ = make_train_step(model, TrainConfig(
            comm_mode="hier", dcn_compression="int8",
            opt=opt_lib.OptConfig(lr=LR, warmup_steps=WARMUP)))
        opt = opt_lib.adam_init(opt_lib.flat_params(model.train_leaves())[0])
        rows = slice(rank * GB // WORLD, (rank + 1) * GB // WORLD)
        losses = []
        for i in range(N_STEPS):
            b = {k: torch.from_numpy(v[rows]).long()
                 for k, v in batch(i, cfg.vocab_size).items()}
            m = step_fn(opt, b)
            assert not m["gated"]
            losses.append(m["loss"])
        np.save(os.path.join(out_dir, f"rank{rank}_losses.npy"), np.asarray(losses))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _jax_main(sys.argv[1])
    sys.exit(0)


import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.parallel.sharding import Runtime as JaxRuntime  # noqa: E402
from repro.train import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.train import make_train_step as jax_train_step  # noqa: E402
from repro.train.optimizer import OptConfig as JaxOpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402
from repro_torch.train.train_step import TrainConfig, make_train_step  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _jax_setup():
    cfg = dataclasses.replace(jax_config("qwen2.5-3b", smoke=True), dtype=jnp.float32)
    model = JaxModel(cfg, JaxRuntime())
    return cfg, model, model.init(jax.random.key(0))


def _port_model(params, rt=None):
    cfg = dataclasses.replace(get_config("qwen2.5-3b", smoke=True), dtype=torch.float32)
    return params_from_jax(jax.tree.map(np.asarray, params), cfg, rt, device="cpu")


# The key bias gets a gradient that is zero in exact arithmetic (a shift
# of every key's score by q.bk leaves the softmax unchanged), so Adam
# turns rounding noise into steps of up to lr on it: the parameter
# comparison runs at lr 1e-3, where that noise stays below its 1e-4.
PARITY_LR = 1e-3


def test_train_step_one_process_matches_jax():
    cfg, jm, params = _jax_setup()
    tm = _port_model(params)
    jopt_cfg = JaxOpt(lr=PARITY_LR, warmup_steps=WARMUP)
    jstep, jinit = jax_train_step(jm, JaxTrainConfig(comm_mode="flat", opt=jopt_cfg))
    jopt = jinit(jax.random.key(0))[1]
    step_fn, _ = make_train_step(tm, TrainConfig(
        comm_mode="flat", opt=opt_lib.OptConfig(lr=PARITY_LR, warmup_steps=WARMUP)))
    opt = opt_lib.adam_init(opt_lib.flat_params(tm.train_leaves())[0])
    for i in range(N_STEPS):
        b = batch(i, cfg.vocab_size)
        params, jopt, jm_ = jstep(params, jopt, {k: jnp.asarray(v) for k, v in b.items()})
        m = step_fn(opt, {k: torch.from_numpy(v).long() for k, v in b.items()})
        assert not m["gated"]
        np.testing.assert_allclose(m["loss"], float(jm_["loss"]), rtol=1e-4)
        np.testing.assert_allclose(m["grad_norm"], float(jm_["grad_norm"]), rtol=1e-4)
    for got, want in zip(tm.train_leaves(), jax.tree.leaves(params)):
        got = torch.stack(got) if isinstance(got, list) else got
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4)


def test_train_step_four_ranks_hier_int8_matches_jax(tmp_path):
    _, _, params = _jax_setup()
    np.savez(tmp_path / "params.npz", **_flat_tree(jax.tree.map(np.asarray, params)))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join([str(ROOT / "src")]))
    jax_proc = subprocess.Popen([sys.executable, __file__, str(tmp_path)], env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_gloo_rank, args=(r, str(tmp_path / "store"), str(tmp_path)))
             for r in range(WORLD)]
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=240)
        jax_out, _ = jax_proc.communicate(timeout=240)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait(timeout=10)
    assert jax_proc.returncode == 0, jax_out.decode()[-3000:]
    assert [p.exitcode for p in procs] == [0] * WORLD
    want = np.load(tmp_path / "jax_losses.npy")
    for r in range(WORLD):
        got = np.load(tmp_path / f"rank{r}_losses.npy")
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("window", [None, 40])
def test_chunked_attention_matches_jax(window):
    rng = np.random.default_rng(7)
    q = rng.normal(size=(2, 70, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 70, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 70, 2, 16)).astype(np.float32)
    ct = rng.normal(size=q.shape).astype(np.float32)

    def jloss(q, k, v):
        out = jattn.chunked_attention(q, k, v, causal=True, window=window,
                                      q_offset=0, chunk=32)
        return jnp.sum(out * ct), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = tattn.chunked_attention(tq, tk, tv, causal=True, window=window, chunk=32)
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-5)
    for t, j in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=1e-5)


@pytest.mark.parametrize("step", [0, 5])
def test_synth_batch_is_the_reference(step):
    kw = dict(vocab_size=1000, global_batch=3, seq_len=17, seed=4)
    want = jpipe.synth_batch(jpipe.DataConfig(**kw), step)
    got = tpipe.synth_batch(tpipe.DataConfig(**kw), step)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def test_unported_comm_mode_raises():
    tm = _port_model(_jax_setup()[2])
    with pytest.raises(NotImplementedError, match="hier_zero1"):
        make_train_step(tm, TrainConfig(comm_mode="hier_zero1"))


def test_entry_point_smoke_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), GLOO_SOCKET_IFNAME="lo")
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--smoke",
                          "--device", "cpu", "--steps", "2", "--seq", "32",
                          "--compression", "int8"],
                         env=env, capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = [json.loads(line) for line in res.stdout.splitlines()]
    steps, summary = lines[:-1], lines[-1]
    assert [s["step"] for s in steps] == [0, 1]
    assert all(np.isfinite(s["loss"]) and np.isfinite(s["gnorm"]) and not s["gated"]
               for s in steps)
    assert summary["world"] == 1 and summary["mode"] == "hier"


def test_entry_point_needs_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--smoke", "--steps", "1"])
