"""The port's examples (``examples/torch_*.py``) against the JAX package's
(``examples/*.py``), on the CPU.

* Quickstart (``--device cpu``, 8 spawned gloo ranks as 2 pods x 2 data
  x 2 model): the four synced buffers within 1e-5 of the largest value
  of the reference's (``examples/quickstart.py`` run whole on 8 host
  devices), every printed line text-equal to the reference's (the
  comparisons, the int8 error at the four decimals printed, and the cost
  model's lines through the port's copies of ``cost_model`` and
  ``topology``).
* Serve: the example's steps (``disaggregate``) on 8 gloo ranks in f32,
  with the parameters of the reference example's draw (``init(key(0))``,
  f32) converted by ``repro_torch/convert.py`` and its prompt
  (``randint(key(1))``), against the same reference calls
  (``make_test_mesh``, ``make_serve_steps``, ``make_kv_transfer``,
  ``kv_transfer_body``) on 8 host devices in f32: the prefill tokens and
  the same-pod, disaggregated and int8 generations equal token for token,
  at the reference's 16-token prompts (every cache leaf under the
  codec's block, so int8 moves them raw) and at 128 (k and v cross as
  int8 blocks); the disaggregated generation is same-pod's with the
  halves swapped.
* train_lm: demo-20m for 3 steps on the CPU (the example asserts that
  the loss falls), its printed parameter count equal to the reference
  config's ``param_count()`` (both configs' counts equal); ``--mesh test
  --mode fsdp --compression int8`` for 2 steps on 8 gloo ranks.  Each
  run is a subprocess of its own.
"""

import contextlib
import dataclasses
import datetime
import io
import os
import pathlib
import runpy
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
WORLD = 8
PROMPTS = (16, 128)
PATHS = ("prefill", "same_pod", "disaggregated", "int8")


def _jax_main(out_dir: str, part: str) -> None:
    if part == "quickstart":
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            g = runpy.run_path(str(EXAMPLES / "quickstart.py"))
        np.savez(os.path.join(out_dir, f"jax_{part}.npz"),
                 lines=np.asarray(out.getvalue().splitlines()),
                 **{name: np.asarray(g[key]) for name, key in (
                     ("flat", "flat"), ("hier", "hier"), ("hier_pipelined", "pipe"),
                     ("int8", "comp"))})
        return
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from _torch_world import flat_tree
    from repro.configs import get_config
    from repro.launch.mesh import make_test_mesh, runtime_for_mesh
    from repro.models import Model
    from repro.parallel.sharding import shard_map
    from repro.serve import make_kv_transfer, make_serve_steps
    from repro.serve.serve_step import kv_transfer_body

    B, GEN = 4, 8
    mesh = make_test_mesh()
    rt = runtime_for_mesh(mesh, moe_capacity_factor=8.0)
    cfg = dataclasses.replace(get_config("qwen2.5-3b", smoke=True), dtype=jnp.float32)
    model = Model(cfg, rt)
    params = model.init(jax.random.key(0))
    res = flat_tree(jax.tree.map(np.asarray, params), "params/")
    tok_move = jax.jit(shard_map(
        functools.partial(kv_transfer_body, rt=rt), mesh=mesh,
        in_specs=(P(("pod", "data")),), out_specs=P(("pod", "data")), check_vma=False))
    for S in PROMPTS:
        prompt = jax.random.randint(jax.random.key(1), (B, S), 0, cfg.vocab_size)
        prefill, decode, caches_shape = make_serve_steps(model, mesh, B, S + GEN)
        transfer = make_kv_transfer(model, mesh, caches_shape, B)
        transfer_q = make_kv_transfer(model, mesh, caches_shape, B, compress="int8")
        tok, caches = prefill(params, prompt)
        moved, moved_q = transfer(caches), transfer_q(caches)
        tok_moved = tok_move(tok[:, :1])
        res[f"{S}/prompt"] = np.asarray(prompt)
        res[f"{S}/prefill"] = np.asarray(tok[:, 0])
        for path, (t, c) in (("same_pod", (tok, caches)), ("disaggregated", (tok_moved, moved)),
                             ("int8", (tok_moved, moved_q))):
            toks = []
            for _ in range(GEN):
                toks.append(np.asarray(t[:, 0]))
                t, c = decode(params, t[:, :1], c)
            res[f"{S}/{path}"] = np.stack(toks)
    np.savez(os.path.join(out_dir, f"jax_{part}.npz"), **res)


def _serve_rank(rank: int, store_path: str, out_dir: str) -> None:
    """One rank: the example's steps on the reference's converted f32
    parameters and prompts (the JAX side has written them)."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(EXAMPLES))
    import torch_serve_disaggregated as ex
    from _torch_world import nest
    from repro_torch.convert import params_from_jax

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    try:
        ref = np.load(os.path.join(out_dir, "jax_serve.npz"))
        tree = nest({k[len("params/"):]: ref[k] for k in ref.files if k.startswith("params/")})
        model = params_from_jax(tree, ex.smoke_config(f32=True), ex.world_runtime(), device="cpu")
        res = {}
        for S in PROMPTS:
            prompt = torch.from_numpy(ref[f"{S}/prompt"]).long()[ex.my_rows(rank)]
            out = ex.disaggregate(model, prompt)
            for path in PATHS:
                res[f"{S}/{path}"] = out[path]
            res[f"{S}/int8_leaves"] = np.asarray(out["int8_leaves"])
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    _jax_main(sys.argv[1], sys.argv[2])
    sys.exit(0)


import threading  # noqa: E402

import pytest  # noqa: E402

from _torch_world import run_world  # noqa: E402

sys.path.insert(0, str(EXAMPLES))
import torch_quickstart  # noqa: E402
import torch_serve_disaggregated  # noqa: E402
import torch_train_lm  # noqa: E402

TRAIN_RUNS = {"demo": ["--steps", "3"],
              "mesh": ["--steps", "2", "--mesh", "test", "--mode", "fsdp",
                       "--compression", "int8"]}


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """Everything at once: the train_lm subprocesses, and in a thread the
    reference's two parts with the serve ranks after them."""
    tmp = tmp_path_factory.mktemp("examples")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {name: subprocess.Popen(
        [sys.executable, str(EXAMPLES / "torch_train_lm.py"), "--device", "cpu",
         "--ckpt-dir", str(tmp / f"ckpt_{name}"), *argv], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, argv in TRAIN_RUNS.items()}
    out: dict = {}

    def world():
        try:
            out["world"] = run_world(__file__, tmp, ("quickstart", "serve"), WORLD,
                                     _serve_rank, WORLD, ranks_after_jax=True)
        except BaseException as e:  # noqa: BLE001 - re-raised in the test thread
            out["error"] = e

    thread = threading.Thread(target=world)
    thread.start()
    yield procs, thread, out
    thread.join(timeout=600)
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait(timeout=10)


@pytest.fixture(scope="module")
def reference(started):
    _, thread, out = started
    thread.join(timeout=600)
    assert not thread.is_alive(), "the reference's side and the serve ranks did not end"
    if "error" in out:
        raise out["error"]
    return out["world"]


@pytest.fixture(scope="module")
def quickstart(started):
    """The port's quickstart on the CPU, in this process (its 8 ranks
    spawned beside the reference's side), and its printed lines."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = torch_quickstart.main(["--device", "cpu"])
    return res, out.getvalue().splitlines()


@pytest.fixture(scope="module")
def trained(started):
    procs = started[0]
    return {name: (p.communicate(timeout=600)[0], p.returncode) for name, p in procs.items()}


@pytest.mark.parametrize("sync", ["flat", "hier", "hier_pipelined", "int8"])
def test_quickstart_buffers_match_the_reference(quickstart, reference, sync):
    res, _ = quickstart
    want, _ = reference
    got, ref = res["synced"][sync].numpy(), want[sync]
    assert got.shape == ref.shape == (2, 1 << 16)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_quickstart_prints_the_references_lines(quickstart, reference):
    res, printed = quickstart
    want, _ = reference
    assert printed == res["lines"] == [str(line) for line in want["lines"]]
    assert printed[2] == "int8-compressed DCN hop mean rel err: 0.0355"
    assert printed[-1] == "  speedup vs host-forwarding: 2.3x"
    assert res["launches"][0] == {"flat": {}, "hier": {}, "hier_pipelined": {}, "int8": {}}


@pytest.mark.parametrize("prompt", PROMPTS)
@pytest.mark.parametrize("path", PATHS)
def test_serve_tokens_equal_the_references(reference, prompt, path):
    want, ranks = reference
    tokens = torch_serve_disaggregated.gather([{p: r[f"{prompt}/{p}"] for p in PATHS}
                                               for r in ranks])
    np.testing.assert_array_equal(tokens[path], want[f"{prompt}/{path}"])
    if path == "disaggregated":
        np.testing.assert_array_equal(torch_serve_disaggregated.swap_halves(
            tokens["same_pod"]), tokens["disaggregated"])


@pytest.mark.parametrize("prompt, leaves", [(16, []), (128, ["k", "v"])])
def test_serve_int8_leaves(reference, prompt, leaves):
    _, ranks = reference
    for r in ranks:
        assert r[f"{prompt}/int8_leaves"].tolist() == leaves


def _reference_train_lm():
    return runpy.run_path(str(EXAMPLES / "train_lm.py"))


def test_train_lm_config_counts_match_the_reference():
    ref = _reference_train_lm()
    for hundred_m in (False, True):
        assert (torch_train_lm.make_config(hundred_m).param_count()
                == ref["make_config"](hundred_m).param_count())


def test_train_lm_demo_runs_and_its_loss_falls(trained):
    text, rc = trained["demo"]
    assert rc == 0, text[-3000:]
    n = _reference_train_lm()["make_config"](False).param_count()
    assert f"model demo-20m: {n/1e6:.1f}M params" in text.splitlines()
    final = [line for line in text.splitlines() if line.startswith("final loss")]
    assert final and "over 3 steps" in final[0]


def test_train_lm_on_the_test_mesh(trained):
    text, rc = trained["mesh"]
    assert rc == 0, text[-3000:]
    summary = [line for line in text.splitlines() if line.startswith('{"arch"')]
    assert len(summary) == 1, "rank 0 alone prints"
    assert '"world": 8, "pods": 2, "tp": 2' in summary[0]
    assert '"mode": "fsdp", "compression": "int8"' in summary[0]
    assert [line for line in text.splitlines() if line.startswith("final loss")]
