"""The VLM family (chameleon-34b: a dense decoder with QK-norm, its VQ
image tokens ids of the shared vocabulary): the port against the JAX
package, f32 smoke chameleon-34b (2 layers, d_model 64, 8 Q / 2 KV heads)
unless a test says otherwise.

* The parameter-free per-head QK-norm (``rms_norm_head``, a property over
  shapes and scales), and one attention block's prefill (QK-norm between
  the reshape and RoPE) and decode.
* The whole model, parameters carried by ``params_from_jax``: prefill
  and decode (f32 logits within 1e-4 and equal greedy tokens; bf16 within
  tests/test_torch_model.py's 0.06 / 0.05), the training forward, and
  three ``hier`` + int8 steps in a world of one against the reference's
  step on a (1, 1, 1) mesh: losses and grad norms within 1e-4 (relative).
* The launcher's plan and leaf count, bit-equal to the reference's; the
  full-width parameter count (34,292,629,504 of ``param_count()`` plus the
  norms) and shardings, from shapes alone (FakeTensorMode).
* Eight gloo ranks, spawned once, as (pod 2, data 2, model 2) against the
  reference on 8 host devices (the JAX side runs this file as a script):
  serving at TP 2 (tokens equal, each rank's logits and KV shard within
  1e-4), and three ``hier`` + int8 training steps with sequence
  parallelism off and on: every rank's losses and grad norms within 1e-3
  of its own device's, its parameters within 2 lr, all but 0.1% within
  1e-4.
"""

import dataclasses
import datetime
import os
import sys

import numpy as np

ARCH = "chameleon-34b"
WORLD, GB, S, N_STEPS = 8, 4, 32, 3
LR, WARMUP = 1e-3, 1
TRAIN_CASES = [("hier", "int8", False), ("hier", "int8", True)]
TP, SB, SS, GEN = 2, 2, 24, 4
# chameleon-34b's ModelConfig.param_count() (tied to nothing: embed and
# lm_head both count); the port's tree adds the 2 L + 1 norm scales
FULL_PARAM_COUNT = 34_292_629_504


def case_id(mode: str, codec, sp: bool) -> str:
    return f"{mode}_{codec}{'_sp' if sp else ''}"


def batch(step: int, vocab: int) -> dict:
    rng = np.random.default_rng(600 + step)
    return {"tokens": rng.integers(0, vocab, (GB, S), dtype=np.int32),
            "labels": rng.integers(0, vocab, (GB, S), dtype=np.int32)}


def serve_prompt(vocab: int) -> np.ndarray:
    return np.random.default_rng(61).integers(0, vocab, (SB, SS), dtype=np.int32)


def _jax_main(out_dir: str, part: str) -> None:
    """The reference on 8 host devices: serving at TP 2 ("serve") or the
    training case of index ``part``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from _torch_world import nest
    from repro.configs import get_config as jax_config
    from repro.launch.mesh import runtime_for_mesh
    from repro.models import Model as JaxModel
    from repro.parallel import sharding as jsh
    from repro.serve import make_serve_steps as jax_serve_steps
    from repro.train import TrainConfig as JaxTrainConfig
    from repro.train import make_train_step as jax_train_step
    from repro.train import optimizer as jopt
    from repro.train.optimizer import OptConfig as JaxOpt

    cfg = dataclasses.replace(jax_config(ARCH, smoke=True), dtype=jnp.float32)
    params = jax.tree.map(jnp.asarray, nest(np.load(os.path.join(out_dir, "params.npz"))))
    shapes = jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape, p.dtype), params)
    out = {}
    if part == "serve":
        mesh = Mesh(np.array(jax.devices()[:TP]).reshape(1, TP), ("data", "model"))
        jm = JaxModel(cfg, runtime_for_mesh(mesh, use_pallas=True))
        prompt = jnp.asarray(serve_prompt(cfg.vocab_size))
        prefill, decode, _ = jax_serve_steps(jm, mesh, SB, SS)
        tok, caches = prefill(params, prompt)
        out["serve/k"], out["serve/v"] = np.array(caches.k), np.array(caches.v)
        toks = [np.asarray(tok)]
        for _ in range(GEN):
            tok, caches = decode(params, tok, caches)
            toks.append(np.asarray(tok))
        out["serve/tokens"] = np.concatenate(toks, axis=1)
        logits = jax.jit(jsh.shard_map(lambda p, t: jm.apply_prefill(p, t)[0], mesh=mesh,
                                       in_specs=(jm.param_specs(shapes), P()),
                                       out_specs=P(None, None, "model")))
        out["serve/logits"] = np.asarray(logits(params, prompt))
    else:
        mode, codec, sp = TRAIN_CASES[int(part)]
        mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
        order = list(mesh.devices.flat)             # rank (p * 2 + d) * 2 + m
        model = JaxModel(cfg, runtime_for_mesh(mesh, sp=sp))
        tcfg = JaxTrainConfig(comm_mode=mode, dcn_compression=codec,
                              opt=JaxOpt(lr=LR, warmup_steps=WARMUP))
        build, _ = jax_train_step(model, tcfg, mesh=mesh, donate=False)
        step, _ = build(shapes)
        specs, _ = jax.tree_util.tree_flatten_with_path(model.param_specs(shapes),
                                                        is_leaf=lambda x: isinstance(x, P))
        params = jax.tree.map(lambda p, s: jax.device_put(p, NamedSharding(mesh, s)), params,
                              model.param_specs(shapes))
        opt = jopt.adam_init(params)
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
    """One rank of the eight-rank world: serving at TP 2, then every
    training case."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist

    from _torch_world import nest
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.mesh import runtime_for_groups
    from repro_torch.launch.train import dp_rows
    from repro_torch.serve.serve_step import make_serve_steps
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import TrainConfig, make_train_step

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    out = {}
    try:
        cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=torch.float32)
        rt = runtime_for_groups(pods=2, data_per_pod=2, tp=TP)
        tree = nest(np.load(os.path.join(out_dir, "params.npz")))
        model = params_from_jax(tree, cfg, rt, device="cpu")
        prompt = torch.from_numpy(serve_prompt(cfg.vocab_size)).long()
        prefill, decode = make_serve_steps(model)
        tok, caches = prefill(prompt)
        out["serve/k"], out["serve/v"] = caches.k.numpy().copy(), caches.v.numpy().copy()
        toks = [tok]
        for _ in range(GEN):
            tok, caches = decode(tok, caches)
            toks.append(tok)
        out["serve/tokens"] = torch.cat(toks, dim=1).numpy()
        out["serve/logits"] = model.apply_prefill(prompt)[0].numpy()

        rows = dp_rows(rank, GB, 2, 2, TP)
        for mode, codec, sp in TRAIN_CASES:
            model = params_from_jax(tree, cfg, dataclasses.replace(rt, sp=sp), device="cpu")
            step_fn, _ = make_train_step(model, TrainConfig(
                comm_mode=mode, dcn_compression=codec,
                opt=opt_lib.OptConfig(lr=LR, warmup_steps=WARMUP)))
            opt = opt_lib.adam_init(opt_lib.flat_params(model.train_leaves())[0])
            metrics = []
            for i in range(N_STEPS):
                m = step_fn(opt, {k: torch.from_numpy(v[rows]).long()
                                  for k, v in batch(i, cfg.vocab_size).items()})
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


import json  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from _hypothesis_compat import hypothesis, st  # noqa: E402
from _torch_world import flat_tree, run_world  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import plan_cache as jcache  # noqa: E402
from repro.launch.mesh import runtime_for_mesh  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.parallel.sharding import Runtime as JaxRuntime  # noqa: E402
from repro.train import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.train import make_train_step as jax_train_step  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.optimizer import OptConfig as JaxOpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.mesh import runtime_for_groups  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.serve import disaggregated  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402
from repro_torch.train.train_step import TrainConfig, make_train_step  # noqa: E402
from test_torch_encdec import _global_shapes  # noqa: E402
from test_torch_planner import _reference_launcher_plan  # noqa: E402

F32_TOL = dict(rtol=1e-4, atol=1e-4)
DTYPES = {"f32": (jnp.float32, torch.float32, F32_TOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, dict(atol=0.06, rtol=0.05))}


def _cfgs(dt: str = "f32"):
    jdt, tdt, _ = DTYPES[dt]
    return (dataclasses.replace(jax_config(ARCH, smoke=True), dtype=jdt),
            dataclasses.replace(get_config(ARCH, smoke=True), dtype=tdt))


def _models(dt: str = "f32"):
    jc, tc = _cfgs(dt)
    jm = JaxModel(jc, JaxRuntime())
    params = jm.init(jax.random.key(0))
    return jc, jm, params, params_from_jax(jax.tree.map(np.asarray, params), tc, device="cpu")


def _np(t) -> np.ndarray:
    t = torch.as_tensor(t).detach()
    return (t.float() if t.is_floating_point() else t).numpy()


def _jnp(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32) if a.dtype == jnp.bfloat16 else a)


@pytest.fixture(scope="module")
def f32():
    return _models("f32")


# ---------------------------------------------------------------------------
# QK-norm
# ---------------------------------------------------------------------------

@hypothesis.given(rows=st.integers(1, 40), dh=st.sampled_from([16, 64, 128]),
                  scale=st.floats(1e-3, 1e3), bf16=st.booleans())
@hypothesis.settings(max_examples=25, deadline=None)
def test_rms_norm_head_matches_jax(rows, dh, scale, bf16):
    """f32 math with eps 1e-6, cast back: equal up to f32 rounding, and
    within one bf16 ulp for bf16 inputs."""
    x = (np.random.default_rng(rows * dh).normal(size=(2, rows, 3, dh)) * scale).astype(
        np.float32)
    if bf16:
        want = _jnp(jlayers.rms_norm_head(jnp.asarray(x, jnp.bfloat16)))
        got = tlayers.rms_norm_head(torch.from_numpy(x).bfloat16())
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got), want, rtol=2 ** -7, atol=0)
    else:
        want = np.asarray(jlayers.rms_norm_head(jnp.asarray(x)))
        got = tlayers.rms_norm_head(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("S", [16, 130])
def test_attention_with_qk_norm_matches_jax(f32, S):
    """Layer 0's attention block: the prefill (QK-norm on q and k after the
    reshape, then RoPE; 130 queries take the flash path, its plain version
    on the CPU), its cache, and one decode step from it."""
    jc, _, params, tm = f32
    rng = np.random.default_rng(S)
    h = rng.normal(size=(2, S, jc.d_model)).astype(np.float32)
    x1 = rng.normal(size=(2, 1, jc.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], params["layers"]["attn"])
    jrt = JaxRuntime(use_pallas=True, pallas_interpret=True)
    jout, jcache = jattn.attention_prefill(jp, jnp.asarray(h), jc, jrt,
                                           jattn.make_cache(jc, 2, 1, S + 1, jnp.float32))
    tcache = tattn.make_cache(tm.cfg, 1, 2, 1, S + 1, torch.float32, "cpu").layer(0)
    with torch.inference_mode():
        tout, tcache = tattn.attention_prefill(tm.layers[0]["attn"], torch.from_numpy(h),
                                               tm.cfg, tm.rt, tcache)
    np.testing.assert_allclose(_np(tout), np.asarray(jout), **F32_TOL)
    np.testing.assert_allclose(_np(tcache.k), np.asarray(jcache.k), **F32_TOL)
    jd, _ = jattn.attention_decode(jp, jnp.asarray(x1), jc, jrt, jcache)
    with torch.inference_mode():
        td, _ = tattn.attention_decode(tm.layers[0]["attn"], torch.from_numpy(x1), tm.cfg,
                                       tm.rt, tcache)
    np.testing.assert_allclose(_np(td), np.asarray(jd), **F32_TOL)
    # the cached keys are normalized per head (before RoPE, which keeps the norm)
    norms = np.linalg.norm(_np(tcache.k)[:, :S], axis=-1)
    np.testing.assert_allclose(norms, np.sqrt(jc.head_dim), rtol=1e-3)


# ---------------------------------------------------------------------------
# The whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [16, 130])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_prefill_decode_vs_jax(dt, S):
    tol = DTYPES[dt][2]
    jc, jm, params, tm = _models(dt)
    toks = np.random.default_rng(S).integers(0, jc.vocab_size, (2, S + 4))
    jl, jcache = jax.jit(jm.apply_prefill)(params, jnp.asarray(toks[:, :S], jnp.int32))
    tl, tcache = tm.apply_prefill(torch.from_numpy(toks[:, :S]))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **tol)
    np.testing.assert_allclose(_np(tcache.k), _jnp(jcache.k), **tol)
    if dt == "f32":
        assert (tl.argmax(-1).numpy() == np.asarray(jl).argmax(-1)).all()
    dec = jax.jit(jm.apply_decode)
    for i in range(4):
        step = toks[:, S + i:S + i + 1]
        jl, jcache = dec(params, jnp.asarray(step, jnp.int32), jcache)
        tl, tcache = tm.apply_decode(torch.from_numpy(step), tcache)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **tol, err_msg=f"decode step {i}")
        if dt == "f32":
            assert (tl.argmax(-1).numpy() == np.asarray(jl).argmax(-1)).all()
    np.testing.assert_array_equal(_np(tcache.length), np.asarray(jcache.length))


def test_training_forward_matches_jax(f32):
    jc, jm, params, tm = f32
    b = batch(0, jc.vocab_size)
    want, _ = jax.jit(jm.apply_train)(params, jnp.asarray(b["tokens"]))
    got, _ = tm.apply_train(torch.from_numpy(b["tokens"]).long())
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)


@pytest.fixture(scope="module")
def world_of_one():
    started = not dist.is_initialized()
    if started:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    yield
    if started:
        dist.destroy_process_group()


def test_hier_int8_training_matches_jax(world_of_one):
    """Three ``hier`` + int8 steps in a world of one (the codec runs over
    pod and data groups of one member) against the reference's step on a
    (1, 1, 1) mesh."""
    jc, tc = _cfgs("f32")
    mesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"))
    jm = JaxModel(jc, runtime_for_mesh(mesh))
    params = jm.init(jax.random.key(0))
    tm = params_from_jax(jax.tree.map(np.asarray, params), tc,
                         runtime_for_groups(pods=1, data_per_pod=1, tp=1), device="cpu")
    ocfg = dict(lr=LR, warmup_steps=WARMUP)
    build, _ = jax_train_step(jm, JaxTrainConfig(comm_mode="hier", dcn_compression="int8",
                                                 opt=JaxOpt(**ocfg)), mesh=mesh, donate=False)
    jstep, _ = build(jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape, p.dtype), params))
    jstate = jopt.adam_init(params)
    step_fn, _ = make_train_step(tm, TrainConfig(comm_mode="hier", dcn_compression="int8",
                                                 opt=opt_lib.OptConfig(**ocfg)))
    opt = opt_lib.adam_init(opt_lib.flat_params(tm.train_leaves())[0])
    for i in range(N_STEPS):
        b = batch(i, jc.vocab_size)
        params, jstate, jm_ = jstep(params, jstate, {k: jnp.asarray(v) for k, v in b.items()})
        m = step_fn(opt, {k: torch.from_numpy(v).long() for k, v in b.items()})
        assert not m["gated"]
        np.testing.assert_allclose(m["loss"], float(jm_["loss"]), rtol=1e-4)
        np.testing.assert_allclose(m["grad_norm"], float(jm_["grad_norm"]), rtol=1e-4)


# ---------------------------------------------------------------------------
# Plans and the full width
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("pods, world, mode, codec, plan, skew",
                         [(2, 8, "hier", "int8", "auto", "auto"),
                          (1, 4, "hier_zero1", "int8", "auto", "none")])
def test_make_plan_is_the_reference_launchers(smoke, pods, world, mode, codec, plan, skew):
    cfg = get_config(ARCH, smoke=smoke)
    shapes = jax.eval_shape(JaxModel(jax_config(ARCH, smoke=smoke), JaxRuntime()).init,
                            jax.random.key(0))
    n_leaves = len(jax.tree.leaves(shapes))
    assert train_cli.n_train_leaves(cfg) == n_leaves
    got = train_cli.make_plan(cfg, pods, world, mode, codec, plan=plan, skew=skew,
                              log=lambda line: None)
    want, wmode, wpacked, wweights, *_ = _reference_launcher_plan(
        ARCH, n_leaves, pods, world, mode, codec, plan, skew, jcache.PlanCache(), smoke=smoke)
    assert (got.mode, got.packed, got.cluster_weights) == (
        wmode, wpacked, None if wweights is None else tuple(wweights))
    assert got.plan.summary() == want.summary()
    assert got.plan.describe() == want.describe()


@pytest.mark.parametrize("tp", [1, 8])
def test_full_width_shapes_and_specs_are_the_references(tp):
    """chameleon-34b at full width, drawn under FakeTensorMode (nothing
    allocated): 34,292,629,504 parameters plus 97 norm scales of 8192, and
    every leaf's global shape and sharding (TP ``tp``) as the reference's
    ``param_specs`` of its ``eval_shape``."""
    cfg, jc = get_config(ARCH), jax_config(ARCH)
    jm = JaxModel(jc, JaxRuntime(tp_axis="model" if tp > 1 else None, tp_size=tp))
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    specs_tree = jm.param_specs(shapes)
    want = {"/".join(str(k.key) for k in path): (leaf.shape, tuple(spec))
            for (path, spec), leaf in zip(
                jax.tree_util.tree_flatten_with_path(
                    specs_tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0],
                jax.tree.leaves(shapes))}
    with FakeTensorMode():
        m = Model(cfg, device="cpu").init(0)
        n = sum(p.numel() for p in m.parameters())
        tree = tmodel.pad_vocab(m.param_tree(), cfg, tp)
        specs = tmodel.param_specs(tree, cfg, tp)
    assert n == FULL_PARAM_COUNT + (2 * cfg.n_layers + 1) * cfg.d_model
    assert cfg.param_count() == FULL_PARAM_COUNT
    glob = _global_shapes(tree)
    got = {"/".join(p): (glob[p], s) for p, s in specs.items()}
    assert got == {k: (tuple(s), sp) for k, (s, sp) in want.items()}


def test_entry_points_on_cpu(capsys, world_of_one):
    disaggregated.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--prompt-len", "40",
                        "--gen", "4"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cfg = get_config(ARCH, smoke=True)
    kv = [cfg.n_layers, res["batch"], 40, cfg.n_kv_heads, cfg.head_dim]
    assert res["cache_shapes"] == {"k": kv, "v": kv, "length": [cfg.n_layers]}
    assert res["raw_transfer_exact"] and res["cache_finite"]
    train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2", "--seq", "32",
                    "--compression", "int8", "--layers", "1"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert [x["step"] for x in lines[:-1]] == [0, 1]
    assert all(np.isfinite(x["loss"]) and not x["gated"] for x in lines[:-1])
    cut = dataclasses.replace(cfg, n_layers=1)
    assert lines[-1]["params"] == cut.param_count() + 3 * cfg.d_model


# ---------------------------------------------------------------------------
# Eight gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Serving and both training cases on 8 gloo ranks and in JAX on 8 host
    devices, one process per part: (the reference's results, each rank's)."""
    tmp = tmp_path_factory.mktemp("vlm_world")
    jc, _ = _cfgs("f32")
    params = JaxModel(jc, JaxRuntime(tp_axis="model", tp_size=TP)).init(jax.random.key(0))
    np.savez(tmp / "params.npz", **flat_tree(jax.tree.map(np.asarray, params)))
    parts = ("serve",) + tuple(str(i) for i in range(len(TRAIN_CASES)))
    return run_world(__file__, tmp, parts, WORLD, _gloo_rank, WORLD)


def test_serving_at_tp2_matches_jax(results):
    want, ranks = results
    for rank, got in enumerate(ranks):
        r = rank % TP
        np.testing.assert_array_equal(got["serve/tokens"], want["serve/tokens"])
        vl = got["serve/logits"].shape[-1]
        np.testing.assert_allclose(got["serve/logits"],
                                   want["serve/logits"][..., r * vl:(r + 1) * vl], **F32_TOL)
        for name in ("k", "v"):
            # the reference's f32 KV cache carries the TP shards along W (R13)
            a = want[f"serve/{name}"]
            n = a.shape[2] // TP
            np.testing.assert_allclose(got[f"serve/{name}"], a[:, :, r * n:(r + 1) * n],
                                       **F32_TOL, err_msg=f"rank {rank} {name}")


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
