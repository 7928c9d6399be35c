"""The encoder-decoder family (whisper-tiny): the port against the JAX
package, f32 smoke whisper-tiny (2 encoder and 2 decoder layers, d_model
64, 4 heads, 30 frames) unless a test says otherwise.

* The pieces: the GELU MLP (tanh GELU, ``b2`` after the reduce), the
  sinusoidal encoder positions, the encoder stack (in training, and in
  serving through the flash path's plain version on the CPU), the
  cross-attention prefill and decode, and the caches of ``make_caches``.
* The whole model, parameters carried by ``params_from_jax``: prefill
  and decode (f32 logits within 1e-4 and equal greedy tokens; bf16 within
  tests/test_torch_model.py's 0.06 / 0.05), the training forward, the
  int8 transfer of the (self, cross) cache bit-equal to the reference's,
  and three ``hier`` + int8 steps in a world of one against the
  reference's step on a (1, 1, 1) mesh: losses and grad norms within
  1e-4 (relative).  The data batches, frames included, are bit-equal to
  the reference's.
* The launcher's plan and leaf count, bit-equal to the reference's; the
  runtime's leaf names; the full-width shapes (under FakeTensorMode).
* Eight gloo ranks, spawned once, as (pod 2, data 2, model 2) against the
  reference on 8 host devices (the JAX side runs this file as a script):
  serving at TP 2 (tokens equal, each rank's logits and cache shards
  within 1e-4, the int8 transfer over the real pod group), and three
  training steps each of ``hier`` + int8, ``hier`` + int8 with sequence
  parallelism (ROADMAP R22: the reference's encoder then runs on a
  sequence gathered tp-fold, so it computes another function; the port
  mirrors it; ``hier_overlap`` with SP is refused by name, as its unread
  ``b2`` would never fill its bucket) and ``fsdp`` + int8 at d_ff 1024
  (the encoder has FSDP dims of its own): every rank's losses and grad
  norms within 1e-3 of its own device's, its parameters within 2 lr, all
  but 0.1% within 1e-4.
* whisper-tiny at TP 4 builds its 6 heads padded to 8 (2 Q / 2 KV a
  rank); ``tests/test_torch_padding.py`` serves it.
"""

import dataclasses
import datetime
import os
import sys

import numpy as np

ARCH = "whisper-tiny"
WORLD, GB, S, N_STEPS = 8, 4, 32, 3
LR, WARMUP = 1e-3, 1
FSDP_D_FF = 1024      # w1 at TP 2: 2 x 64 x 512 = 2^16 values, sharded over data too
# (comm mode, pod-hop codec, sequence parallelism) of the eight-rank runs
TRAIN_CASES = [("hier", "int8", False), ("hier", "int8", True), ("fsdp", "int8", False)]
TP, SB, SS, GEN = 2, 2, 24, 4
CACHE_LEAVES = (("kv", "k"), ("kv", "v"), ("kv", "length"), ("cross", "k"), ("cross", "v"),
                ("cross", "length"))


def case_id(mode: str, codec, sp: bool) -> str:
    return f"{mode}_{codec}{'_sp' if sp else ''}"


def batch(step: int, vocab: int, enc_seq: int, d_model: int) -> dict:
    rng = np.random.default_rng(500 + step)
    return {"tokens": rng.integers(0, vocab, (GB, S), dtype=np.int32),
            "labels": rng.integers(0, vocab, (GB, S), dtype=np.int32),
            "enc": rng.normal(size=(GB, enc_seq, d_model)).astype(np.float32)}


def serve_inputs(vocab: int, enc_seq: int, d_model: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(41)
    return (rng.integers(0, vocab, (SB, SS), dtype=np.int32),
            rng.normal(size=(SB, enc_seq, d_model)).astype(np.float32))


def _cache_shard(a: np.ndarray, r: int, name: str) -> np.ndarray:
    """Device r's shard of the reference's global cache leaf: its f32 5-D
    leaves carry the TP shards along dim 2 (ROADMAP R13), the lengths are
    replicated."""
    if name == "length":
        return a
    n = a.shape[2] // TP
    return a[:, :, r * n:(r + 1) * n]


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

    base = dataclasses.replace(jax_config(ARCH, smoke=True), dtype=jnp.float32)
    out = {}
    if part == "serve":
        mesh = Mesh(np.array(jax.devices()[:TP]).reshape(1, TP), ("data", "model"))
        jm = JaxModel(base, runtime_for_mesh(mesh, use_pallas=True))
        params = jax.tree.map(jnp.asarray, nest(np.load(os.path.join(out_dir, "params_base.npz"))))
        prompt, frames = (jnp.asarray(a) for a in serve_inputs(base.vocab_size, base.enc_seq,
                                                               base.d_model))
        prefill, decode, _ = jax_serve_steps(jm, mesh, SB, SS)
        tok, caches = prefill(params, prompt, frames)
        for p, n in CACHE_LEAVES:
            out[f"serve/{p}/{n}"] = np.array(getattr(caches[0 if p == "kv" else 1], n))
        toks = [np.asarray(tok)]
        for _ in range(GEN):
            tok, caches = decode(params, tok, caches)
            toks.append(np.asarray(tok))
        out["serve/tokens"] = np.concatenate(toks, axis=1)
        pspecs = jm.param_specs(jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape, p.dtype),
                                             params))
        logits = jax.jit(jsh.shard_map(lambda p, t, e: jm.apply_prefill(p, t, e)[0], mesh=mesh,
                                       in_specs=(pspecs, P(), P()),
                                       out_specs=P(None, None, "model")))
        out["serve/logits"] = np.asarray(logits(params, prompt, frames))
    else:
        mode, codec, sp = TRAIN_CASES[int(part)]
        fsdp = mode == "fsdp"
        cfg = dataclasses.replace(base, d_ff=FSDP_D_FF) if fsdp else base
        mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
        order = list(mesh.devices.flat)             # rank (p * 2 + d) * 2 + m
        model = JaxModel(cfg, runtime_for_mesh(mesh, fsdp=fsdp, sp=sp))
        if fsdp:
            model = model.with_fsdp(2)
        params = jax.tree.map(jnp.asarray, nest(np.load(
            os.path.join(out_dir, f"params_{'fsdp' if fsdp else 'base'}.npz"))))
        tcfg = JaxTrainConfig(comm_mode=mode, dcn_compression=codec,
                              opt=JaxOpt(lr=LR, warmup_steps=WARMUP))
        build, _ = jax_train_step(model, tcfg, mesh=mesh, donate=False)
        shapes = jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape, p.dtype), params)
        step, _ = build(shapes)
        specs, _ = jax.tree_util.tree_flatten_with_path(model.param_specs(shapes),
                                                        is_leaf=lambda x: isinstance(x, P))
        params = jax.tree.map(lambda p, s: jax.device_put(p, NamedSharding(mesh, s)), params,
                              model.param_specs(shapes))
        opt = jopt.adam_init(params)
        key = case_id(mode, codec, sp)
        metrics = np.zeros((len(order), N_STEPS, 2))
        for i in range(N_STEPS):
            b = {k: jnp.asarray(v) for k, v in batch(i, cfg.vocab_size, cfg.enc_seq,
                                                     cfg.d_model).items()}
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
    """One rank of the eight-rank world: serving at TP 2 with the int8
    transfer over its pod group, then every training case."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist

    from _torch_world import nest
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.core import compression
    from repro_torch.launch.mesh import runtime_for_groups
    from repro_torch.launch.train import dp_rows
    from repro_torch.serve.serve_step import cache_leaves, make_kv_transfer, make_serve_steps
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import TrainConfig, make_train_step

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    out = {}
    try:
        base = dataclasses.replace(get_config(ARCH, smoke=True), dtype=torch.float32)
        rt = runtime_for_groups(pods=2, data_per_pod=2, tp=TP)
        trees = {name: nest(np.load(os.path.join(out_dir, f"params_{name}.npz")))
                 for name in ("base", "fsdp")}

        model = params_from_jax(trees["base"], base, rt, device="cpu")
        prompt, frames = (torch.from_numpy(a) for a in serve_inputs(
            base.vocab_size, base.enc_seq, base.d_model))
        prompt = prompt.long()
        prefill, decode = make_serve_steps(model)
        tok, caches = prefill(prompt, frames)
        for name, leaf in cache_leaves(caches):
            out[f"serve/{name.replace('.', '/')}"] = leaf.numpy().copy()
        # the int8 transfer from the other pod's rank at this (data, model)
        # index, which holds the same cache shard
        moved = make_kv_transfer(model, compress="int8")(caches)
        for (name, got), (_, sent) in zip(cache_leaves(moved), cache_leaves(caches)):
            if name.endswith("length"):
                want = sent
            else:
                q, s = compression.quantize_int8(sent)
                want = compression.dequantize_int8(q, s, sent.numel(), sent.dtype)
            out[f"moved/{name}"] = np.asarray(torch.equal(got.reshape(-1), want.reshape(-1)))
        toks = [tok]
        for _ in range(GEN):
            tok, caches = decode(tok, caches)
            toks.append(tok)
        out["serve/tokens"] = torch.cat(toks, dim=1).numpy()
        out["serve/logits"] = model.apply_prefill(prompt, frames)[0].numpy()

        rows = dp_rows(rank, GB, 2, 2, TP)
        for mode, codec, sp in TRAIN_CASES:
            fsdp = mode == "fsdp"
            cfg = dataclasses.replace(base, d_ff=FSDP_D_FF) if fsdp else base
            case_rt = dataclasses.replace(rt, sp=sp, fsdp_group=rt.data_group if fsdp else None)
            model = params_from_jax(trees["fsdp" if fsdp else "base"], cfg, case_rt,
                                    device="cpu", fsdp=2 if fsdp else 1)
            step_fn, _ = make_train_step(model, TrainConfig(
                comm_mode=mode, dcn_compression=codec,
                opt=opt_lib.OptConfig(lr=LR, warmup_steps=WARMUP)))
            opt = opt_lib.adam_init(opt_lib.flat_params(model.train_leaves())[0])
            metrics = []
            for i in range(N_STEPS):
                b = batch(i, cfg.vocab_size, cfg.enc_seq, cfg.d_model)
                m = step_fn(opt, {k: torch.from_numpy(v[rows]).to(
                    torch.long if k != "enc" else torch.float32) for k, v in b.items()})
                assert not m["gated"]
                metrics.append((m["loss"], m["grad_norm"]))
            key = case_id(mode, codec, sp)
            out[f"{key}/metrics"] = np.asarray(metrics)
            if sp:
                try:
                    make_train_step(model, TrainConfig(comm_mode="hier_overlap"))
                    out["overlap_sp_refusal"] = np.asarray("")
                except NotImplementedError as e:
                    out["overlap_sp_refusal"] = np.asarray(str(e))
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
import torch.nn.functional as F  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from _torch_world import flat_tree, run_world  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.launch.mesh import runtime_for_mesh  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import transformer as jtrans  # noqa: E402
from repro.parallel.sharding import Runtime as JaxRuntime  # noqa: E402
from repro.serve import make_kv_transfer as jax_kv_transfer  # noqa: E402
from repro.serve import make_serve_steps as jax_serve_steps  # noqa: E402
from repro.train import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.train import make_train_step as jax_train_step  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.optimizer import OptConfig as JaxOpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax, to_tensor  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.mesh import runtime_for_groups  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import transformer as ttrans  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402
from repro_torch.models.model import EncDecCache  # noqa: E402
from repro_torch.parallel.sharding import Runtime  # noqa: E402
from repro_torch.runtime import tree as tree_lib  # noqa: E402
from repro_torch.serve import disaggregated  # noqa: E402
from repro_torch.serve.serve_step import make_kv_transfer  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402
from repro_torch.train.train_step import TrainConfig, make_train_step, state_tree  # noqa: E402
from test_torch_planner import _reference_launcher_plan  # noqa: E402
from test_torch_tp import _RankRt  # noqa: E402
from repro.core import plan_cache as jcache  # noqa: E402

F32_TOL = dict(rtol=1e-4, atol=1e-4)
DTYPES = {"f32": (jnp.float32, torch.float32, F32_TOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, dict(atol=0.06, rtol=0.05))}


def _cfgs(dt: str = "f32", **overrides):
    jdt, tdt, _ = DTYPES[dt]
    return (dataclasses.replace(jax_config(ARCH, smoke=True), dtype=jdt, **overrides),
            dataclasses.replace(get_config(ARCH, smoke=True), dtype=tdt, **overrides))


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


def _t(a) -> torch.Tensor:
    return to_tensor(np.asarray(a), "cpu")


@pytest.fixture(scope="module")
def f32():
    return _models("f32")


# ---------------------------------------------------------------------------
# The pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 5, 64), (1, 3, 384)])
def test_gelu_mlp_matches_jax_tanh_gelu(shape):
    """w1/b1, tanh GELU, w2, then b2 (non-zero here); the erf GELU would
    be off by more than the tolerance."""
    rng = np.random.default_rng(3)
    d = shape[-1]
    p = {"w1": rng.normal(size=(d, 4 * d)) / np.sqrt(d), "b1": rng.normal(size=4 * d),
         "w2": rng.normal(size=(4 * d, d)) / np.sqrt(4 * d), "b2": rng.normal(size=d)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = (rng.normal(size=shape) * 2).astype(np.float32)
    want = np.asarray(jtrans.apply_gelu_mlp({k: jnp.asarray(v) for k, v in p.items()},
                                            jnp.asarray(x), JaxRuntime()))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = ttrans.apply_gelu_mlp(tp, torch.from_numpy(x), Runtime()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    erf = (F.gelu(torch.from_numpy(x) @ tp["w1"] + tp["b1"]) @ tp["w2"] + tp["b2"]).numpy()
    assert np.abs(erf - want).max() > 1e-4


@pytest.mark.parametrize("S, d", [(30, 64), (1500, 384)])
def test_sinusoidal_matches_jax(S, d):
    np.testing.assert_allclose(tmodel._sinusoidal(S, d, "cpu").numpy(),
                               np.asarray(jmodel._sinusoidal(S, d)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("frames", [30, 130])
@pytest.mark.parametrize("serving", [False, True])
def test_encoder_matches_jax(f32, frames, serving):
    """The encoder (sinusoidal positions, the stack, its norm) on frame
    embeddings: in training (autograd, plain attention) and in serving
    (``inference_mode``: 130 frames take the flash path, its plain version
    on the CPU)."""
    jc, jm, params, tm = f32
    enc = np.random.default_rng(frames).normal(size=(2, frames, jc.d_model)).astype(np.float32)
    fdims = jax.tree.map(lambda _: -1, params["enc_layers"])
    want = jax.jit(lambda p, e: jm._encode(p, e, fdims))(params, jnp.asarray(enc))
    ctx = torch.inference_mode() if serving else torch.enable_grad()
    with ctx:
        got = tm._encode(torch.from_numpy(enc))
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("S", [16, 130])
def test_cross_attention_prefill_and_decode_match_jax(f32, S):
    """Layer 0's cross-attention block: the prefill's output and its cache
    (the encoder's K/V, length enc_seq), then a decode step over that
    read-only cache; the 130-query prefill takes the flash path
    (non-causal, 130 x 30)."""
    jc, jm, params, tm = f32
    rng = np.random.default_rng(S)
    h = rng.normal(size=(2, S, jc.d_model)).astype(np.float32)
    enc = rng.normal(size=(2, jc.enc_seq, jc.d_model)).astype(np.float32)
    x1 = rng.normal(size=(2, 1, jc.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], params["layers"]["cross"])
    jrt = JaxRuntime(use_pallas=True, pallas_interpret=True)
    c0 = jattn.make_cache(jc, 2, 1, S, jnp.float32, cross=True, enc_seq=jc.enc_seq)
    jout, jc_ = jattn.attention_prefill(jp, jnp.asarray(h), jc, jrt, c0, x_cross=jnp.asarray(enc))
    tc0 = tattn.make_cache(tm.cfg, 1, 2, 1, S, torch.float32, "cpu", cross=True,
                           enc_seq=jc.enc_seq).layer(0)
    with torch.inference_mode():
        tout, tc_ = tattn.attention_prefill(tm.layers[0]["cross"], torch.from_numpy(h), tm.cfg,
                                            tm.rt, tc0, x_cross=torch.from_numpy(enc))
    np.testing.assert_allclose(_np(tout), np.asarray(jout), **F32_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(getattr(tc_, name)), np.asarray(getattr(jc_, name)),
                                   **F32_TOL)
    assert int(tc_.length) == int(jc_.length) == jc.enc_seq
    jd, jc2 = jattn.attention_decode(jp, jnp.asarray(x1), jc, jrt, jc_, cross=True)
    with torch.inference_mode():
        td, tc2 = tattn.attention_decode(tm.layers[0]["cross"], torch.from_numpy(x1), tm.cfg,
                                         tm.rt, tc_, cross=True)
    np.testing.assert_allclose(_np(td), np.asarray(jd), **F32_TOL)
    assert int(tc2.length) == int(jc2.length) == jc.enc_seq       # read only


@pytest.mark.parametrize("tp", [1, 2])
def test_make_caches_match_jax(tp):
    """Shapes, dtypes and lengths of the (self, cross) pair, stacked over
    the decoder layers, at the local heads of TP ``tp``."""
    jc, tc = _cfgs("bf16")
    jrt = JaxRuntime(tp_axis="model" if tp > 1 else None, tp_size=tp)
    want = JaxModel(jc, jrt).make_caches(3, 40, enc_seq=jc.enc_seq)
    got = Model(tc, _RankRt(tp_group="tp" if tp > 1 else None, size=tp), device="cpu").init(0)
    got = got.make_caches(3, 40, enc_seq=jc.enc_seq)
    assert isinstance(got, EncDecCache)
    for part, jpart in zip(got, want):
        for g, w in zip(part, jpart):
            assert tuple(g.shape) == w.shape and _np(g).dtype == _jnp(w).dtype
            assert not g.any()
    assert got.cross.window == jc.enc_seq and got.kv.window == 40


# ---------------------------------------------------------------------------
# The whole model
# ---------------------------------------------------------------------------

def test_params_from_jax_is_bit_exact():
    jc, jm, params, tm = _models("bf16")
    for key in ("embed", "pos_emb"):
        np.testing.assert_array_equal(_np(getattr(tm, key)), _jnp(params[key]))
    for i in (0, jc.n_layers - 1):
        for sub, name in (("cross", "wq"), ("cross", "wo"), ("mlp", "w1"), ("mlp", "b2"),
                          ("norm_cross", "bias")):
            np.testing.assert_array_equal(_np(tm.layers[i][sub][name]),
                                          _jnp(params["layers"][sub][name][i]))
        np.testing.assert_array_equal(_np(tm.enc_layers[i]["attn"]["wk"]),
                                      _jnp(params["enc_layers"]["attn"]["wk"][i]))
    assert "bq" not in tm.layers[0]["cross"]
    np.testing.assert_array_equal(_np(tm.enc_norm["scale"]), _jnp(params["enc_norm"]["scale"]))


@pytest.mark.parametrize("frames", [30, 130])
@pytest.mark.parametrize("S", [16, 130])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_prefill_decode_vs_jax(dt, S, frames):
    """A prefill and four decode steps; at 130 tokens or frames the
    decoder, cross or encoder attention takes the flash path (on the CPU
    its plain version)."""
    tol = DTYPES[dt][2]
    jc, jm, params, tm = _models(dt)
    rng = np.random.default_rng(S + frames)
    toks = rng.integers(0, jc.vocab_size, (2, S + 4))
    enc = rng.normal(size=(2, frames, jc.d_model)).astype(np.float32)
    jl, jcache = jax.jit(jm.apply_prefill)(params, jnp.asarray(toks[:, :S], jnp.int32),
                                           jnp.asarray(enc))
    tl, tcache = tm.apply_prefill(torch.from_numpy(toks[:, :S]), torch.from_numpy(enc))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **tol)
    for p, jp in zip(tcache, jcache):
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(getattr(p, name)), _jnp(getattr(jp, name)), **tol)
        np.testing.assert_array_equal(_np(p.length), np.asarray(jp.length))
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
    np.testing.assert_array_equal(_np(tcache.kv.length), np.asarray(jcache[0].length))
    np.testing.assert_array_equal(_np(tcache.cross.length), np.full(jc.n_layers, frames))


def test_training_forward_matches_jax(f32):
    jc, jm, params, tm = f32
    b = batch(0, jc.vocab_size, jc.enc_seq, jc.d_model)
    want, _ = jax.jit(jm.apply_train)(params, jnp.asarray(b["tokens"]), jnp.asarray(b["enc"]))
    got, aux = tm.apply_train(torch.from_numpy(b["tokens"]).long(), torch.from_numpy(b["enc"]))
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)
    assert float(aux) == 0.0
    with pytest.raises(ValueError, match="encoder input missing"):
        tm.apply_train(torch.from_numpy(b["tokens"]).long())


def test_int8_cache_transfer_bit_equal_to_jax(f32):
    """The (self, cross) pair through the reference's rule: k and v of
    both caches as int8 blocks, the lengths raw; bit-equal to the
    reference's transfer of the same cache."""
    jc, _, params, tm = f32
    mesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"))
    jm = JaxModel(jc, runtime_for_mesh(mesh, use_pallas=True))
    prompt, frames = serve_inputs(jc.vocab_size, jc.enc_seq, jc.d_model)
    jprefill, _, cshape = jax_serve_steps(jm, mesh, SB, SS)
    _, jcaches = jprefill(params, jnp.asarray(prompt), jnp.asarray(frames))
    jmoved = jax_kv_transfer(jm, mesh, cshape, SB, compress="int8")(jcaches)
    caches = EncDecCache(*(KVCache(*(_t(a) for a in part)) for part in jcaches))
    moved = make_kv_transfer(tm, compress="int8")(caches)
    assert isinstance(moved, EncDecCache)
    for p, n in CACHE_LEAVES:
        got = getattr(getattr(moved, p), n)
        sent = getattr(getattr(caches, p), n)
        want = getattr(jmoved[0 if p == "kv" else 1], n)
        np.testing.assert_array_equal(_np(got), _jnp(want), err_msg=f"{p}.{n}")
        assert torch.equal(got, sent) == (n == "length"), f"{p}.{n}: the codec ran or not"


@pytest.fixture(scope="module")
def world_of_one():
    started = not dist.is_initialized()
    if started:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    yield
    if started:
        dist.destroy_process_group()


def test_hier_int8_training_matches_jax(world_of_one):
    """Three ``hier`` + int8 steps of the smoke model in a world of one
    (real pod and data groups of one member, so the codec runs) against the
    reference's step on a (1, 1, 1) mesh, from the same parameters, on the
    launcher's synthetic batches (frames included)."""
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
    dcfg = tpipe.DataConfig(vocab_size=tc.vocab_size, global_batch=2, seq_len=24,
                            enc_seq=tc.enc_seq, d_model=tc.d_model)
    for i in range(N_STEPS):
        b = tpipe.synth_batch(dcfg, i)
        params, jstate, jm_ = jstep(params, jstate, {k: jnp.asarray(v) for k, v in b.items()})
        m = step_fn(opt, {k: torch.from_numpy(v).to(torch.long if k != "enc" else None)
                          for k, v in b.items()})
        assert not m["gated"]
        np.testing.assert_allclose(m["loss"], float(jm_["loss"]), rtol=1e-4)
        np.testing.assert_allclose(m["grad_norm"], float(jm_["grad_norm"]), rtol=1e-4)


@pytest.mark.parametrize("n_hosts, host_id", [(1, 0), (2, 1)])
def test_synth_batch_with_frames_is_the_references(n_hosts, host_id):
    kw = dict(vocab_size=256, global_batch=4, seq_len=16, seed=5, n_hosts=n_hosts,
              host_id=host_id, enc_seq=30, d_model=64)
    for step in (0, 3):
        got = tpipe.synth_batch(tpipe.DataConfig(**kw), step)
        want = jpipe.synth_batch(jpipe.DataConfig(**kw), step)
        assert sorted(got) == sorted(want) == ["enc", "labels", "tokens"]
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# Plans, leaves, shapes and refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("pods, world, mode, codec, plan, skew",
                         [(2, 8, "hier", "int8", "auto", "auto"),
                          (1, 4, "hier_zero1", "int8", "auto", "none"),
                          (2, 8, "fsdp", "int8", "auto", "none")])
def test_make_plan_is_the_reference_launchers(smoke, pods, world, mode, codec, plan, skew):
    cfg = get_config(ARCH, smoke=smoke)
    shapes = jax.eval_shape(JaxModel(jax_config(ARCH, smoke=smoke), JaxRuntime()).init,
                            jax.random.key(0))
    n_leaves = len(jax.tree.leaves(shapes))
    assert train_cli.n_train_leaves(cfg) == n_leaves
    lines: list[str] = []
    got = train_cli.make_plan(cfg, pods, world, mode, codec, plan=plan, skew=skew,
                              log=lines.append)
    want, wmode, wpacked, wweights, *_ = _reference_launcher_plan(
        ARCH, n_leaves, pods, world, mode, codec, plan, skew, jcache.PlanCache(), smoke=smoke)
    assert (got.mode, got.packed, got.cluster_weights) == (
        wmode, wpacked, None if wweights is None else tuple(wweights))
    assert got.plan.summary() == want.summary()
    assert got.plan.describe() == want.describe()


def test_state_tree_leaf_names_are_the_references(f32):
    """The checkpoint's leaf names (``runtime/tree.name``) and order of the
    parameters, encoder leaves included, are the reference's."""
    jc, _, params, tm = f32
    got = [tree_lib.name(path) for path, _ in tree_lib.leaves_with_path(
        state_tree(tm, None, TrainConfig())[0])]
    want = ["/".join(str(k.key) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    assert got == want
    assert "enc_layers/mlp/b2" in got and "layers/cross/wq" in got and "pos_emb" in got


def _global_shapes(tree: dict) -> dict:
    """{leaf path: global shape} of a param tree, a stacked subtree's
    leaves (L, ...)."""
    out = {}
    for key, v in tree.items():
        if isinstance(v, torch.Tensor):
            out[(key,)] = tuple(v.shape)
        elif key in tmodel.STACKED:
            out.update({path: (len(v),) + tuple(t.shape)
                        for path, t in tmodel._paths(v[0], (key,))})
        else:
            out.update({path: tuple(t.shape) for path, t in tmodel._paths(v, (key,))})
    return out


@pytest.mark.parametrize("tp", [1, 2])
def test_full_width_shapes_and_specs_are_the_references(tp):
    """whisper-tiny at full width, drawn under FakeTensorMode: every
    leaf's global shape and its sharding (TP ``tp``, FSDP 2) as the
    reference's ``param_specs`` of its ``eval_shape``."""
    cfg, jc = get_config(ARCH), jax_config(ARCH)
    jm = JaxModel(jc, JaxRuntime(tp_axis="model" if tp > 1 else None, tp_size=tp,
                                 fsdp_axis="data")).with_fsdp(2)
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    want = {"/".join(str(k.key) for k in path): (leaf.shape, tuple(spec))
            for (path, spec), leaf in zip(
                jax.tree_util.tree_flatten_with_path(
                    jm.param_specs(shapes),
                    is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0],
                jax.tree.leaves(shapes))}
    with FakeTensorMode():
        tree = tmodel.pad_vocab(Model(cfg, device="cpu").init(0).param_tree(), cfg, tp)
        specs = tmodel.param_specs(tree, cfg, tp, 2)
    glob = _global_shapes(tree)
    got = {"/".join(p): (glob[p], s) for p, s in specs.items()}
    assert got == {k: (tuple(s), sp) for k, (s, sp) in want.items()}
    assert glob[("pos_emb",)] == (32768, 384)
    assert "data" in specs[("enc_layers", "mlp", "w1")]


def test_tp4_is_refused_by_name():
    """whisper-tiny's 6 heads pad to 8 at TP 4, which is no longer refused:
    each rank builds 2 Q / 2 KV heads (the KV heads sharded, the phantom
    ones zero) in its self- and cross-attention and its caches; TP 2
    splits them 3 / 3."""
    cfg = get_config(ARCH)
    dh = cfg.head_dim
    for r in (0, 3):
        with FakeTensorMode():
            model = Model(cfg, _RankRt(tp_group="tp", size=4, rank=r), device="cpu").init(0)
            for blocks in (model.layers, model.enc_layers):
                for lp in blocks:
                    for name in ("attn", "cross") if blocks is model.layers else ("attn",):
                        a = lp[name]
                        assert a["wq"].shape == a["wk"].shape == (cfg.d_model, 2 * dh)
                        assert a["wo"].shape == (2 * dh, cfg.d_model)
            caches = model.make_caches(1, 8, enc_seq=cfg.enc_seq)
        assert caches.kv.k.shape[3] == caches.cross.k.shape[3] == 2
    last = Model(cfg, _RankRt(tp_group="tp", size=4, rank=3), device="cpu").draw(0)
    wq = last["layers"][0]["attn"]["wq"]
    assert wq.shape == (cfg.d_model, 8 * dh) and not wq[:, 6 * dh:].any()
    assert not last["layers"][0]["cross"]["wk"][:, 6 * dh:].any()
    Model(cfg, _RankRt(tp_group="tp", size=2), device="cpu")


def test_entry_points_on_cpu(capsys, world_of_one):
    disaggregated.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--prompt-len", "40",
                        "--gen", "4"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cfg = get_config(ARCH, smoke=True)
    L, b = cfg.n_layers, res["batch"]
    kv = [L, b, 40, cfg.n_kv_heads, cfg.head_dim]
    cross = [L, b, cfg.enc_seq, cfg.n_kv_heads, cfg.head_dim]
    assert res["cache_shapes"] == {"kv.k": kv, "kv.v": kv, "kv.length": [L],
                                   "cross.k": cross, "cross.v": cross, "cross.length": [L]}
    assert res["raw_transfer_exact"] and res["cache_finite"]
    train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2", "--seq", "32",
                    "--compression", "int8"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert [x["step"] for x in lines[:-1]] == [0, 1]
    assert all(np.isfinite(x["loss"]) and not x["gated"] for x in lines[:-1])


# ---------------------------------------------------------------------------
# Eight gloo ranks
# ---------------------------------------------------------------------------

def _jax_params(**overrides) -> dict:
    jc, _ = _cfgs("f32", **overrides)
    params = JaxModel(jc, JaxRuntime(tp_axis="model", tp_size=TP)).init(jax.random.key(0))
    return flat_tree(jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Serving and every training case on 8 gloo ranks and in JAX on 8 host
    devices, one process per part: (the reference's results, each rank's)."""
    tmp = tmp_path_factory.mktemp("encdec_world")
    np.savez(tmp / "params_base.npz", **_jax_params())
    np.savez(tmp / "params_fsdp.npz", **_jax_params(d_ff=FSDP_D_FF))
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
        for p, n in CACHE_LEAVES:
            np.testing.assert_allclose(got[f"serve/{p}/{n}"],
                                       _cache_shard(want[f"serve/{p}/{n}"], r, n), **F32_TOL,
                                       err_msg=f"rank {rank} {p}.{n}")
            assert bool(got[f"moved/{p}.{n}"]), f"rank {rank}: int8 transfer of {p}.{n}"
    cfg = get_config(ARCH, smoke=True)
    assert ranks[0]["serve/cross/k"].shape == (cfg.n_layers, SB, cfg.enc_seq,
                                               cfg.n_kv_heads // TP, cfg.head_dim)


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
        # the encoder's column-parallel w1 is sharded over model and data
        assert ranks[0][f"{key}/param/enc_layers/mlp/w1"].shape == (2, 64 // 2, FSDP_D_FF // 2)


def test_sp_under_hier_overlap_is_refused_by_name(results):
    """Under sequence parallelism at TP 2 the GELU MLP's b2 is no input of
    the loss (ROADMAP R22), so hier_overlap's bucket holding it would never
    sync: every rank refuses the pair by name when it builds the step."""
    _, ranks = results
    for rank, got in enumerate(ranks):
        assert "whisper-tiny-smoke with sequence parallelism under hier_overlap" in str(
            got["overlap_sp_refusal"]), f"rank {rank}"


def test_sequence_parallel_encoder_is_another_function_r22(results):
    """ROADMAP R22: under sequence parallelism the reference's encoder
    sublayers gather the already whole frame sequence tp-fold, so RoPE
    sees positions up to tp x enc_seq, and the decoder's cross-attention
    hands the encoder a gradient it does not sum over the TP group: the
    loss moves a little and the grad norm a lot from the run without SP.
    The port computes what the reference does in both runs (held above)."""
    want, _ = results
    off, on = want["hier_int8/metrics"], want["hier_int8_sp/metrics"]
    assert np.abs(off[:, 0, 0] - on[:, 0, 0]).max() > 1e-6          # the loss
    assert np.abs(off[:, 0, 1] - on[:, 0, 1]).max() > 1e-2          # the grad norm
