"""The hybrid family (Hymba: attention and SSM heads side by side on one
norm, averaged): the port against the JAX package, f32 smoke hymba-1.5b
(4 Q / 2 KV heads, window 32, 8 SSM heads).

* TP 1, in this process: a prefill of a 130-token prompt (longer than
  the window, so the ring cache wraps; the SSD pads to its 128-token
  chunk; the flash path's plain version), then four decode steps, each
  from the reference's cache before it: logits within 1e-4 and the
  ``HybridCache`` (k, v, conv state, SSM state, lengths) within 1e-4 (the
  bf16 conv state within one bf16 ulp, ROADMAP R8: a conv input on a
  rounding boundary may round the other way, and the steps that read it
  later would then differ by more than summation order); the int8 transfer of
  that cache bit-equal to the reference's, leaf by leaf (k, v, conv and
  SSM state through the codec, the lengths raw); the entry point.
* TP 1 training, three steps of the single-device step: losses and grad
  norms within 1e-4 (relative), parameters within 1e-4.
* Two gloo ranks, spawned once, as one TP group of 2 (2 Q / 1 KV heads
  and 4 SSM heads per rank) against the reference on 2 host devices (the
  JAX side runs this file as a script): serving on a (data 1, model 2)
  mesh as at TP 1, each rank's logits and cache shard read as the
  reference's ``cache_specs`` shards them (its f32 KV cache along the
  window, ROADMAP R13); and three ``hier`` + int8 training steps on a
  (pod 1, data 1, model 2) mesh (built with ``donate=False``, R12), every
  rank's metrics within 1e-3 of its own device's and its parameters as
  ``tests/test_torch_ssm_train.py`` holds them.
* The full hymba-1.5b at TP 2 raises by name (ROADMAP R17).
"""

import dataclasses
import datetime
import os
import sys

import numpy as np

TP, SB, SS, GEN = 2, 2, 130, 4
GB, S, N_STEPS = 2, 64, 3
LR, WARMUP = 1e-3, 1
ARCH = "hymba-1.5b"
LEAVES = (("kv", "k"), ("kv", "v"), ("kv", "length"), ("ssm", "conv"), ("ssm", "ssm"),
          ("ssm", "length"))


def serve_prompt(vocab: int) -> np.ndarray:
    return np.random.default_rng(31).integers(0, vocab, (SB, SS), dtype=np.int32)


def batch(step: int, vocab: int) -> dict:
    rng = np.random.default_rng(400 + step)
    return {"tokens": rng.integers(0, vocab, (GB, S), dtype=np.int32),
            "labels": rng.integers(0, vocab, (GB, S), dtype=np.int32)}


def _leaf(caches, part: str, name: str):
    return getattr(caches[0] if part == "kv" else caches[1], name)


def _cache_shard(part: str, name: str, a: np.ndarray, r: int, tp: int = TP) -> np.ndarray:
    """Device r's shard of the reference's global cache leaf
    (``cache_specs``): the 5-D f32 leaves (KV and SSM state alike) on dim
    2, which is the window of a KV leaf and the heads of an SSM state; the
    conv state on its channels; the lengths replicated."""
    if name == "length":
        return a
    dim = 3 if name == "conv" else 2
    n = a.shape[dim] // tp
    return np.take(a, range(r * n, (r + 1) * n), axis=dim)


def _jax_main(out_dir: str, part: str) -> None:
    """The reference on 2 host devices: serving ("serve") or three
    training steps ("train")."""
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
    from repro.serve.serve_step import cache_specs
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
        pspecs = jm.param_specs(shapes)
        prompt = jnp.asarray(serve_prompt(cfg.vocab_size))
        prefill, decode, _ = jax_serve_steps(jm, mesh, SB, SS)
        tok, caches = prefill(params, prompt)
        for p, n in LEAVES:
            out[f"prefill/{p}/{n}"] = np.array(_leaf(caches, p, n).astype(jnp.float32))
        toks = [np.asarray(tok)]
        for _ in range(GEN):
            tok, caches = decode(params, tok, caches)
            toks.append(np.asarray(tok))
        out["tokens"] = np.concatenate(toks, axis=1)
        logits = jax.jit(jsh.shard_map(lambda p, t: jm.apply_prefill(p, t)[0], mesh=mesh,
                                       in_specs=(pspecs, P()), out_specs=P(None, None, "model")))
        out["logits"] = np.asarray(logits(params, prompt))
        # the decode steps from the prefill's cache, the generated tokens fed
        _, caches = prefill(params, prompt)
        cspecs = cache_specs(caches, ("data",), jm.rt)
        step = jax.jit(jsh.shard_map(lambda p, t, c: jm.apply_decode(p, t, c), mesh=mesh,
                                     in_specs=(pspecs, P("data"), cspecs),
                                     out_specs=(P("data", None, "model"), cspecs)))
        for i in range(GEN):
            lg, caches = step(params, jnp.asarray(out["tokens"][:, i:i + 1]), caches)
            out[f"decode{i}/logits"] = np.asarray(lg)
            for p, n in LEAVES:
                out[f"decode{i}/{p}/{n}"] = np.array(_leaf(caches, p, n).astype(jnp.float32))
    else:
        mesh = jax.make_mesh((1, 1, TP), ("pod", "data", "model"))
        order = list(mesh.devices.flat)
        model = JaxModel(cfg, runtime_for_mesh(mesh))
        tcfg = JaxTrainConfig(comm_mode="hier", dcn_compression="int8",
                              opt=JaxOpt(lr=LR, warmup_steps=WARMUP))
        build, _ = jax_train_step(model, tcfg, mesh=mesh, donate=False)
        step, _ = build(shapes)
        pspecs = model.param_specs(shapes)
        params = jax.tree.map(lambda p, s: jax.device_put(p, NamedSharding(mesh, s)), params,
                              pspecs)
        opt = jopt.adam_init(params)
        metrics = np.zeros((TP, N_STEPS, 2))
        for i in range(N_STEPS):
            b = {k: jnp.asarray(v) for k, v in batch(i, cfg.vocab_size).items()}
            params, opt, m = step(params, opt, b)
            for j, name in enumerate(("loss", "grad_norm")):
                for sh in m[name].addressable_shards:
                    metrics[order.index(sh.device), i, j] = float(sh.data)
        out["train/metrics"] = metrics
        specs, _ = jax.tree_util.tree_flatten_with_path(pspecs, is_leaf=lambda x: isinstance(x, P))
        for (path, _), leaf in zip(specs, jax.tree.leaves(params)):
            name = "/".join(str(k.key) for k in path)
            for sh in leaf.addressable_shards:
                out[f"train/param/rank{order.index(sh.device)}/{name}"] = np.asarray(sh.data)
    np.savez(os.path.join(out_dir, f"jax_{part}.npz"), **out)


def _gloo_rank(rank: int, store_path: str, out_dir: str) -> None:
    """One TP rank: serving (decode from its shard of the reference's
    prefill cache) and training."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist

    from _torch_world import nest
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.mesh import runtime_for_groups
    from repro_torch.models.attention import KVCache
    from repro_torch.models.model import HybridCache
    from repro_torch.models.ssm import SSMState
    from repro_torch.serve.serve_step import make_serve_steps
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import TrainConfig, make_train_step

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, TP), rank=rank,
                            world_size=TP, timeout=datetime.timedelta(seconds=120))
    out = {}
    try:
        cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=torch.float32)
        rt = runtime_for_groups(pods=1, data_per_pod=1, tp=TP)
        tree = nest(np.load(os.path.join(out_dir, "params.npz")))
        model = params_from_jax(tree, cfg, rt, device="cpu")
        prompt = torch.from_numpy(serve_prompt(cfg.vocab_size)).long()
        prefill, decode = make_serve_steps(model)
        tok, caches = prefill(prompt)
        for p, n in LEAVES:
            out[f"prefill/{p}/{n}"] = _leaf(caches, p, n).float().numpy().copy()
        toks = [tok]
        for _ in range(GEN):
            tok, caches = decode(tok, caches)
            toks.append(tok)
        out["tokens"] = torch.cat(toks, dim=1).numpy()
        out["logits"] = model.apply_prefill(prompt)[0].numpy()
        want = np.load(os.path.join(out_dir, "jax_serve.npz"))
        dtypes = {"k": torch.float32, "v": torch.float32, "length": torch.int32,
                  "conv": torch.bfloat16, "ssm": torch.float32}
        for i in range(GEN):
            # each step from this rank's shard of the reference's cache before it
            before = "prefill" if i == 0 else f"decode{i - 1}"
            shard = {(p, n): torch.from_numpy(_cache_shard(p, n, want[f"{before}/{p}/{n}"],
                                                           rank)).to(dtypes[n])
                     for p, n in LEAVES}
            caches = HybridCache(KVCache(*(shard["kv", n] for n in ("k", "v", "length"))),
                                 SSMState(*(shard["ssm", n] for n in ("conv", "ssm", "length"))))
            lg, caches = model.apply_decode(torch.from_numpy(want["tokens"][:, i:i + 1]).long(),
                                            caches)
            out[f"decode{i}/logits"] = lg.numpy()
            for p, n in LEAVES:
                out[f"decode{i}/{p}/{n}"] = _leaf(caches, p, n).float().numpy().copy()

        model = params_from_jax(tree, cfg, rt, device="cpu")
        step_fn, _ = make_train_step(model, TrainConfig(
            comm_mode="hier", dcn_compression="int8",
            opt=opt_lib.OptConfig(lr=LR, warmup_steps=WARMUP)))
        opt = opt_lib.adam_init(opt_lib.flat_params(model.train_leaves())[0])
        metrics = []
        for i in range(N_STEPS):
            m = step_fn(opt, {k: torch.from_numpy(v).long()
                              for k, v in batch(i, cfg.vocab_size).items()})
            assert not m["gated"]
            metrics.append((m["loss"], m["grad_norm"]))
        out["train/metrics"] = np.asarray(metrics)
        for path, leaf in zip(model.param_specs(), model.train_leaves()):
            out[f"train/param/{'/'.join(path)}"] = (
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

from _torch_world import flat_tree, run_world  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch.mesh import runtime_for_mesh  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.parallel.sharding import Runtime as JaxRuntime  # noqa: E402
from repro.serve import make_kv_transfer as jax_kv_transfer  # noqa: E402
from repro.serve import make_serve_steps as jax_serve_steps  # noqa: E402
from repro.train import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.train import make_train_step as jax_train_step  # noqa: E402
from repro.train.optimizer import OptConfig as JaxOpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax, to_tensor  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402
from repro_torch.models.model import HybridCache  # noqa: E402
from repro_torch.models.ssm import SSMState  # noqa: E402
from repro_torch.serve import disaggregated  # noqa: E402
from repro_torch.serve.serve_step import make_kv_transfer  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402
from repro_torch.train.train_step import TrainConfig, make_train_step  # noqa: E402
from test_torch_ssm import _conv_state_close, _first_ssd_call  # noqa: E402,F401
from test_torch_tp import _RankRt  # noqa: E402

F32_TOL = dict(rtol=0, atol=1e-4)


def _close_leaf(name: str, got: np.ndarray, want: np.ndarray, msg: str) -> None:
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    if name == "conv":
        _conv_state_close(torch.from_numpy(got).bfloat16(), want, torch.float32, msg)
    elif name == "length":
        np.testing.assert_array_equal(got, want, err_msg=msg)
    else:
        np.testing.assert_allclose(got, want, **F32_TOL, err_msg=msg)


def _jax_params(tp: int):
    cfg = dataclasses.replace(jax_config(ARCH, smoke=True), dtype=jnp.float32)
    return JaxModel(cfg, JaxRuntime(tp_axis="model", tp_size=tp)).init(jax.random.key(0))


def _t(a) -> torch.Tensor:
    return to_tensor(np.asarray(a), "cpu")


def _port_cache(jcaches) -> HybridCache:
    kv, st = jcaches
    return HybridCache(KVCache(*(_t(a) for a in kv)), SSMState(*(_t(a) for a in st)))


def _np_leaf(a) -> np.ndarray:
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


@pytest.fixture(scope="module")
def tp1():
    """The TP-1 pair: the reference's model and f32 parameters on a mesh
    of one device (its serving steps, Pallas SSD in interpret mode) and
    the port's model converted from them."""
    params = _jax_params(1)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=torch.float32)
    tm = params_from_jax(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return params, tm


def test_serving_at_tp1_matches_jax(tp1):
    params, tm = tp1
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), dtype=jnp.float32)
    jm = JaxModel(jcfg, JaxRuntime(use_pallas=True))
    prompt = serve_prompt(jcfg.vocab_size)
    jl, jc = jax.jit(jm.apply_prefill)(params, jnp.asarray(prompt))
    tl, tc = tm.apply_prefill(torch.from_numpy(prompt).long())
    assert isinstance(tc, HybridCache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32_TOL)
    assert tc.kv.window == jcfg.sliding_window < SS          # the ring has wrapped
    for p, n in LEAVES:
        _close_leaf(n, _leaf(tc, p, n).float().numpy(), _np_leaf(_leaf(jc, p, n)),
                    f"prefill {p}.{n}")
    dec = jax.jit(jm.apply_decode)
    toks = np.random.default_rng(32).integers(0, jcfg.vocab_size, (SB, GEN))
    for i in range(GEN):
        tc = _port_cache(jc)        # each step from the reference's cache
        jl, jc = dec(params, jnp.asarray(toks[:, i:i + 1], jnp.int32), jc)
        tl, tc = tm.apply_decode(torch.from_numpy(toks[:, i:i + 1]).long(), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32_TOL, err_msg=f"step {i}")
        assert (tl.argmax(-1).numpy() == np.asarray(jl).argmax(-1)).all()
        for p, n in LEAVES:
            _close_leaf(n, _leaf(tc, p, n).float().numpy(), _np_leaf(_leaf(jc, p, n)),
                        f"decode step {i} {p}.{n}")


def test_int8_hybrid_cache_transfer_bit_equal_to_jax(tp1):
    """Every leaf of the (KV, SSM) pair through the reference's rule: k, v,
    the conv and the SSM state (at least 1024 values each) as int8 blocks,
    the lengths raw; bit-equal to the reference's transfer of the same
    cache."""
    params, tm = tp1
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), dtype=jnp.float32)
    mesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"))
    jm = JaxModel(jcfg, runtime_for_mesh(mesh, use_pallas=True))
    jprefill, _, cshape = jax_serve_steps(jm, mesh, SB, SS)
    _, jcaches = jprefill(params, jnp.asarray(serve_prompt(jcfg.vocab_size)))
    jmoved = jax_kv_transfer(jm, mesh, cshape, SB, compress="int8")(jcaches)
    caches = _port_cache(jcaches)
    moved = make_kv_transfer(tm, compress="int8")(caches)
    assert isinstance(moved, HybridCache) and isinstance(moved.ssm, SSMState)
    for p, n in LEAVES:
        got, sent = _leaf(moved, p, n), _leaf(caches, p, n)
        assert got.dtype == sent.dtype and got.shape == sent.shape
        np.testing.assert_array_equal(got.float().numpy(), _np_leaf(_leaf(jmoved, p, n)),
                                      err_msg=f"{p}.{n}")
        assert torch.equal(got, sent) == (n == "length"), f"{p}.{n}: the codec ran or not"


def test_training_at_tp1_matches_jax(tp1):
    params, tm = tp1
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), dtype=jnp.float32)
    jm = JaxModel(jcfg, JaxRuntime())
    jstep, jinit = jax_train_step(jm, JaxTrainConfig(
        comm_mode="flat", opt=JaxOpt(lr=LR, warmup_steps=WARMUP)))
    jopt = jinit(jax.random.key(0))[1]
    tm = params_from_jax(jax.tree.map(np.asarray, params), tm.cfg, device="cpu")
    step_fn, _ = make_train_step(tm, TrainConfig(
        comm_mode="flat", opt=opt_lib.OptConfig(lr=LR, warmup_steps=WARMUP)))
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


def test_entry_point_smoke_on_cpu(capsys):
    disaggregated.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--prompt-len", "70",
                        "--gen", "4"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cfg = get_config(ARCH, smoke=True)
    assert res["raw_transfer_exact"] and res["cache_finite"]
    L, b = cfg.n_layers, res["batch"]
    ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    assert res["cache_shapes"] == {
        "kv.k": [L, b, cfg.sliding_window, cfg.n_kv_heads, cfg.head_dim],
        "kv.v": [L, b, cfg.sliding_window, cfg.n_kv_heads, cfg.head_dim], "kv.length": [L],
        "ssm.conv": [L, b, cfg.conv_width - 1, ch],
        "ssm.ssm": [L, b, cfg.ssm_heads(), cfg.ssm_head_dim, cfg.ssm_state], "ssm.length": [L]}
    assert all(n == 0 for counts in res["launches"].values() for n in counts.values())


@pytest.mark.parametrize("tp", [2, 4])
def test_full_width_at_tp2_and_tp4_raises_by_name(tp):
    """ROADMAP R17: 25 Q / 5 KV heads pad to 13 / 3 per rank at TP 2 and
    7 / 2 at TP 4, which the reference's GQA repeat cannot pair; the smoke
    config (2 Q / 1 KV per rank at TP 2) pairs."""
    with pytest.raises(ValueError, match="no multiple of .* local KV heads"):
        Model(get_config(ARCH), _RankRt(tp_group="tp", size=tp), device="cpu")
    Model(get_config(ARCH, smoke=True), _RankRt(tp_group="tp", size=2), device="cpu")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Serving and training on 2 gloo ranks and in JAX on 2 host devices
    (one process each for serving and training): (the reference's
    results, each rank's)."""
    tmp = tmp_path_factory.mktemp("hybrid_tp")
    np.savez(tmp / "params.npz", **flat_tree(jax.tree.map(np.asarray, _jax_params(TP))))
    return run_world(__file__, tmp, ("serve", "train"), TP, _gloo_rank, TP,
                     ranks_after_jax=True)


def test_serving_at_tp2_matches_jax(results):
    want, ranks = results
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        vl = got["logits"].shape[-1]
        np.testing.assert_allclose(got["logits"], want["logits"][..., r * vl:(r + 1) * vl],
                                   **F32_TOL)
        for when in ["prefill"] + [f"decode{i}" for i in range(GEN)]:
            for p, n in LEAVES:
                _close_leaf(n, got[f"{when}/{p}/{n}"],
                            _cache_shard(p, n, want[f"{when}/{p}/{n}"], r), f"{when} rank {r}")
            if when != "prefill":
                np.testing.assert_allclose(got[f"{when}/logits"],
                                           want[f"{when}/logits"][..., r * vl:(r + 1) * vl],
                                           **F32_TOL, err_msg=f"{when} rank {r}")
    cfg = get_config(ARCH, smoke=True)
    assert ranks[0]["prefill/kv/k"].shape[3] == 1                 # 1 KV head per rank
    assert ranks[0]["prefill/ssm/ssm"].shape[2] == cfg.ssm_heads() // TP


def test_training_at_tp2_matches_jax(results):
    """Losses and grad norms per device; parameters within 2 lr, all but
    0.1% within 1e-4 (an int8 rounding that falls another way moves an
    Adam step by up to lr)."""
    want, ranks = results
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["train/metrics"], want["train/metrics"][r], rtol=0,
                                   atol=1e-3, err_msg=f"rank {r}")
        names = sorted(k.split("/", 2)[2] for k in got.files if k.startswith("train/param/"))
        assert names == sorted(k.split("/", 3)[3] for k in want
                               if k.startswith(f"train/param/rank{r}/"))
        far = total = 0
        for name in names:
            a, b = got[f"train/param/{name}"], want[f"train/param/rank{r}/{name}"]
            np.testing.assert_allclose(a, b, rtol=0, atol=2 * LR, err_msg=f"rank {r} {name}")
            far += int((np.abs(a - b) > 1e-4).sum())
            total += a.size
        assert far <= 1e-3 * total, f"rank {r}: {far} of {total} parameters beyond 1e-4"
    assert "train/param/layers/ssm/w_bc" in ranks[0].files
    assert "train/param/layers/attn/wq" in ranks[0].files
