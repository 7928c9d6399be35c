"""Mamba2 under tensor parallelism: the port against the JAX package.

* Two gloo ranks, spawned once, as one TP group of 2, against the
  reference's ``make_serve_steps`` on a (data 1, model 2) mesh of 2 host
  devices (its Pallas SSD kernel in interpret mode; the JAX side runs
  this file as a script), the f32 smoke model from the same parameters:
  a prefill of a 130-token prompt (ragged against the 128-token chunk)
  and four decode steps.  Tokens equal; each rank's prefill logits (its
  vocabulary shard) and its cache shard within 1e-4 after the prefill:
  its conv state [its x channels, the replicated B/C channels] (bf16,
  within one bf16 ulp), its SSM state (its local heads) and the lengths,
  read from the reference's global cache as its ``cache_specs`` shards it
  (ROADMAP R13).  Each decode step is held from the reference's cache
  before it (each rank starts from its shard of it, so the ranks run
  after the reference): logits and cache within 1e-4 after each step.
  From its own cache a conv value that lies on a bf16 rounding boundary
  can round the other way (ROADMAP R8), and the decode steps that read
  it later then differ by more than summation order.
* Each rank's converted parameters equal the reference's addressable
  shards under ``param_specs`` at TP 2.
* ROADMAP R18: the TP-2 logits are TP 1's with the gated norm taken over
  the two ranks' channel groups, and not plain TP 1's.
* The sharding rules, the cache and the local dims at TP 2 for the
  full-width mamba2-2.7b and hymba-1.5b, from shapes alone.
* The serving entry point at ``--tp 2`` on the CPU, two processes.
"""

import dataclasses
import datetime
import os
import sys

import numpy as np

TP, SB, SS, GEN = 2, 2, 130, 4
ARCH = "mamba2-2.7b"
F32_TOL = dict(rtol=0, atol=1e-4)


def serve_prompt(vocab: int) -> np.ndarray:
    return np.random.default_rng(21).integers(0, vocab, (SB, SS), dtype=np.int32)


def _cache_shard(leaf: str, a: np.ndarray, r: int) -> np.ndarray:
    """Device r's shard of the reference's global cache leaf: the conv
    state's channels, the SSM state's heads (``cache_specs``); the lengths
    are replicated."""
    if leaf == "length":
        return a
    dim = {"conv": 3, "ssm": 2}[leaf]
    n = a.shape[dim] // TP
    return np.take(a, range(r * n, (r + 1) * n), axis=dim)


def _jax_main(out_dir: str, part: str) -> None:
    """The reference on a (data 1, model 2) mesh: serving, and every
    device's shard of every parameter."""
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

    cfg = dataclasses.replace(jax_config(ARCH, smoke=True), dtype=jnp.float32)
    mesh = Mesh(np.array(jax.devices()[:TP]).reshape(1, TP), ("data", "model"))
    jm = JaxModel(cfg, runtime_for_mesh(mesh, use_pallas=True))
    params = jax.tree.map(jnp.asarray, nest(np.load(os.path.join(out_dir, "params.npz"))))
    shapes = jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape, p.dtype), params)
    pspecs = jm.param_specs(shapes)
    out = {}
    specs, _ = jax.tree_util.tree_flatten_with_path(pspecs, is_leaf=lambda x: isinstance(x, P))
    for (path, spec), leaf in zip(specs, jax.tree.leaves(params)):
        name = "/".join(str(k.key) for k in path)
        for sh in jax.device_put(leaf, NamedSharding(mesh, spec)).addressable_shards:
            out[f"shard/rank{list(mesh.devices.flat).index(sh.device)}/{name}"] = np.asarray(sh.data)

    prompt = jnp.asarray(serve_prompt(cfg.vocab_size))
    prefill, decode, _ = jax_serve_steps(jm, mesh, SB, SS)
    tok, caches = prefill(params, prompt)
    toks = [np.asarray(tok)]
    for leaf in ("conv", "ssm", "length"):      # copies: decode donates the cache
        out[f"prefill/{leaf}"] = np.array(getattr(caches, leaf).astype(jnp.float32))
    for i in range(GEN):
        tok, caches = decode(params, tok, caches)
        toks.append(np.asarray(tok))
        for leaf in ("conv", "ssm", "length"):
            out[f"decode{i}/{leaf}"] = np.array(getattr(caches, leaf).astype(jnp.float32))
    out["tokens"] = np.concatenate(toks, axis=1)
    logits = jax.jit(jsh.shard_map(lambda p, t: jm.apply_prefill(p, t)[0], mesh=mesh,
                                   in_specs=(pspecs, P()), out_specs=P(None, None, "model")))
    out["logits"] = np.asarray(logits(params, prompt))
    # the decode steps' logits, from the prefill's cache and tokens
    cspecs = cache_specs(caches, ("data",), jm.rt)
    step = jax.jit(jsh.shard_map(lambda p, t, c: jm.apply_decode(p, t, c), mesh=mesh,
                                 in_specs=(pspecs, P("data"), cspecs),
                                 out_specs=(P("data", None, "model"), cspecs)))
    _, caches = prefill(params, prompt)
    for i in range(GEN):
        lg, caches = step(params, jnp.asarray(out["tokens"][:, i:i + 1]), caches)
        out[f"decode{i}/logits"] = np.asarray(lg)
    np.savez(os.path.join(out_dir, f"jax_{part}.npz"), **out)


def _gloo_rank(rank: int, store_path: str, out_dir: str) -> None:
    """One TP rank: the port's serving and its parameter shards."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist

    from _torch_world import nest
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.mesh import runtime_for_groups
    from repro_torch.models.ssm import SSMState
    from repro_torch.serve.serve_step import make_serve_steps

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, TP), rank=rank,
                            world_size=TP, timeout=datetime.timedelta(seconds=120))
    out = {}
    try:
        cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=torch.float32)
        rt = runtime_for_groups(pods=1, data_per_pod=1, tp=TP)
        model = params_from_jax(nest(np.load(os.path.join(out_dir, "params.npz"))), cfg, rt,
                                device="cpu")
        for path, leaf in zip(model.param_specs(), model.train_leaves()):
            out[f"shard/{'/'.join(path)}"] = (torch.stack(leaf) if isinstance(leaf, list)
                                              else leaf).numpy()
        prompt = torch.from_numpy(serve_prompt(cfg.vocab_size)).long()
        prefill, decode = make_serve_steps(model)
        tok, caches = prefill(prompt)
        toks = [tok]
        for leaf in ("conv", "ssm", "length"):
            out[f"prefill/{leaf}"] = getattr(caches, leaf).float().numpy().copy()
        out["conv_dtype"] = np.asarray(str(caches.conv.dtype))
        for _ in range(GEN):
            tok, caches = decode(tok, caches)
            toks.append(tok)
        out["tokens"] = torch.cat(toks, dim=1).numpy()
        out["logits"] = model.apply_prefill(prompt)[0].numpy()
        # decode from this rank's shard of the reference's prefill cache
        want = np.load(os.path.join(out_dir, "jax_serve.npz"))
        for i in range(GEN):
            # each step from this rank's shard of the reference's cache before it
            before = "prefill" if i == 0 else f"decode{i - 1}"
            caches = SSMState(*(torch.from_numpy(_cache_shard(leaf, want[f"{before}/{leaf}"],
                                                              rank)).to(dtype)
                                for leaf, dtype in (("conv", torch.bfloat16),
                                                    ("ssm", torch.float32),
                                                    ("length", torch.int32))))
            tok = torch.from_numpy(want["tokens"][:, i:i + 1]).long()
            logits, caches = model.apply_decode(tok, caches)
            out[f"decode{i}/logits"] = logits.numpy()
            for leaf in ("conv", "ssm", "length"):     # copies: decode writes in place
                out[f"decode{i}/{leaf}"] = getattr(caches, leaf).float().numpy().copy()
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
from jax.sharding import PartitionSpec as P  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from _torch_world import flat_tree, run_world  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.parallel.sharding import Runtime as JaxRuntime  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.model import param_specs  # noqa: E402
from test_torch_ssm import _conv_state_close  # noqa: E402
from test_torch_tp import _run_ranks  # noqa: E402


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Serving on 2 gloo ranks and in JAX on 2 host devices: (the
    reference's results, each rank's)."""
    tmp = tmp_path_factory.mktemp("ssm_tp")
    cfg = dataclasses.replace(jax_config(ARCH, smoke=True), dtype=jnp.float32)
    params = JaxModel(cfg, JaxRuntime(tp_axis="model", tp_size=TP)).init(jax.random.key(0))
    np.savez(tmp / "params.npz", **flat_tree(jax.tree.map(np.asarray, params)))
    return run_world(__file__, tmp, ("serve",), TP, _gloo_rank, TP, ranks_after_jax=True)


def test_tokens_and_logits_match_jax(results):
    want, ranks = results
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        vl = got["logits"].shape[-1]
        np.testing.assert_allclose(got["logits"], want["logits"][..., r * vl:(r + 1) * vl],
                                   **F32_TOL)


@pytest.mark.parametrize("when", ["prefill"] + [f"decode{i}" for i in range(GEN)])
def test_cache_shards_match_jax(results, when):
    """Each rank's conv state holds its x channels then the replicated B/C
    channels, and its SSM state its local heads, as the reference's
    devices hold them; each decode step from the reference's prefill
    cache gives the reference's logits (this rank's vocabulary shard)."""
    want, ranks = results
    cfg = get_config(ARCH, smoke=True)
    di_l, gn = cfg.d_inner // TP, cfg.ssm_groups * cfg.ssm_state
    for r, got in enumerate(ranks):
        assert str(got["conv_dtype"]) == "torch.bfloat16"
        conv = _cache_shard("conv", want[f"{when}/conv"], r)
        assert got[f"{when}/conv"].shape == conv.shape and conv.shape[-1] == di_l + 2 * gn
        _conv_state_close(torch.from_numpy(got[f"{when}/conv"]).bfloat16(), conv,
                          torch.float32, f"{when} rank {r}")
        ssm_want = _cache_shard("ssm", want[f"{when}/ssm"], r)
        assert ssm_want.shape[2] == cfg.ssm_heads() // TP
        np.testing.assert_allclose(got[f"{when}/ssm"], ssm_want, **F32_TOL)
        np.testing.assert_array_equal(got[f"{when}/length"], want[f"{when}/length"])
        if when != "prefill":
            vl = got[f"{when}/logits"].shape[-1]
            np.testing.assert_allclose(got[f"{when}/logits"],
                                       want[f"{when}/logits"][..., r * vl:(r + 1) * vl],
                                       **F32_TOL)
    # the B/C channels are replicated: both ranks hold the same ones
    np.testing.assert_array_equal(ranks[0][f"{when}/conv"][..., di_l:],
                                  ranks[1][f"{when}/conv"][..., di_l:])


def test_tp2_is_tp1_with_the_gated_norm_per_rank(results, monkeypatch):
    """ROADMAP R18: each rank normalizes its own d_inner / 2 channels, so the
    TP-2 function is TP 1's with the gated norm over two channel groups,
    within f32 summation order, and plain TP 1 lies further off."""
    _, ranks = results
    cfg = dataclasses.replace(jax_config(ARCH, smoke=True), dtype=jnp.float32)
    params = JaxModel(cfg, JaxRuntime(tp_axis="model", tp_size=TP)).init(jax.random.key(0))
    tm = params_from_jax(jax.tree.map(np.asarray, params),
                         dataclasses.replace(get_config(ARCH, smoke=True), dtype=torch.float32),
                         device="cpu")
    prompt = torch.from_numpy(serve_prompt(cfg.vocab_size)).long()
    two = np.concatenate([got["logits"] for got in ranks], axis=-1)
    plain = tm.apply_prefill(prompt)[0].numpy()

    def grouped(p, y, z, x_dtype, rt):
        y = y.float() * torch.nn.functional.silu(z.float())
        parts = [tlayers.apply_norm({"scale": sc}, part, "rmsnorm")
                 for part, sc in zip(y.chunk(TP, -1), p["norm_scale"].chunk(TP, -1))]
        return torch.cat(parts, -1).to(x_dtype) @ p["w_out"]

    monkeypatch.setattr(ssm, "_gated_out", grouped)
    np.testing.assert_allclose(two, tm.apply_prefill(prompt)[0].numpy(), rtol=0, atol=1e-5)
    assert np.abs(two - plain).max() > 100 * 1e-5


def test_converted_shards_are_the_reference_addressable_shards(results):
    """conv_w_x / conv_b_x on the channel dim, w_bc / conv_w_bc / conv_b_bc
    whole, dt_bias / A_log / D_skip by head, w_out by row."""
    want, ranks = results
    for r, got in enumerate(ranks):
        names = sorted(k.split("/", 1)[1] for k in got.files if k.startswith("shard/"))
        assert names == sorted(k.split("/", 2)[2] for k in want
                               if k.startswith(f"shard/rank{r}/"))
        for name in names:
            np.testing.assert_array_equal(got[f"shard/{name}"], want[f"shard/rank{r}/{name}"],
                                          err_msg=name)
    cfg = get_config(ARCH, smoke=True)
    h = cfg.ssm_heads()
    assert ranks[0]["shard/layers/ssm/A_log"].shape == (cfg.n_layers, h // TP)
    assert ranks[0]["shard/layers/ssm/conv_w_x"].shape == (cfg.n_layers, cfg.d_inner // TP,
                                                          cfg.conv_width)
    np.testing.assert_array_equal(ranks[0]["shard/layers/ssm/w_bc"],
                                  ranks[1]["shard/layers/ssm/w_bc"])


@pytest.mark.parametrize("arch, tp", [("mamba2-2.7b", 2), ("mamba2-2.7b", 4),
                                      ("hymba-1.5b", 1), ("hymba-1.5b", 8)])
def test_param_specs_are_the_reference_at_full_width(arch, tp):
    """Every leaf's PartitionSpec, the port's from the reference's global
    shapes (``jax.eval_shape``) at the full width (hymba at TP 8, where its
    KV heads are replicated; at TP 2 and 4 its heads do not pair, ROADMAP
    R17)."""
    jm = JaxModel(jax_config(arch), JaxRuntime(tp_axis="model", tp_size=tp))
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    specs, _ = jax.tree_util.tree_flatten_with_path(jm.param_specs(shapes),
                                                    is_leaf=lambda x: isinstance(x, P))
    want = {tuple(str(k.key) for k in path): tuple(spec) for path, spec in specs}
    cfg = get_config(arch)
    with FakeTensorMode():
        params = {k: jax.tree.map(lambda s: torch.empty(s.shape), v)
                  for k, v in shapes.items() if k != "layers"}
        params["layers"] = [jax.tree.map(lambda s: torch.empty(s.shape[1:]), shapes["layers"])
                            ] * cfg.n_layers
        got = param_specs(params, cfg, tp)
    assert got == want
    if arch == "mamba2-2.7b":
        assert got[("layers", "ssm", "w_bc")] == (None, None, None)
        assert got[("layers", "ssm", "conv_w_x")] == (None, "model", None)
        assert got[("layers", "ssm", "A_log")] == (None, "model")


@pytest.mark.parametrize("arch, tp", [("mamba2-2.7b", 2), ("mamba2-2.7b", 4),
                                      ("hymba-1.5b", 8)])
def test_ssm_state_shape_is_the_reference(arch, tp):
    """Full width: the conv state holds d_inner / tp + 2 g n channels and
    the SSM state d_inner / (tp p) heads (mamba2 at TP 2: 2560 + 256
    channels, 40 heads)."""
    jst = jax.eval_shape(lambda: jssm.make_ssm_state(jax_config(arch), 2, tp))
    st = ssm.make_ssm_state(get_config(arch), 3, 2, tp, "meta")
    assert tuple(st.conv.shape) == (3,) + tuple(jst.conv.shape)
    assert tuple(st.ssm.shape) == (3,) + tuple(jst.ssm.shape)
    if (arch, tp) == ("mamba2-2.7b", 2):
        assert st.conv.shape[-1] == 2560 + 256 and st.ssm.shape[2] == 40


def test_serve_entry_point_at_tp2_on_cpu():
    cfg = get_config(ARCH, smoke=True)
    outs = _run_ranks("repro_torch.serve.disaggregated",
                      ["--arch", ARCH, "--smoke", "--device", "cpu", "--prompt-len", "130",
                       "--gen", "4", "--tp", "2"], 2)
    di_l = cfg.d_inner // 2
    for rank, (res,) in enumerate(outs):
        assert (res["rank"], res["tp"]) == (rank, 2)
        assert res["raw_transfer_exact"] and res["cache_finite"]
        assert res["cache_shapes"]["conv"] == [cfg.n_layers, 4, cfg.conv_width - 1,
                                               di_l + 2 * cfg.ssm_state]
        assert res["cache_shapes"]["ssm"] == [cfg.n_layers, 4, cfg.ssm_heads() // 2,
                                              cfg.ssm_head_dim, cfg.ssm_state]
