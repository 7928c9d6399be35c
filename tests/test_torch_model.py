"""The port's Model against the JAX package's Model, smoke qwen2.5-3b.

Parameters come from the JAX init through ``params_from_jax``; tokens
from a numpy seed.  f32 agrees at atol/rtol 1e-4 (summation order only)
with identical greedy tokens; bf16 at tests/test_serve.py's 0.06/0.05
(the two frameworks round bf16 at other places).  A 130-token prompt
takes the flash path in the port (ragged against its 64-query tiles).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import Model as JaxModel
from repro.parallel.sharding import Runtime as JaxRuntime
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import Model

DTYPES = {"f32": (jnp.float32, torch.float32, dict(atol=1e-4, rtol=1e-4)),
          "bf16": (jnp.bfloat16, torch.bfloat16, dict(atol=0.06, rtol=0.05))}
EXTRA = 4


def _models(dt: str):
    jdt, tdt, _ = DTYPES[dt]
    jcfg = dataclasses.replace(jax_config("qwen2.5-3b", smoke=True), dtype=jdt)
    tcfg = dataclasses.replace(get_config("qwen2.5-3b", smoke=True), dtype=tdt)
    jm = JaxModel(jcfg, JaxRuntime())
    params = jm.init(jax.random.key(0))
    tm = params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return jm, params, tm


def _np(t) -> np.ndarray:
    t = torch.as_tensor(t)
    return (t.float() if t.is_floating_point() else t).numpy()


def _jnp(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32) if a.dtype == jnp.bfloat16 else a)


def test_params_from_jax_is_bit_exact():
    jm, params, tm = _models("bf16")
    np.testing.assert_array_equal(_np(tm.embed), _jnp(params["embed"]))
    for i in (0, len(tm.layers) - 1):
        for name in ("wq", "bk", "wo"):
            np.testing.assert_array_equal(
                _np(tm.layers[i]["attn"][name]),
                _jnp(params["layers"]["attn"][name][i]))
        np.testing.assert_array_equal(
            _np(tm.layers[i]["mlp"]["w_down"]),
            _jnp(params["layers"]["mlp"]["w_down"][i]))


@pytest.mark.parametrize("max_extra", [None, 8])
@pytest.mark.parametrize("S", [16, 130])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_prefill_decode_vs_jax(dt, S, max_extra):
    tol = DTYPES[dt][2]
    jm, params, tm = _models(dt)
    B = 2
    toks = np.random.default_rng(S).integers(0, jm.cfg.vocab_size, (B, S + EXTRA))
    max_len = None if max_extra is None else S + max_extra
    jl, jc = jax.jit(lambda p, t: jm.apply_prefill(p, t, max_len=max_len))(
        params, jnp.asarray(toks[:, :S], jnp.int32))
    tl, tc = tm.apply_prefill(torch.from_numpy(toks[:, :S]), max_len=max_len)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **tol)
    assert tc.k.shape == jc.k.shape and tc.k.dtype == tm.cfg.dtype
    np.testing.assert_allclose(_np(tc.k), _jnp(jc.k), **tol)
    np.testing.assert_allclose(_np(tc.v), _jnp(jc.v), **tol)
    np.testing.assert_array_equal(_np(tc.length), np.asarray(jc.length))
    if dt == "f32":
        assert (tl.argmax(-1).numpy() == np.asarray(jl).argmax(-1)).all()
    dec = jax.jit(jm.apply_decode)
    for i in range(EXTRA):
        step = toks[:, S + i:S + i + 1]
        jl, jc = dec(params, jnp.asarray(step, jnp.int32), jc)
        tl, tc = tm.apply_decode(torch.from_numpy(step), tc)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **tol,
                                   err_msg=f"decode step {i}")
        if dt == "f32":
            assert (tl.argmax(-1).numpy() == np.asarray(jl).argmax(-1)).all()
    np.testing.assert_allclose(_np(tc.k), _jnp(jc.k), **tol)
    np.testing.assert_array_equal(_np(tc.length), np.asarray(jc.length))


def test_init_is_seeded_and_shaped():
    cfg = get_config("qwen2.5-3b", smoke=True)
    a = Model(cfg, device="cpu").init(3)
    b = Model(cfg, device="cpu").init(3)
    assert torch.equal(a.layers[1]["attn"]["wq"], b.layers[1]["attn"]["wq"])
    assert a.embed.shape == (cfg.padded_vocab(1), cfg.d_model)
    assert a.embed.dtype == torch.bfloat16
    n = sum(p.numel() for p in a.parameters())
    # analytic count (unpadded, tied) plus the qkv biases and norm scales
    bias = cfg.n_layers * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
    norms = (2 * cfg.n_layers + 1) * cfg.d_model
    assert n == cfg.param_count() + bias + norms


def _train_forward(arch: str):
    model = Model(get_config(arch, smoke=True), device="cpu").init(0)
    model.apply_train(torch.zeros((1, 8), dtype=torch.long))


@pytest.mark.parametrize("what, build", [
    ("mixtral-8x7b (moe)", lambda: Model(get_config("mixtral-8x7b", smoke=True),
                                         device="cpu")),
    ("hymba-1.5b (hybrid)", lambda: Model(get_config("hymba-1.5b", smoke=True),
                                          device="cpu")),
    ("whisper-tiny (encdec)", lambda: Model(get_config("whisper-tiny", smoke=True),
                                            device="cpu")),
    ("mamba2-2.7b training forward", lambda: _train_forward("mamba2-2.7b")),
])
def test_families_not_ported_raise(what, build):
    with pytest.raises(NotImplementedError):
        build()
