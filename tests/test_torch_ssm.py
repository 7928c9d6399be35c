"""The port's Mamba2 (SSD) path against the JAX package, on the CPU.

Inputs come from a numpy seed and go through both packages.  The JAX side
runs its Pallas SSD kernel in interpret mode (``Runtime(use_pallas=True)``,
as tests/test_models_smoke.py does) unless a test names the jnp oracle.
Tolerances: f32 within 1e-4 abs and rel (only the summation order
differs); bf16 within the JAX suite's own SSD tolerance, 8e-2
(tests/test_kernels.py:51), since the two frameworks round bf16 at other
places; tokens, int8 blocks and shapes equal.  The conv state is bf16 in
either model dtype (the reference's ``ssm.py:135``): in an f32 model it
is the bf16 rounding of f32 values that agree to summation order, so it
must be bf16 and within one bf16 ulp of the reference's (a value that
lies on a rounding boundary may round the other way).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import ssd as jssd
from repro.launch.mesh import runtime_for_mesh
from repro.models import Model as JaxModel
from repro.models import ssm as jssm
from repro.parallel.sharding import Runtime as JaxRuntime
from repro.serve import make_kv_transfer as jax_kv_transfer
from repro.serve import make_serve_steps as jax_serve_steps
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, to_tensor
from repro_torch.kernels import ops, ref, ssd
from repro_torch.models import Model, ssm
from repro_torch.models.ssm import SSMState
from repro_torch.parallel.sharding import Runtime
from repro_torch.serve import disaggregated
from repro_torch.serve.serve_step import make_kv_transfer, make_serve_steps

ARCH = "mamba2-2.7b"
F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=8e-2, rtol=8e-2)
DT = {"f32": (jnp.float32, torch.float32, F32_TOL),
      "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}
JDT = {jnp.float32: "f32", jnp.bfloat16: "bf16"}

# tests/test_kernels.py:46-52: (b, s, h, p, g, n, chunk, dtype), then
# G = 2, H = 8: head h reads group h // (H / G), which h % G would not give
SSD_CASES = [
    (2, 256, 4, 32, 1, 64, 64, jnp.float32),
    (1, 128, 2, 64, 2, 32, 32, jnp.float32),
    (1, 128, 8, 32, 2, 32, 32, jnp.float32),
    (1, 256, 8, 64, 1, 128, 128, jnp.float32),
    (2, 128, 4, 32, 1, 64, 64, jnp.bfloat16),
]
B, S, GEN = 2, 130, 6     # S = 130 is ragged against the 128-token chunk


def _np(t) -> np.ndarray:
    t = torch.as_tensor(t)
    return (t.float() if t.is_floating_point() else t).numpy()


def _jnp(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32) if a.dtype == jnp.bfloat16 else a)


def _t(a) -> torch.Tensor:
    return to_tensor(np.asarray(a), "cpu")


def _ssd_inputs(case, seed=0):
    """numpy draws as tests/test_kernels.py makes them, in both packages."""
    b, s, h, p, g, n, chunk, jdt = case
    rng = np.random.default_rng(seed)
    arrs = dict(x=rng.normal(size=(b, s, h, p)),
                dt=rng.uniform(0.01, 0.2, size=(b, s, h)),
                A=-rng.uniform(0.5, 4.0, size=(h,)),
                B=rng.normal(size=(b, s, g, n)),
                C=rng.normal(size=(b, s, g, n)))
    dtypes = dict(x=jdt, dt=jnp.float32, A=jnp.float32, B=jdt, C=jdt)
    j = {k: jnp.asarray(v, dtypes[k]) for k, v in arrs.items()}
    return j, {k: _t(v) for k, v in j.items()}, DT[JDT[jdt]][2]


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_np(got), _jnp(want), **tol, err_msg=msg)


def _conv_state_close(got: torch.Tensor, want, model_dtype, msg=""):
    """The bf16 conv state: in a bf16 model within the bf16 tolerance; in
    an f32 model within one bf16 ulp (2^(e - 7) for a value in
    [2^e, 2^(e+1)))."""
    assert got.dtype == torch.bfloat16, got.dtype
    if model_dtype == torch.bfloat16:
        return _close(got, want, BF16_TOL, msg)
    a, b = _np(got).astype(np.float64), _jnp(want).astype(np.float64)
    mag = np.maximum(np.abs(a), np.abs(b))
    ulp = np.where(mag > 0, np.exp2(np.floor(np.log2(np.where(mag > 0, mag, 1))) - 7), 0)
    bad = np.abs(a - b) > ulp
    assert not bad.any(), f"{msg}: {bad.sum()} conv values beyond one bf16 ulp"


# ---------------------------------------------------------------------------
# plain references and the kernel's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", SSD_CASES)
def test_ref_ssd_chunked_vs_jax(case):
    j, t, tol = _ssd_inputs(case)
    chunk = case[6]
    y, h = ref.ssd_chunked(t["x"], t["dt"], t["A"], t["B"], t["C"], chunk=chunk)
    jy, jh = jref.ssd_chunked(j["x"], j["dt"], j["A"], j["B"], j["C"], chunk=chunk)
    assert y.dtype == t["x"].dtype and h.dtype == torch.float32
    _close(y, jy, tol)
    _close(h, jh, tol)


@pytest.mark.parametrize("case", SSD_CASES)
def test_ref_ssd_decode_step_vs_jax(case):
    j, t, tol = _ssd_inputs(case, seed=1)
    b, s, h, p, g, n = case[:6]
    state0 = np.random.default_rng(2).normal(size=(b, h, p, n)).astype(np.float32)
    jstate, state = jnp.asarray(state0), torch.from_numpy(state0)
    for i in range(3):
        y, state = ref.ssd_decode_step(state, t["x"][:, i], t["dt"][:, i], t["A"],
                                       t["B"][:, i], t["C"][:, i])
        jy, jstate = jref.ssd_decode_step(jstate, j["x"][:, i], j["dt"][:, i], j["A"],
                                          j["B"][:, i], j["C"][:, i])
        assert y.dtype == t["x"].dtype
        _close(y, jy, tol, f"step {i}")
        _close(state, jstate, tol, f"step {i}")


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ref_causal_conv1d_vs_jax(case, bias):
    """Over the conv input an SSM block would make at the case's shape:
    (b, s, h * p + 2 * g * n) channels, width 4."""
    b_, s, h, p, g, n, _, jdt = case
    tol = DT[JDT[jdt]][2]
    ch = h * p + 2 * g * n
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(b_, s, ch)), jdt)
    w = jnp.asarray(rng.normal(size=(ch, 4)), jdt)
    b = jnp.asarray(rng.normal(size=(ch,)), jdt) if bias else None
    got = ref.causal_conv1d(_t(x), _t(w), None if b is None else _t(b))
    want = jref.causal_conv1d(x, w, b)
    assert got.dtype == _t(x).dtype
    _close(got, want, tol)


def _jax_chunk_layout(j, chunk):
    """The reference's kernel inputs, as its ops.ssd_chunked makes them."""
    b, s, h, p = j["x"].shape
    g, n = j["B"].shape[2:]
    nc, rep = s // chunk, h // g
    Bh = jnp.repeat(j["B"], rep, axis=2)
    Ch = jnp.repeat(j["C"], rep, axis=2)
    xc = jnp.moveaxis(j["x"].reshape(b, nc, chunk, h, p), 3, 2)
    dtc = jnp.moveaxis(j["dt"].reshape(b, nc, chunk, h), 3, 2)
    Bc = jnp.moveaxis(Bh.reshape(b, nc, chunk, h, n), 3, 2)
    Cc = jnp.moveaxis(Ch.reshape(b, nc, chunk, h, n), 3, 2)
    return xc, dtc, Bc, Cc


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_chunk_plain_vs_jax_kernel(case):
    """The plain version against the Pallas kernel in interpret mode;
    the port's y_diag is sequence-major, (b, nc, q, h, p)."""
    j, t, tol = _ssd_inputs(case, seed=4)
    chunk = case[6]
    xc, dtc, Bc, Cc = _jax_chunk_layout(j, chunk)
    jy, jst = jssd.ssd_chunk_call(xc, dtc, j["A"], Bc, Cc, interpret=True)
    before = ssd.ssd_chunk_call.launches
    y, st = ssd.ssd_chunk_call(t["x"], t["dt"], t["A"], t["B"], t["C"], chunk)
    assert ssd.ssd_chunk_call.launches == before      # the CPU launches nothing
    assert y.dtype == st.dtype == torch.float32
    _close(y, jnp.moveaxis(jy, 3, 2), F32_TOL)        # f32 outputs in both
    _close(st, jst, F32_TOL)


@pytest.mark.parametrize("case", SSD_CASES)
def test_ops_ssd_chunked_vs_jax_ops(case):
    j, t, tol = _ssd_inputs(case, seed=5)
    chunk = case[6]
    y, h = ops.ssd_chunked(t["x"], t["dt"], t["A"], t["B"], t["C"], chunk=chunk)
    jy, jh = jops.ssd_chunked(j["x"], j["dt"], j["A"], j["B"], j["C"], chunk=chunk,
                              interpret=True)
    assert y.dtype == t["x"].dtype
    _close(y, jy, tol)
    _close(h, jh, tol)


def _bf16_parts(v: torch.Tensor, split: bool) -> list[torch.Tensor]:
    """v as the bf16 operands the kernel feeds the tensor cores: hi =
    bf16(v), and with ``split`` also lo = bf16(v - hi)."""
    hi = v.bfloat16().float()
    return [hi, (v - hi).bfloat16().float()] if split else [hi]


def _ssd_chunk_tensor_core_emulation(x, dt, A, B, C, chunk: int, split: bool):
    """The roundings of csrc/ssd.cu's bf16 kernel in plain PyTorch: C B^T
    from the exact bf16 operands with f32 sums; S = C B^T exp(seg) dt_j and
    x w in f32, each fed as bf16 parts and multiplied with the exact bf16 x
    or B, the products summed in f32."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    q, nc, rep = chunk, s // chunk, h // g
    xf = x.float().reshape(b, nc, q, h, p)
    dtf = dt.reshape(b, nc, q, h)
    Bf = B.float().reshape(b, nc, q, g, n)
    Cf = C.float().reshape(b, nc, q, g, n)
    cs = torch.cumsum(dtf * A, dim=2)
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]             # (b, nc, i, j, h)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool))
    seg = torch.where(causal[None, None, :, :, None], seg, ref.NEG_INF)
    cb = torch.einsum("bcign,bcjgn->bcijg", Cf, Bf).repeat_interleave(rep, dim=4)
    S = cb * torch.exp(seg) * dtf[:, :, None, :, :]
    y = sum(torch.einsum("bcijh,bcjhp->bcihp", part, xf) for part in _bf16_parts(S, split))
    xw = xf * (dtf * torch.exp(cs[:, :, -1:] - cs))[..., None]
    Bh = Bf.repeat_interleave(rep, dim=3)
    st = sum(torch.einsum("bcqhp,bcqhn->bchpn", part, Bh) for part in _bf16_parts(xw, split))
    return y, st


@pytest.mark.parametrize("split", [True, False])
def test_ssd_chunk_bf16_split_emulation_within_tolerance(split):
    """Why the bf16 kernel splits its f32 operands: at the mamba2-2.7b
    chunk shape (q 128, p 64, n 128; 8 heads, batch 2) with chip_smoke's
    input distributions, the hi + lo split keeps both outputs within the
    1e-4 of the plain output's largest magnitude that the kernel is held
    to on the card; one rounding to bf16 does not."""
    b, s, h, p, g, n, chunk = 2, 1024, 8, 64, 1, 128, 128
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(b, s, h, p)).astype(np.float32)).bfloat16()
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, size=(b, s, h)).astype(np.float32))
    A = torch.from_numpy(-rng.uniform(0.5, 4.0, size=(h,)).astype(np.float32))
    Bm = torch.from_numpy(rng.normal(size=(b, s, g, n)).astype(np.float32)).bfloat16()
    Cm = torch.from_numpy(rng.normal(size=(b, s, g, n)).astype(np.float32)).bfloat16()
    got = _ssd_chunk_tensor_core_emulation(x, dt, A, Bm, Cm, chunk, split)
    want = ssd.ssd_chunk_plain(x, dt, A, Bm, Cm, chunk)
    for what, a, w in zip(("y_diag", "states"), got, want):
        rel = ((a - w).abs().max() / w.abs().max()).item()
        assert (rel <= 1e-4) == split, f"{what}: max error {rel:.3g} of the largest magnitude"


def test_ssd_chunk_strided_views_match_contiguous():
    """The model hands the kernel views of its conv output (x, B and C
    are column slices of one tensor); the wrapper reads them as they are."""
    rng = np.random.default_rng(6)
    b, s, h, p, g, n = 2, 128, 4, 16, 1, 32
    conv = torch.from_numpy(rng.normal(size=(b, s, h * p + 2 * g * n)).astype(np.float32))
    x = conv[..., :h * p].reshape(b, s, h, p)
    Bm = conv[..., h * p:h * p + g * n].reshape(b, s, g, n)
    Cm = conv[..., h * p + g * n:].reshape(b, s, g, n)
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, size=(b, s, h)).astype(np.float32))
    A = -torch.linspace(0.5, 4.0, h)
    got = ops.ssd_chunked(x, dt, A, Bm, Cm, chunk=64)
    want = ops.ssd_chunked(x.contiguous(), dt, A, Bm.contiguous(), Cm.contiguous(),
                           chunk=64)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


# ---------------------------------------------------------------------------
# the SSM block
# ---------------------------------------------------------------------------

def _block(dt: str):
    jdt, tdt, tol = DT[dt]
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), dtype=jdt)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=tdt)
    jp = jssm.init_ssm(jax.random.key(1), jcfg, 1, jdt)
    tp = {k: _t(v) for k, v in jp.items()}
    x = np.random.default_rng(7).normal(size=(B, S, jcfg.d_model))
    return jcfg, tcfg, jp, tp, jnp.asarray(x, jdt), tol


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_apply_ssm_and_decode_vs_jax(dt):
    """Prefill at S = 130 (the pad path) then 3 single-token steps."""
    jcfg, tcfg, jp, tp, jx, tol = _block(dt)
    jrt = JaxRuntime(use_pallas=True)
    jout, jst = jax.jit(lambda p, x: jssm.apply_ssm(p, x, jcfg, jrt, return_state=True))(
        jp, jx)
    out, st = ssm.apply_ssm(tp, _t(jx), tcfg, Runtime())
    assert out.dtype == tcfg.dtype and st.conv.dtype == torch.bfloat16
    _close(out, jout, tol)
    _conv_state_close(st.conv, jst.conv, tcfg.dtype)
    _close(st.ssm, jst.ssm, tol)
    assert int(st.length) == int(jst.length) == S
    rng = np.random.default_rng(8)
    dec = jax.jit(lambda p, x, s: jssm.apply_ssm_decode(p, x, jcfg, jrt, s))
    for i in range(3):
        jt = jnp.asarray(rng.normal(size=(B, 1, jcfg.d_model)), jx.dtype)
        jout, jst = dec(jp, jt, jst)
        out, st2 = ssm.apply_ssm_decode(tp, _t(jt), tcfg, Runtime(), st)
        assert st2 is st                                 # updated in place
        _close(out, jout, tol, f"step {i}")
        _conv_state_close(st.conv, jst.conv, tcfg.dtype, f"step {i}")
        _close(st.ssm, jst.ssm, tol, f"step {i}")
        assert int(st.length) == int(jst.length) == S + i + 1


def test_conv_state_is_bf16_in_an_f32_model():
    """An f32 model still rounds its conv state to bf16 (the reference's
    ssm.py:135 and :187): the state differs from the f32 conv inputs."""
    jcfg, tcfg, jp, tp, jx, _ = _block("f32")
    _, st = ssm.apply_ssm(tp, _t(jx), tcfg, Runtime())
    assert st.conv.dtype == torch.bfloat16
    caches = Model(tcfg, device="cpu").init(0).make_caches(B, S)
    assert caches.conv.dtype == torch.bfloat16 and caches.ssm.dtype == torch.float32


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _models(dt: str, use_pallas: bool = True):
    jdt, tdt, _ = DT[dt]
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), dtype=jdt)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=tdt)
    jm = JaxModel(jcfg, JaxRuntime(use_pallas=use_pallas))
    params = jm.init(jax.random.key(0))
    tm = params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return jm, params, tm


SSM_LEAVES = ("w_z", "w_x", "w_bc", "w_dt", "dt_bias", "A_log", "D_skip",
              "conv_w_x", "conv_b_x", "conv_w_bc", "conv_b_bc", "norm_scale", "w_out")


def test_params_from_jax_is_bit_exact():
    jm, params, tm = _models("bf16")
    np.testing.assert_array_equal(_np(tm.embed), _jnp(params["embed"]))
    assert not hasattr(tm, "lm_head")                   # tied embeddings
    for i in range(len(tm.layers)):
        assert sorted(tm.layers[i]["ssm"].keys()) == sorted(SSM_LEAVES)
        for name in SSM_LEAVES:
            got, want = tm.layers[i]["ssm"][name], params["layers"]["ssm"][name][i]
            assert got.dtype == to_tensor(np.asarray(want), "cpu").dtype, name
            np.testing.assert_array_equal(_np(got), _jnp(want), err_msg=name)
        np.testing.assert_array_equal(_np(tm.layers[i]["norm_ssm"]["scale"]),
                                      _jnp(params["layers"]["norm_ssm"]["scale"][i]))


def test_caches_are_stacked_over_layers():
    """One leaf per kind, stacked (L, ...), with per-layer views: the int8
    transfer cuts 1024-value blocks across layers as the reference does."""
    cfg = get_config(ARCH, smoke=True)
    caches = Model(cfg, device="cpu").init(0).make_caches(B, S)
    ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    h = cfg.d_inner // cfg.ssm_head_dim
    assert isinstance(caches, SSMState)
    assert caches.conv.shape == (cfg.n_layers, B, cfg.conv_width - 1, ch)
    assert caches.ssm.shape == (cfg.n_layers, B, h, cfg.ssm_head_dim, cfg.ssm_state)
    assert caches.length.shape == (cfg.n_layers,) and caches.length.dtype == torch.int32
    assert caches.conv[1].numel() % 1024 != 0            # 960: blocks straddle layers
    view = caches.layer(1)
    view.ssm.fill_(2.0)
    assert bool((caches.ssm[1] == 2.0).all()) and bool((caches.ssm[0] == 0).all())


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_prefill_decode_vs_jax(dt):
    tol = DT[dt][2]
    jm, params, tm = _models(dt)
    EXTRA = 4
    toks = np.random.default_rng(9).integers(0, jm.cfg.vocab_size, (B, S + EXTRA))
    jl, jc = jax.jit(jm.apply_prefill)(params, jnp.asarray(toks[:, :S], jnp.int32))
    tl, tc = tm.apply_prefill(torch.from_numpy(toks[:, :S]))
    _close(tl, jl, tol)
    assert isinstance(tc, SSMState)

    def leaves_match(where):
        assert tc.conv.shape == jc.conv.shape
        _conv_state_close(tc.conv, jc.conv, tm.cfg.dtype, where)
        _close(tc.ssm, jc.ssm, tol, where)
        np.testing.assert_array_equal(_np(tc.length), np.asarray(jc.length))

    leaves_match("prefill")
    if dt == "f32":
        assert (tl.argmax(-1).numpy() == np.asarray(jl).argmax(-1)).all()
    dec = jax.jit(jm.apply_decode)
    for i in range(EXTRA):
        step = toks[:, S + i:S + i + 1]
        jl, jc = dec(params, jnp.asarray(step, jnp.int32), jc)
        tl, tc = tm.apply_decode(torch.from_numpy(step), tc)
        _close(tl, jl, tol, f"decode step {i}")
        leaves_match(f"decode step {i}")
        if dt == "f32":
            assert (tl.argmax(-1).numpy() == np.asarray(jl).argmax(-1)).all()
    assert _np(tc.length).tolist() == [S + EXTRA] * tm.cfg.n_layers


def test_training_forward_is_not_ported():
    cfg = get_config(ARCH, smoke=True)
    with pytest.raises(NotImplementedError, match="SSM training"):
        Model(cfg, device="cpu").init(0).apply_train(torch.zeros((1, 8), dtype=torch.long))


# ---------------------------------------------------------------------------
# serving: the transfer and disaggregated generation
# ---------------------------------------------------------------------------

def _serve_setup(dt: str):
    jdt, tdt, _ = DT[dt]
    mesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"))
    jm = JaxModel(dataclasses.replace(jax_config(ARCH, smoke=True), dtype=jdt),
                  runtime_for_mesh(mesh, use_pallas=True))
    params = jm.init(jax.random.key(0))
    tm = params_from_jax(jax.tree.map(np.asarray, params),
                         dataclasses.replace(get_config(ARCH, smoke=True), dtype=tdt),
                         device="cpu")
    prompt = np.random.default_rng(11).integers(0, jm.cfg.vocab_size, (B, S))
    jprefill, jdecode, cshape = jax_serve_steps(jm, mesh, B, S)
    jtransfer = jax_kv_transfer(jm, mesh, cshape, B, compress="int8")
    return jm, params, tm, prompt, jprefill, jdecode, jtransfer


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_int8_ssm_state_transfer_bit_equal_to_jax(dt):
    jm, params, tm, prompt, jprefill, _, jtransfer = _serve_setup(dt)
    _, jcaches = jprefill(params, jnp.asarray(prompt, jnp.int32))
    caches = SSMState(*(_t(a) for a in jcaches))
    moved = make_kv_transfer(tm, compress="int8")(caches)
    jmoved = jtransfer(jcaches)
    assert isinstance(moved, SSMState)
    for got, want, sent in zip(moved, jmoved, caches):
        assert got.shape == want.shape and got.dtype == sent.dtype
        np.testing.assert_array_equal(_np(got), _jnp(want))
    assert torch.equal(moved.length, caches.length)     # raw: fewer than 1024 values
    assert not torch.equal(moved.ssm, caches.ssm)       # int8 is lossy: it ran
    assert not torch.equal(moved.conv, caches.conv)


def _jax_generate(jdecode, params, tok, caches, steps):
    out = [np.asarray(tok)]
    for _ in range(steps):
        tok, caches = jdecode(params, tok, caches)
        out.append(np.asarray(tok))
    return np.concatenate(out, axis=1)


def test_disaggregated_generation_matches_jax_f32():
    """After the int8 transfer the port decodes the reference's tokens.
    The int8 transfer's token agreement with raw generation is then the
    same number in both packages: how far int8 moves the tokens is the
    reference's own behaviour, not the port's."""
    jm, params, tm, prompt, jprefill, jdecode, jtransfer = _serve_setup("f32")
    jtok, jcaches = jprefill(params, jnp.asarray(prompt, jnp.int32))
    jraw = _jax_generate(jdecode, params, jtok, jcaches, GEN)
    jtok, jcaches = jprefill(params, jnp.asarray(prompt, jnp.int32))
    jq = _jax_generate(jdecode, params, jtok, jtransfer(jcaches), GEN)

    prefill, decode = make_serve_steps(tm)
    tok, caches = prefill(torch.from_numpy(prompt))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    moved = make_kv_transfer(tm, compress="int8")(caches)
    raw = disaggregated._generate(decode, tok, caches, GEN)
    q = disaggregated._generate(decode, tok, moved, GEN)
    np.testing.assert_array_equal(raw.numpy(), jraw)
    np.testing.assert_array_equal(q.numpy(), jq)
    agree, jagree = float((raw == q).float().mean()), float((jraw == jq).mean())
    print(f"int8 token agreement, {ARCH} smoke f32, {B} x {S} prompt, {GEN} "
          f"decoded: port {agree:.4f}, reference {jagree:.4f}")
    assert agree == jagree


def test_entry_point_smoke_on_cpu(capsys):
    disaggregated.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--prompt-len", "130", "--gen", "4"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cfg = get_config(ARCH, smoke=True)
    assert res["arch"] == cfg.name and res["device"] == "cpu"
    assert res["raw_transfer_exact"] and res["cache_finite"]
    assert 0.0 <= res["int8_token_agreement"] <= 1.0
    ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    batch = res["batch"]
    assert res["cache_shapes"] == {
        "conv": [cfg.n_layers, batch, cfg.conv_width - 1, ch],
        "ssm": [cfg.n_layers, batch, cfg.d_inner // cfg.ssm_head_dim, cfg.ssm_head_dim,
                cfg.ssm_state],
        "length": [cfg.n_layers]}
    # the CPU takes the plain versions: no kernel launches anywhere
    assert all(n == 0 for counts in res["launches"].values() for n in counts.values())


def test_entry_point_needs_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        disaggregated.run(ARCH, smoke=True, batch=1, prompt_len=8, gen=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        disaggregated.main(["--arch", ARCH, "--smoke", "--prompt-len", "8", "--gen", "1"])
