"""The port's kernel modules against the JAX package's kernels.

On the CPU each wrapper takes its plain version; the JAX side runs its
Pallas kernels in interpret mode, as tests/test_kernels.py does.  The
int8 codec must be bit-equal; flash attention agrees within that file's
tolerances (f32 2e-3, bf16 3e-2).  The CUDA kernels themselves are
held against their plain versions on the card by tests/test_torch_gpu.py.
"""

import ctypes
import re

from _hypothesis_compat import hypothesis, st
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.kernels import quant as jquant
from repro.kernels import ref as jref
from repro_torch.convert import to_tensor
from repro_torch.kernels import _build as tbuild
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant as tquant
from repro_torch.kernels import ref as tref

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _pair(a: np.ndarray, dt: str):
    """The same values as a JAX array and a torch tensor (bf16 rounded
    once, by JAX, then copied bit for bit)."""
    j = jnp.asarray(a, JDT[dt])
    return j, to_tensor(np.asarray(j), "cpu")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


# ---------------------------------------------------------------------------
# int8 codec
# ---------------------------------------------------------------------------

QUANT_SIZES = [1024, 4096, 1000, 3000, 5 * 1024 + 7]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n", QUANT_SIZES)
def test_quant_int8_bit_equal(n, dt):
    rng = np.random.default_rng(n)
    jx, tx = _pair(rng.normal(size=(n,)) * 3.0, dt)
    q, s = tquant.quant_int8_call(tx)
    jq, js, size = jops.quant_int8(jx, interpret=True)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    flat = jnp.asarray(jx, jnp.float32).reshape(-1)
    flat = jnp.concatenate([flat, jnp.zeros(((-n) % 1024,), jnp.float32)])
    # the eager reference truly divides amax by 127, the compiled kernel
    # multiplies by the reciprocal: scales may differ by one ulp (as
    # tests/test_kernels.py::test_quant_matches_ref_blocks allows)
    rq, rs = jref.quant_int8_block(flat)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-6)
    assert size == n


def test_quant_int8_all_zero_block():
    x = np.random.default_rng(1).normal(size=(3 * 1024,))
    x[1024:2048] = 0.0
    jx, tx = _pair(x, "f32")
    q, s = tquant.quant_int8_call(tx)
    jq, js, _ = jops.quant_int8(jx, interpret=True)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[1].item() == 1.0 and not q[1].any()


@pytest.mark.parametrize("qdt", [np.int8, np.int32])
@pytest.mark.parametrize("gain", [None, 0.37])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_dequant_int8_bit_equal(qdt, gain, dt):
    rng = np.random.default_rng(7)
    nb, size = 3, 3 * 1024 - 100
    lim = 127 if qdt == np.int8 else 127 * 8   # int32: a ring sum of 8 payloads
    q = rng.integers(-lim, lim + 1, size=(nb, 1024)).astype(qdt)
    s = rng.uniform(0.001, 2.0, size=(nb,)).astype(np.float32)
    got = tquant.dequant_int8_call(torch.from_numpy(q), torch.from_numpy(s),
                                   size, TDT[dt], gain)
    want = jquant.dequant_int8_call(jnp.asarray(q), jnp.asarray(s),
                                    dtype=JDT[dt], gain=gain,
                                    interpret=True)[:size]
    assert got.dtype == TDT[dt] and got.shape == (size,)
    np.testing.assert_array_equal(_np(got), np.asarray(want.astype(jnp.float32)))


CODEC_VIEW_SIZES = [1, 7, 1023, 1024, 1025, 8191, 3 * 1024 + 13]


def _at_offset(t: torch.Tensor, off: int) -> torch.Tensor:
    """``t``'s values as a view ``off`` elements into a larger buffer."""
    buf = torch.zeros(t.numel() + off, dtype=t.dtype)
    buf[off:] = t.reshape(-1)
    return buf[off:].view(t.shape)


def _same_bits(got: np.ndarray, want: np.ndarray) -> None:
    """f32 arrays equal bit for bit, NaN (of any payload) in the same places."""
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32), want[~nan].view(np.uint32))


@pytest.mark.parametrize("off", [0, 3])
@pytest.mark.parametrize("n", CODEC_VIEW_SIZES)
@pytest.mark.parametrize("kernel", ["quant_scaled", "dequant_int8"])
def test_shared_codec_plain_on_views_bit_equal(kernel, n, off):
    """The plain versions the CUDA kernels are held to, on ragged sizes and
    on views at an odd element offset (the scalar kernels' inputs), against
    the JAX package's kernels in interpret mode, with NaN and +-inf."""
    rng = np.random.default_rng(100 * n + off)
    nb = -(-n // 1024)
    scale = rng.uniform(1e-3, 0.05, size=(nb,)).astype(np.float32)
    scale[::5], scale[1::7], scale[2::11], scale[3::13] = 0.0, np.nan, np.inf, -1.0
    if kernel == "quant_scaled":
        x = rng.normal(size=(n,)) * 3
        x[::997], x[1::1499], x[2::1789] = np.nan, np.inf, -np.inf
        for dt in ("f32", "bf16"):
            jx, tx = _pair(x, dt)
            got = tquant.quant_scaled_plain(_at_offset(tx, off), torch.from_numpy(scale))
            jx = jnp.concatenate([jx, jnp.zeros((nb * 1024 - n,), jx.dtype)])
            want = jquant.quant_scaled_call(jx, jnp.asarray(scale), interpret=True)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    for qdt, lim in ((np.int8, 127), (np.int32, 127 * 8)):
        q = rng.integers(-lim, lim + 1, size=(nb, 1024)).astype(qdt)
        tq = _at_offset(torch.from_numpy(q), off)
        for dt in ("f32", "bf16"):
            for gain in (None, 0.37):
                got = tquant.dequant_int8_plain(tq, torch.from_numpy(scale), n, TDT[dt], gain)
                want = jquant.dequant_int8_call(jnp.asarray(q), jnp.asarray(scale),
                                                dtype=JDT[dt], gain=gain,
                                                interpret=True)[:n]
                assert got.dtype == TDT[dt] and got.shape == (n,)
                _same_bits(_np(got), np.asarray(want.astype(jnp.float32)))


@hypothesis.given(n=st.integers(1, 9000), scale=st.floats(1e-3, 1e3))
@hypothesis.settings(max_examples=25, deadline=None)
def test_quant_roundtrip_matches_reference(n, scale):
    """Property: the port's codec round trip is bit-equal to the JAX
    reference's and within half a step of the input."""
    x = (np.random.default_rng(n).normal(size=(n,)) * scale).astype(np.float32)
    q, s, size = tops.quant_int8(torch.from_numpy(x))
    back = tops.dequant_int8(q, s, size, (n,))
    jq, js, _ = jops.quant_int8(jnp.asarray(x), interpret=True)
    jback = jops.dequant_int8(jq, js, n, (n,), interpret=True)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))
    bound = float(np.max(np.abs(x))) / 127.0 * 0.51 + 1e-6
    assert float(np.max(np.abs(back.numpy() - x))) <= bound * 1.05


def test_cpu_tensors_take_the_plain_version():
    before = tops.launch_counts()
    x = torch.randn(2048)
    tquant.quant_int8_call(x)
    q = torch.zeros((2, 1024), dtype=torch.int8)
    tquant.dequant_int8_call(q, torch.ones(2), 2048)
    qkv = torch.randn(1, 2, 130, 64)
    tfa.flash_attention_bhsd(qkv, qkv, qkv)
    tquant.pack_slots_call([(3, x)], 4096)
    tquant.fused_pack_quant_call([(3, x)], 4096)
    assert tops.launch_counts() == before


# ---------------------------------------------------------------------------
# slot packing, alone and fused with the int8 codec
# ---------------------------------------------------------------------------

# leaf sizes: ragged ones, a 2048 (whole blocks), a scalar, an all-zero leaf
PACK_SHAPES = [(300, 7), (129,), (5,), (2048,), (), (37, 11), (2048 + 257,)]


def _pack_pieces(dt: str, padded_block: int):
    """The same leaves as (offset, JAX array) and (offset, torch tensor)
    pieces of one padded segment."""
    rng = np.random.default_rng(11)
    arrays = [rng.normal(size=shape) * 3 for shape in PACK_SHAPES]
    arrays[-1][:] = 0.0
    pairs = [_pair(a, dt) for a in arrays]
    offs = np.cumsum([0] + [a.size for a in arrays])
    padded = -(-int(offs[-1]) // padded_block) * padded_block
    return ([(int(o), j) for o, (j, _) in zip(offs, pairs)],
            [(int(o), t) for o, (_, t) in zip(offs, pairs)], padded)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_pack_slots_bit_equal(dt):
    jpieces, tpieces, padded = _pack_pieces(dt, 4096)
    want = jquant.pack_slots_call(jpieces, padded, JDT[dt], interpret=True)
    got = tquant.pack_slots_call(tpieces, padded, TDT[dt])
    assert got.dtype == TDT[dt] and got.shape == (padded,)
    np.testing.assert_array_equal(_np(got), np.asarray(jnp.asarray(want, jnp.float32)))
    assert not got[sum(t.numel() for _, t in tpieces):].any()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_fused_pack_quant_bit_equal(dt):
    """Blocks bit-equal; scales equal too (the Pallas kernel in interpret
    mode computes amax * f32(1/127) as the port does, ROADMAP.md R6)."""
    jpieces, tpieces, padded = _pack_pieces(dt, 1024)
    jq, js = jquant.fused_pack_quant_call(jpieces, padded, interpret=True)
    q, s = tquant.fused_pack_quant_call(tpieces, padded)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert (s == 1.0).any()                       # an all-zero block


def _many_leaves(dt: str):
    """40 small leaves (1-25 values) at offsets that are not multiples of
    8, with gaps, so one 1024-block holds more than 32 spans, words that
    straddle two spans and null spans in mid-block; bf16 and f32 in turns
    where ``dt`` is "mixed"."""
    rng = np.random.default_rng(21)
    sizes = rng.integers(1, 26, size=40)
    gaps = rng.integers(0, 3, size=40)
    jpieces, tpieces, pos = [], [], 3
    for i, (n, gap) in enumerate(zip(sizes, gaps)):
        pos += int(gap)
        j, t = _pair(rng.normal(size=int(n)) * 3,
                     ("bf16", "f32")[i % 2] if dt == "mixed" else dt)
        jpieces.append((pos, j))
        tpieces.append((pos, t))
        pos += int(n)
    return jpieces, tpieces, -(-pos // 1024) * 1024


@pytest.mark.parametrize("dt", ["f32", "bf16", "mixed"])
def test_fused_pack_quant_many_leaves_bit_equal(dt):
    jpieces, tpieces, padded = _many_leaves(dt)
    assert sum(off % 8 != 0 for off, _ in tpieces) > 32
    jq, js = jquant.fused_pack_quant_call(jpieces, padded, interpret=True)
    q, s = tquant.fused_pack_quant_call(tpieces, padded)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


# ---------------------------------------------------------------------------
# the C entry points' ctypes signatures
# ---------------------------------------------------------------------------

_C_TYPES = {"ptr": ctypes.c_void_p, "int": ctypes.c_int, "long long": ctypes.c_longlong,
            "float": ctypes.c_float}


def _c_entries() -> dict[str, list]:
    """Each ``extern "C"`` entry of csrc/*.cu -> the ctypes of its
    parameters, in order."""
    entries = {}
    for src in tbuild.sources():
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            types = []
            for param in params.split(","):
                decl = " ".join(param.split()[:-1]).replace("const ", "")
                types.append(_C_TYPES["ptr" if "*" in decl or "*" in param else decl])
            entries[name] = types
    return entries


def test_ctypes_signatures_match_the_c_entries():
    """kernels/_build.py binds every entry point with the parameters its
    source declares (amax_block_launch's vector flag included): ctypes
    would pass a missing or mistyped argument as it stands."""
    entries = _c_entries()
    assert entries.keys() == tbuild._SIGNATURES.keys()
    for name, types in entries.items():
        assert types == tbuild._SIGNATURES[name], name
    assert entries["amax_block_launch"][5] is ctypes.c_int


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # (B, Sq, Skv, H, K, dh, causal, window, dtype, tol): tests/test_kernels.py
    (2, 256, 256, 4, 2, 64, True, None, "f32", 2e-3),
    (1, 192, 192, 2, 1, 80, False, None, "f32", 2e-3),
    (1, 256, 256, 4, 1, 128, True, None, "bf16", 3e-2),
    (2, 130, 130, 2, 2, 64, True, 64, "f32", 2e-3),
    # bf16 at the shapes the card checks its tensor-core kernel at:
    # windows, ragged lengths, H/K = 8
    (2, 130, 130, 8, 1, 64, True, 64, "bf16", 3e-2),
    (1, 130, 130, 16, 2, 128, True, None, "bf16", 3e-2),
    (1, 130, 130, 8, 1, 80, False, 50, "bf16", 3e-2),
]


def _qkv(B, Sq, Skv, H, K, dh, dt, seed):
    rng = np.random.default_rng(seed)
    return (_pair(rng.normal(size=(B, Sq, H, dh)), dt),
            _pair(rng.normal(size=(B, Skv, K, dh)), dt),
            _pair(rng.normal(size=(B, Skv, K, dh)), dt))


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_vs_jax_kernel(case):
    B, Sq, Skv, H, K, dh, causal, window, dt, tol = case
    (jq, tq), (jk, tk), (jv, tv) = _qkv(B, Sq, Skv, H, K, dh, dt, Sq + dh)
    got = tops.flash_attention(tq, tk, tv, causal=causal, window=window)
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                interpret=True)
    assert got.dtype == TDT[dt] and got.shape == (B, Sq, H, dh)
    err = np.max(np.abs(_np(got) - np.asarray(want.astype(jnp.float32))))
    assert err < tol, err
    ref = tref.attention(tq, tk, tv, causal=causal, window=window)
    assert np.max(np.abs(_np(got) - _np(ref))) < tol


def test_flash_attention_offset_and_valid_kv_vs_jax_kernel():
    """q_offset > 0 and valid_kv < Skv, straight through both kernels'
    head-major entry points."""
    B, H, K, Sq, Skv, dh = 1, 4, 2, 128, 256, 64
    rng = np.random.default_rng(3)
    jq, tq = _pair(rng.normal(size=(B, H, Sq, dh)), "f32")
    jk, tk = _pair(rng.normal(size=(B, K, Skv, dh)), "f32")
    jv, tv = _pair(rng.normal(size=(B, K, Skv, dh)), "f32")
    kw = dict(causal=True, window=100, q_offset=70, valid_kv=180)
    got = tfa.flash_attention_bhsd(tq, tk, tv, **kw)
    want = jfa.flash_attention_bhsd(jq, jk, jv, block_q=128, block_k=128,
                                    interpret=True, **kw)
    assert np.max(np.abs(got.numpy() - np.asarray(want))) < 2e-3


def test_flash_attention_fully_masked_row_is_zero():
    q = torch.randn(1, 2, 4, 64)
    k = torch.randn(1, 1, 8, 64)
    out = tfa.flash_attention_bhsd(q, k, k, causal=True, valid_kv=0)
    assert torch.equal(out, torch.zeros_like(out))


def test_flash_attention_rejects_traced_offset():
    q = torch.randn(1, 2, 4, 64)
    with pytest.raises(TypeError):
        tfa.flash_attention_bhsd(q, q, q, q_offset=torch.tensor(0))
