"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device.  The
file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The int8 codecs (local-scale and shared-scale) are bit-equal, NaN and
infinite blocks included (a NaN scale or amax in the same place), and
``amax_block``/``quant_scaled``/``dequant_int8`` are so at ragged sizes
and on views at every element offset, whose base alignment picks the
vector or the scalar kernel; slot packing and fused pack+quantize are
bit-equal, past 2^31 elements too, and the fused kernel on trees that take
every branch of its span walk; flash
attention agrees within
tests/test_kernels.py's tolerances (f32 2e-3, bf16 3e-2: P is rounded to
bf16), each case counted on its route; bf16 at dh 64 and 128 runs on the
"wgmma" route (TMA and wgmma), f32 on the "tf32x3" route (3xTF32
mma.sync, also on views off 16 bytes) and at the qwen2.5-3b shape within
``TF32X3_TOL`` of the plain f32 output, which one TF32 product would miss
(``-k flash`` runs these alone); the SSD chunk
within 1e-4 of its plain output's largest magnitude (f32 inputs: the
tensor cores at f32 accuracy, 3xTF32, and at the mamba2-2.7b shape
within 1e-5; bf16 inputs: the tensor cores, with the f32 operands split
into bf16 hi + lo).  The SSD chunk
and flash attention, which have no backward, refuse to run under
autograd with an input that requires grad.  Three f32 smoke
training steps with ``hier_overlap`` (its buckets synced inside the
backward) and with ``fsdp``, int8 on the pod hop, in a world of one
(NCCL for the card, gloo for the CPU): losses and parameters within 1e-4
of the same steps on the CPU, and the codec launched once per bucket or
per leaf.  Each wrapper's shape-only branch (the dry run's, for fake
tensors) gives the outputs' shapes, dtypes and strides its launch
writes, counted in ``.fake_launches`` and never in ``.launches``; and
the dry run's trace of qwen2.5-3b with ``device="cuda"`` calls each
kernel as often as the card's path launches it.
"""

import copy

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import packing
from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import quant as tquant
from repro_torch.kernels import ssd as tssd
from repro_torch.models import Model

TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
KV_LEAF = 36 * 4 * 1024 * 2 * 128     # one (L, B, S, kl, dh) qwen2.5-3b leaf

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n", [1024, 1000, 5 * 1024 + 7, KV_LEAF])
def test_quant_dequant_bit_equal(cuda, n, dt):
    x = torch.randn(n, device=cuda).to(TDT[dt]) * 3
    x[:1024] = 0                                  # an all-zero block
    q, s = tquant.quant_int8_call(x)
    pq, ps = tquant.quant_int8_plain(x)
    assert torch.equal(q, pq) and torch.equal(s, ps)
    for qq, gain in ((q, None), (q.int() * 3, 0.25)):
        got = tquant.dequant_int8_call(qq, s, n, TDT[dt], gain)
        assert torch.equal(got, tquant.dequant_int8_plain(qq, s, n, TDT[dt], gain))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n", [1024, 1000, 5 * 1024 + 7, 3 * 1024 * 1024 + 5])
def test_shared_scale_codec_bit_equal(cuda, n, dt):
    x = torch.randn(n, device=cuda).to(TDT[dt]) * 3
    x[:1024] = 0                                  # an all-zero block
    a = tquant.amax_block_call(x)
    assert torch.equal(a, tquant.amax_block_plain(x))
    scale = a / 127
    scale[1:3] = torch.tensor([0.0, -1.0], device=cuda)[: scale.numel() - 1]
    q = tquant.quant_scaled_call(x, scale)
    torch.cuda.synchronize()
    assert torch.equal(q, tquant.quant_scaled_plain(x, scale))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_codecs_nan_and_inf_blocks_bit_equal(cuda, dt):
    """A NaN block max propagates (scale 1 after the > 0 test), NaN
    quotients quantize to 0, infinities clip."""
    x = torch.randn(4 * 1024 + 9, device=cuda).to(TDT[dt])
    x[5], x[1024 + 7], x[2048 + 9], x[3072 + 1] = (float("nan"), float("inf"),
                                                   -float("inf"), float("nan"))
    x[3072 + 2] = float("inf")
    a = tquant.amax_block_call(x)             # equal, NaN in the same places
    torch.testing.assert_close(a, tquant.amax_block_plain(x), rtol=0, atol=0,
                               equal_nan=True)
    assert a[[0, 3]].isnan().all() and a[[1, 2]].isinf().all()
    inf, nan = float("inf"), float("nan")
    for scale in (a / 127, torch.tensor([1.0, inf, 0.5, nan, 2.0], device=cuda)):
        q = tquant.quant_scaled_call(x, scale)
        assert torch.equal(q, tquant.quant_scaled_plain(x, scale))
    q, s = tquant.quant_int8_call(x)
    pq, ps = tquant.quant_int8_plain(x)
    assert torch.equal(q, pq)
    torch.testing.assert_close(s, ps, rtol=0, atol=0, equal_nan=True)


def test_quant_scaled_ties_and_clipping(cuda):
    k = torch.arange(2048, device=cuda) % 300 - 150
    x = (k + 0.5) * 0.25                          # exact .5 ties at scale 0.25
    x[1024:] = torch.where(k[1024:] % 2 == 0, 127 * 0.25, -200 * 0.25)
    scale = torch.full((2,), 0.25, device=cuda)
    q = tquant.quant_scaled_call(x, scale)
    assert torch.equal(q, tquant.quant_scaled_plain(x, scale))
    assert q[1].abs().eq(127).all()


# ragged sizes around the 1024-value block and the 8192-value tile, and one
# of more tiles than the vector kernels' grid has CTAs (the grid stride)
VIEW_SIZES = [1, 7, 1023, 1024, 1025, 8191, 3 * 1024 + 13, 12 * 2 ** 20 + 333]
_INT_VIEW = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def _at_offset(t: torch.Tensor, off: int) -> torch.Tensor:
    """``t``'s values as a view ``off`` elements into a new buffer."""
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    assert buf.data_ptr() % tquant.VECTOR_ALIGN == 0
    view = buf[off:].view(t.shape)
    view.copy_(t)
    return view


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, NaN (of any payload) in the same places."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    nan = a.isnan()
    return bool(torch.equal(nan, b.isnan())
                and torch.equal(a.view(_INT_VIEW[a.dtype])[~nan],
                                b.view(_INT_VIEW[b.dtype])[~nan]))


def _shared_scales(nb: int, g) -> torch.Tensor:
    """Per-block scales with 0, NaN, +inf and negative entries."""
    s = torch.rand(nb, device=g.device, generator=g) * 0.05 + 1e-3
    s[::5], s[1::7], s[2::11], s[3::13] = 0.0, float("nan"), float("inf"), -1.0
    return s


def _launched(fn, vector: bool, before: tuple[int, int]) -> bool:
    return (fn.launches, fn.vector_launches) == (before[0] + 1, before[1] + vector)


@pytest.mark.parametrize("off", range(8))
@pytest.mark.parametrize("n", VIEW_SIZES)
def test_quant_scaled_views_bit_equal(cuda, n, off):
    g = torch.Generator(device=cuda).manual_seed(n + off)
    scale = _shared_scales(-(-n // 1024), g)
    fn = tquant.quant_scaled_call
    for dt in ("f32", "bf16"):
        x = (torch.randn(n, device=cuda, generator=g) * 3).to(TDT[dt])
        x[::997], x[1::1499], x[2::1789] = float("nan"), float("inf"), -float("inf")
        xv = _at_offset(x, off)
        before = fn.launches, fn.vector_launches
        q = fn(xv, scale)
        assert torch.equal(q, tquant.quant_scaled_plain(xv, scale)), dt
        assert _launched(fn, off * x.element_size() % 16 == 0, before), dt


@pytest.mark.parametrize("off", range(8))
@pytest.mark.parametrize("n", VIEW_SIZES)
def test_dequant_int8_views_bit_equal(cuda, n, off):
    g = torch.Generator(device=cuda).manual_seed(n + off)
    nb = -(-n // 1024)
    s = _shared_scales(nb, g)
    fn = tquant.dequant_int8_call
    for qdt, lim in ((torch.int8, 127), (torch.int32, 127 * 8)):
        q = torch.randint(-lim, lim + 1, (nb, 1024), device=cuda, generator=g).to(qdt)
        qv = _at_offset(q, off)
        for dt in ("f32", "bf16"):
            for gain in (None, 0.37):
                before = fn.launches, fn.vector_launches
                got = fn(qv, s, n, TDT[dt], gain)
                want = tquant.dequant_int8_plain(qv, s, n, TDT[dt], gain)
                assert _bits_equal(got, want), (qdt, dt, gain)
                assert _launched(fn, off * q.element_size() % 16 == 0, before), (qdt, dt)


def _sparse_nan_inf(x: torch.Tensor) -> torch.Tensor:
    """NaN, +inf and -inf in a few blocks only, so most block maxima stay
    finite."""
    i = torch.arange(x.numel(), device=x.device)
    x[i % 5003 == 17] = float("nan")
    x[i % 7919 == 100] = float("inf")
    x[i % 6007 == 2000] = -float("inf")
    return x


@pytest.mark.parametrize("off", range(8))
@pytest.mark.parametrize("n", VIEW_SIZES)
def test_amax_block_views_bit_equal(cuda, n, off):
    g = torch.Generator(device=cuda).manual_seed(n + off)
    fn = tquant.amax_block_call
    for dt in ("f32", "bf16"):
        x = _sparse_nan_inf((torch.randn(n, device=cuda, generator=g) * 3).to(TDT[dt]))
        xv = _at_offset(x, off)
        before = fn.launches, fn.vector_launches
        a = fn(xv)
        assert _bits_equal(a, tquant.amax_block_plain(xv)), dt
        assert _launched(fn, off * x.element_size() % 16 == 0, before), dt


def test_vector_launch_refuses_a_misaligned_base(cuda):
    """The C entries refuse a vector launch on a base that is not 16-byte
    aligned (the wrappers never ask for one)."""
    from repro_torch.kernels import _build

    lib, stream = _build.library(), _build.stream_handle(cuda)
    x = torch.zeros(2048 + 1, dtype=torch.bfloat16, device=cuda)[1:]
    s = torch.ones(2, device=cuda)
    q = torch.empty((2, 1024), dtype=torch.int8, device=cuda)
    assert lib.quant_scaled_launch(x.data_ptr(), _build.BF16, x.numel(), s.data_ptr(),
                                   q.data_ptr(), 2, 1, stream) == -1
    qi = torch.zeros(2048 + 1, dtype=torch.int8, device=cuda)[1:]
    out = torch.empty(2048, dtype=torch.bfloat16, device=cuda)
    assert lib.dequant_int8_launch(qi.data_ptr(), _build.INT8, s.data_ptr(), 2048,
                                   out.data_ptr(), _build.BF16, 1, stream) == -1
    assert lib.amax_block_launch(x.data_ptr(), _build.BF16, x.numel(), s.data_ptr(), 2, 1,
                                 stream) == -1


def _leaves(dev, dt):
    """A gradient tree's leaves: 16-byte-aligned and ragged sizes, a list
    leaf (per-layer tensors standing for their stack), a scalar."""
    g = torch.Generator(device=dev).manual_seed(4)

    def r(*shape):
        return torch.randn(shape, device=dev, generator=g).to(TDT[dt])

    return [r(64, 32), [r(129) for _ in range(3)], r(5), r(2048), r(), r(37, 11)]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_pack_vs_plain(cuda, dt):
    """``packing.pack`` launches pack_slots once per segment on the card and
    gives the bits of the plain pack on the CPU; the tail pad is zero."""
    leaves = _leaves(cuda, dt)
    layout = packing.plan_layout(packing.tree_metas(leaves), world=4, n_chunks=4,
                                 block=1024)
    before = tquant.pack_slots_call.launches
    got = packing.pack(layout, leaves)
    cpu = [[p.cpu() for p in lf] if isinstance(lf, list) else lf.cpu() for lf in leaves]
    want = packing.pack(layout, cpu)
    torch.cuda.synchronize()
    assert tquant.pack_slots_call.launches == before + len(layout.segments)
    for seg in layout.segments:
        assert torch.equal(got[seg.dtype].cpu(), want[seg.dtype])
        assert not got[seg.dtype][seg.used:].any()


@pytest.mark.parametrize("src, dst", [("f32", "bf16"), ("bf16", "f32")])
def test_pack_slots_casts_as_copy_does(cuda, src, dst):
    pieces = [(3, torch.randn(1000, device=cuda).to(TDT[src]) * 7),
              (2000, torch.randn(40, 50, device=cuda).to(TDT[src]))]
    got = tquant.pack_slots_call(pieces, 8192, TDT[dst])
    assert torch.equal(got, tquant.pack_slots_plain(pieces, 8192, TDT[dst]))


def test_pack_slots_past_2_31(cuda):
    """An aligned piece that ends just under 2^31, a gap, a misaligned
    piece past 2^31 and the tail pad: the 64-bit vector and element paths."""
    n0 = 2 ** 31 - 1000
    big = torch.empty(n0, dtype=torch.bfloat16, device=cuda)
    for c0 in range(0, n0, 1 << 28):
        big[c0:c0 + (1 << 28)] = torch.randn(min(1 << 28, n0 - c0), device=cuda)
    tail = torch.randn(4099, device=cuda).to(torch.bfloat16)
    padded = packing.aligned_size(n0 + 3 + tail.numel(), 4096)
    pieces = [(0, big), (n0 + 3, tail)]
    got = tquant.pack_slots_call(pieces, padded, torch.bfloat16)
    assert torch.equal(got[:n0], big)
    assert not got[n0:n0 + 3].any() and not got[n0 + 3 + tail.numel():].any()
    assert torch.equal(got[n0 + 3:n0 + 3 + tail.numel()], tail)


def test_pack_slots_refuses_strided_and_overlapping_pieces(cuda):
    x = torch.randn(64, 64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tquant.pack_slots_call([(0, x.t())], 8192)
    with pytest.raises(ValueError, match="overlaps"):
        tquant.pack_slots_call([(0, x), (4000, x)], 8192)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_fused_pack_quant_vs_plain_and_composition(cuda, dt):
    """Blocks and scales bit-equal to the plain version and to pack ->
    quant_int8 on the card, a ragged leaf and an all-zero block included."""
    leaves = _leaves(cuda, dt)
    leaves.append(torch.zeros(2048 + 257, dtype=TDT[dt], device=cuda))
    layout = packing.plan_layout(packing.tree_metas(leaves), world=1, block=1024)
    seg = layout.segments[0]
    pieces = packing.segment_pieces(layout, leaves)[seg.dtype]
    q, s = tquant.fused_pack_quant_call(pieces, seg.padded)
    pq, ps = tquant.fused_pack_quant_plain(pieces, seg.padded)
    cq, cs = tquant.quant_int8_call(tquant.pack_slots_call(pieces, seg.padded, TDT[dt]))
    assert torch.equal(q, pq) and torch.equal(s, ps)
    assert torch.equal(q, cq) and torch.equal(s, cs)
    assert (s == 1.0).any()                       # the all-zero block


def _stress_trees(dev) -> dict:
    """Piece lists that drive every branch of fused_pack_quant's table walk:
    name -> (pieces, padded)."""
    g = torch.Generator().manual_seed(21)

    def leaf(n, dt):
        return (torch.randn(n, generator=g) * 3).to(dt).to(dev)

    def back_to_back(sizes, dtypes, gaps=None):
        pieces, pos = [], 0
        for i, n in enumerate(sizes):
            pos += gaps[i] if gaps else 0
            pieces.append((pos, leaf(n, dtypes[i % len(dtypes)])))
            pos += n
        return pieces, -(-(pos + 1) // 1024) * 1024

    bf16, f32 = torch.bfloat16, torch.float32
    odd = leaf(3 + 4096, bf16)[3:]                # a source 6 bytes off 16
    return {
        # more than 32 spans in block 0, offsets not multiples of 8, words
        # straddling two spans, bf16 and f32 in turns
        "40 small leaves, bf16/f32": back_to_back(
            torch.randint(1, 26, (40,), generator=g).tolist(), (bf16, f32)),
        # null spans in mid-block (300-517, 717-2100) and whole null blocks
        "gaps": ([(0, leaf(300, bf16)), (517, leaf(200, f32)), (2100, leaf(5000, bf16))],
                 10240),
        # blocks inside one span: 16-byte words where the source allows
        # them (offsets 0, 4096, 12296, 16396), values where it does not
        # (the unaligned source at 8192, the bf16 leaf at 20501)
        "aligned and unaligned words": ([(0, leaf(4096, bf16)), (4096, leaf(4096, f32)),
                                         (8192, odd), (12296, leaf(4096, bf16)),
                                         (16396, leaf(4096, f32)), (20501, leaf(3000, bf16))],
                                        24576),
        # a table of more than 1024 rows: three search rounds
        "1100 leaves with gaps": back_to_back(
            torch.randint(1, 3000, (1100,), generator=g).tolist(), (bf16, f32, f32),
            torch.randint(0, 4, (1100,), generator=g).tolist()),
    }


def test_fused_pack_quant_stress_trees(cuda):
    """Bit-equal to the plain version and to pack -> quant_int8 on trees
    that take every branch of the kernel's walk, one launch each."""
    for name, (pieces, padded) in _stress_trees(cuda).items():
        before = tquant.fused_pack_quant_call.launches
        q, s = tquant.fused_pack_quant_call(pieces, padded)
        assert tquant.fused_pack_quant_call.launches == before + 1
        pq, ps = tquant.fused_pack_quant_plain(pieces, padded)
        cq, cs = tquant.quant_int8_call(tquant.pack_slots_call(pieces, padded))
        assert torch.equal(q, pq) and torch.equal(s, ps), name
        assert torch.equal(q, cq) and torch.equal(s, cs), name
    pieces, padded = _stress_trees(cuda)["1100 leaves with gaps"]
    assert tquant._span_table(pieces, padded, "test")[0].shape[0] > 1024


FLASH_CASES = [
    # (B, Sq, Skv, H, K, dh, causal, window, dtype, tol)
    (4, 1024, 1024, 16, 2, 128, True, None, "bf16", 3e-2),
    (2, 256, 256, 4, 2, 64, True, None, "f32", 2e-3),
    (1, 192, 192, 2, 1, 80, False, None, "f32", 2e-3),
    (2, 130, 130, 2, 2, 64, True, 64, "f32", 2e-3),
    (2, 130, 130, 4, 2, 16, True, None, "f32", 2e-3),
    (1, 128, 256, 4, 2, 32, True, 100, "bf16", 3e-2),
    # bf16 runs on the tensor cores: every head size, ragged Sq and Skv
    # off the 64-row and 64-key tiles, windows, non-causal, H/K = 8
    (2, 130, 200, 8, 1, 16, True, None, "bf16", 3e-2),
    (2, 200, 130, 4, 2, 32, False, None, "bf16", 3e-2),
    (2, 130, 130, 8, 1, 64, True, 64, "bf16", 3e-2),
    (1, 192, 192, 2, 1, 80, False, None, "bf16", 3e-2),
    (2, 130, 200, 4, 2, 80, True, 50, "bf16", 3e-2),
    (2, 200, 200, 16, 2, 128, True, 100, "bf16", 3e-2),
    (1, 130, 200, 16, 2, 128, False, 70, "bf16", 3e-2),
    # f32 on the tensor cores (3xTF32): every head size, ragged Sq and Skv
    # off the 64-row and 32-key tiles, windows, non-causal, H/K = 8
    (2, 130, 200, 8, 1, 16, True, None, "f32", 2e-3),
    (2, 200, 130, 4, 2, 32, False, None, "f32", 2e-3),
    (2, 130, 130, 8, 1, 64, True, 64, "f32", 2e-3),
    (2, 130, 200, 4, 2, 80, True, 50, "f32", 2e-3),
    (2, 200, 200, 16, 2, 128, True, 100, "f32", 2e-3),
    (1, 130, 200, 16, 2, 128, False, 70, "f32", 2e-3),
    (1, 77, 45, 8, 1, 32, True, None, "f32", 2e-3),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_vs_plain(cuda, case):
    B, Sq, Skv, H, K, dh, causal, window, dt, tol = case
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(B, H, Sq, dh, device=cuda, generator=g).to(TDT[dt])
    k = torch.randn(B, K, Skv, dh, device=cuda, generator=g).to(TDT[dt])
    v = torch.randn(B, K, Skv, dh, device=cuda, generator=g).to(TDT[dt])
    route = tfa.route(TDT[dt], dh)
    for kw in (dict(), dict(q_offset=Skv - Sq + 3, valid_kv=Skv - 5)):
        before = ops.route_launch_counts()["flash_attention_bhsd"]
        got = tfa.flash_attention_bhsd(q, k, v, causal=causal, window=window, **kw)
        want = tfa.flash_attention_bhsd_plain(q, k, v, causal=causal,
                                              window=window, **kw)
        torch.cuda.synchronize()
        assert ops.route_launch_counts()["flash_attention_bhsd"] == {
            **before, route: before[route] + 1}, kw
        assert (got.float() - want.float()).abs().max().item() < tol, kw


@pytest.fixture
def full_f32_matmul():
    """The plain version's products in full f32, whatever a test before
    set (TF32 matmuls would put the yardstick at the TF32 product's error)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved


def test_flash_attention_f32_at_the_qwen_shape_is_3xtf32_accurate(cuda, full_f32_matmul):
    """f32 at the qwen2.5-3b prefill shape (4 x 1024, 16 Q / 2 KV heads of
    128, causal) on the "tf32x3" route, within ``TF32X3_TOL`` (2e-5) of the
    plain f32 output's largest magnitude: the 3-product split meets it
    (1.6e-6 on an H100 80GB HBM3 at 700 W) and one TF32 product misses it
    (4.1e-4 there, as a variant of tools/flash_report.py; 4.7e-4-6.1e-4 in
    tests/test_torch_kernels.py's emulation); the 2e-3 that f32 callers
    are held to stays as it is."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(4, 16, 1024, 128, device=cuda, generator=g)
    k = torch.randn(4, 2, 1024, 128, device=cuda, generator=g)
    v = torch.randn(4, 2, 1024, 128, device=cuda, generator=g)
    before = ops.route_launch_counts()["flash_attention_bhsd"]["tf32x3"]
    got = tfa.flash_attention_bhsd(q, k, v, causal=True)
    want = tfa.flash_attention_bhsd_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert ops.route_launch_counts()["flash_attention_bhsd"]["tf32x3"] == before + 1
    err = (got - want).abs().max().item()
    assert err <= tfa.TF32X3_TOL * want.abs().max().item(), err


def test_flash_attention_f32_views_off_16_bytes(cuda):
    """f32 views whose base is one float off 16 bytes and whose row stride
    is odd (67 floats) run on the "tf32x3" route through its 4-byte copies
    and stores, into an ``out=`` view laid out the same way, and match the
    plain version; the values around the output view stay as they were."""
    g = torch.Generator(device=cuda).manual_seed(5)

    def view(heads, rows):
        flat = torch.randn(1 + 2 * heads * rows * 67, device=cuda, generator=g)
        return flat, flat[1:].view(2, heads, rows, 67)[..., :64]

    (_, q), (_, k), (_, v) = view(4, 130), view(2, 150), view(2, 150)
    buf, out = view(4, 130)
    kept = buf.clone()
    assert q.data_ptr() % 16 == 4 and q.stride() == (4 * 130 * 67, 130 * 67, 67, 1)
    kw = dict(causal=True, window=50, q_offset=20, valid_kv=140)
    before = ops.route_launch_counts()["flash_attention_bhsd"]
    got = tfa.flash_attention_bhsd(q, k, v, out=out, **kw)
    want = tfa.flash_attention_bhsd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got is out
    assert ops.route_launch_counts()["flash_attention_bhsd"] == {
        **before, "tf32x3": before["tf32x3"] + 1}
    assert (out - want).abs().max().item() < 2e-3 * min(1.0, want.abs().max().item())
    inside = torch.zeros_like(buf, dtype=torch.bool)
    inside[1:].view(2, 4, 130, 67)[..., :64] = True
    assert torch.equal(buf[~inside], kept[~inside])


@pytest.mark.parametrize("Sq, causal", [(1500, False), (1024, False), (1024, True)])
def test_flash_attention_at_the_whisper_shapes(cuda, Sq, causal):
    """whisper-tiny's serving shapes: the encoder (1500 x 1500, no mask),
    the cross-attention prefill (1024 queries over 1500 encoder keys, no
    mask; 1500 = 23 x 64 + 28 keys, ragged) and the decoder's causal 1024;
    4 requests, 6 heads of 64, through the (B, S, H, dh) views that
    ``ops.flash_attention`` passes."""
    g = torch.Generator(device=cuda).manual_seed(1)
    Skv = 1500 if Sq == 1500 or not causal else Sq
    q = torch.randn(4, Sq, 6, 64, device=cuda, generator=g).bfloat16()
    k = torch.randn(4, Skv, 6, 64, device=cuda, generator=g).bfloat16()
    v = torch.randn(4, Skv, 6, 64, device=cuda, generator=g).bfloat16()
    before = tfa.flash_attention_bhsd.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    want = tfa.flash_attention_bhsd_plain(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2), causal=causal).transpose(1, 2)
    torch.cuda.synchronize()
    assert tfa.flash_attention_bhsd.launches == before + 1
    # each output is a mean over ~Skv / e keys, about 0.04 across: the
    # bound is 3e-2 of the output's largest magnitude
    tol = 3e-2 * min(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() < tol
    if not causal:      # the bound sees a kernel that drops the 28-key tail
        lost = ops.flash_attention(q, k[:, :1472], v[:, :1472], causal=False)
        assert (lost.float() - want.float()).abs().max().item() > tol


def test_flash_attention_strided_views(cuda):
    """(B, S, H, dh) tensors through head-major views, as ops passes them."""
    q = torch.randn(2, 200, 8, 64, device=cuda)
    k = torch.randn(2, 200, 2, 64, device=cuda)
    got = ops.flash_attention(q, k, k, causal=True)
    want = tfa.flash_attention_bhsd_plain(q.transpose(1, 2), k.transpose(1, 2),
                                          k.transpose(1, 2)).transpose(1, 2)
    assert (got - want).abs().max().item() < 2e-3


def test_flash_attention_refuses_head_size(cuda):
    q = torch.randn(1, 2, 8, 48, device=cuda)
    with pytest.raises(ValueError):
        tfa.flash_attention_bhsd(q, q, q)


def test_flash_attention_bf16_strided_views(cuda):
    """bf16 (B, S, H, dh) tensors through ops' head-major views, on the
    tensor cores."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(2, 200, 16, 128, device=cuda, generator=g).bfloat16()
    k = torch.randn(2, 200, 2, 128, device=cuda, generator=g).bfloat16()
    v = torch.randn(2, 200, 2, 128, device=cuda, generator=g).bfloat16()
    got = ops.flash_attention(q, k, v, causal=True, window=120, q_offset=0)
    want = tfa.flash_attention_bhsd_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        window=120).transpose(1, 2)
    assert got.dtype == torch.bfloat16
    assert (got.float() - want.float()).abs().max().item() < 3e-2


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("dh", [16, 80, 128])
def test_flash_attention_no_valid_key_is_zero(cuda, dh, dt):
    q = torch.randn(2, 4, 130, dh, device=cuda).to(TDT[dt])
    k = torch.randn(2, 2, 70, dh, device=cuda).to(TDT[dt])
    out = tfa.flash_attention_bhsd(q, k, k, causal=True, valid_kv=0)
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("what", ["base", "row stride"])
def test_flash_attention_refuses_misaligned_bf16(cuda, what):
    """The tensor-core kernel copies 16 bytes at a time: a bf16 view whose
    base or row stride is not 16-byte aligned is refused, never rerouted."""
    if what == "base":
        flat = torch.randn(2 * 64 * 64 + 1, device=cuda).bfloat16()
        q = flat[1:].view(1, 2, 64, 64)
    else:
        q = torch.randn(1, 2, 64, 68, device=cuda).bfloat16()[..., :64]
    before = ops.launch_counts()["flash_attention_bhsd"], ops.route_launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        tfa.flash_attention_bhsd(q, q, q)
    assert (ops.launch_counts()["flash_attention_bhsd"], ops.route_launch_counts()) == before


WGMMA_CASES = [
    # (B, Sq, Skv, H, K, dh, causal, window, q_offset, valid_kv): bf16 at
    # dh 64 and 128, Sq and Skv off the 128-row and 128-key tiles, causal,
    # windows of 64 and 1024 and no mask, H / K of 1, 5 and 8
    (2, 130, 130, 5, 1, 64, True, 64, 0, None),
    (2, 200, 200, 8, 1, 128, True, None, 0, None),
    (1, 130, 200, 4, 4, 128, False, None, 0, None),
    (2, 1500, 1500, 2, 2, 64, False, None, 0, None),
    (1, 1500, 1500, 5, 1, 128, True, 1024, 0, None),
    (2, 200, 1500, 8, 1, 64, False, None, 0, None),
    (1, 1500, 1500, 8, 1, 64, True, 1024, 0, None),
    # q_offset and valid_kv, and valid_kv = 0
    (1, 128, 512, 8, 1, 64, True, None, 300, 420),
    (2, 200, 130, 8, 1, 128, True, 64, 70, 130),
    (2, 130, 200, 5, 1, 128, False, None, 0, 70),
    (2, 130, 200, 5, 1, 64, True, None, 0, 0),
]


@pytest.mark.parametrize("case", WGMMA_CASES)
def test_flash_attention_wgmma_route_vs_plain(cuda, case):
    """bf16 at dh 64 and 128 runs flash_attention_wgmma_kernel (counted on
    the "wgmma" route), read through the model's strided (B, S, H, dh)
    views and written into a strided ``out=`` inside a larger buffer,
    whose other values it leaves alone (TMA clips its stores to the
    view); within 3e-2 of the plain output's largest magnitude, at most
    3e-2, and zeros where no key is valid."""
    B, Sq, Skv, H, K, dh, causal, window, off, valid = case
    g = torch.Generator(device=cuda).manual_seed(Sq + Skv + dh)
    q = torch.randn(B, Sq, H, dh, device=cuda, generator=g).bfloat16().transpose(1, 2)
    k = torch.randn(B, Skv, K, dh, device=cuda, generator=g).bfloat16().transpose(1, 2)
    v = torch.randn(B, Skv, K, dh, device=cuda, generator=g).bfloat16().transpose(1, 2)
    buf = torch.full((B, Sq, H + 2, dh + 64), 7.0, device=cuda, dtype=torch.bfloat16)
    out = buf[:, :, 1:H + 1, 32:dh + 32].transpose(1, 2)
    kw = dict(causal=causal, window=window, q_offset=off, valid_kv=valid)
    before = ops.route_launch_counts()["flash_attention_bhsd"]
    got = tfa.flash_attention_bhsd(q, k, v, out=out, **kw)
    want = tfa.flash_attention_bhsd_plain(q, k, v, **kw).float()
    torch.cuda.synchronize()
    assert got is out
    assert ops.route_launch_counts()["flash_attention_bhsd"] == {
        **before, "wgmma": before["wgmma"] + 1}
    if valid == 0:
        assert torch.equal(out, torch.zeros_like(out))
    tol = 3e-2 * min(1.0, want.abs().max().item()) if valid != 0 else 0.0
    assert (out.float() - want).abs().max().item() <= tol
    outside = torch.ones_like(buf, dtype=torch.bool)
    outside[:, :, 1:H + 1, 32:dh + 32] = False
    assert bool((buf[outside] == 7.0).all())


@pytest.mark.parametrize("kernel", ["ssd_chunk", "flash_attention_bhsd"])
@pytest.mark.parametrize("which", [0, 1])
def test_forward_only_kernels_refuse_autograd(cuda, kernel, which):
    """Neither kernel has a backward, and each returns tensors with no
    ``grad_fn``: under autograd, with an input that requires grad, the
    wrapper raises before launching; under ``no_grad`` it launches."""
    g = torch.Generator(device=cuda).manual_seed(0)
    if kernel == "ssd_chunk":
        args = [torch.randn(1, 64, 2, 16, device=cuda, generator=g),
                torch.rand(1, 64, 2, device=cuda, generator=g) * 0.1,
                -torch.rand(2, device=cuda, generator=g),
                torch.randn(1, 64, 1, 16, device=cuda, generator=g),
                torch.randn(1, 64, 1, 16, device=cuda, generator=g)]
        call = lambda *a: tssd.ssd_chunk_call(*a, 32)                       # noqa: E731
    else:
        args = [torch.randn(1, 2, 64, 64, device=cuda, generator=g).bfloat16() for _ in range(3)]
        call = tfa.flash_attention_bhsd
    args[which * (len(args) - 1)].requires_grad_(True)
    before = ops.launch_counts()[kernel]
    with pytest.raises(_build.NoBackwardError, match="no backward"):
        call(*args)
    assert ops.launch_counts()[kernel] == before
    with torch.no_grad():
        call(*args)


def _map_tree(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, list):
        return [_map_tree(t, fn) for t in tree]
    return {k: _map_tree(v, fn) for k, v in tree.items()}


@pytest.mark.parametrize("mode", ["hier_overlap", "fsdp"])
def test_smoke_training_on_card_matches_cpu(cuda, mode):
    """Three steps on the card and on the CPU: losses within 1e-4, the
    codec once per bucket or leaf.  Then the sync itself on one batch's
    card gradients, on the card and (copied) on the CPU: bit-equal; and
    hier_overlap's hook executor against its sync after the backward,
    bit-equal.  (Parameters through int8 AdamW are not compared: one
    rounding apart moves a value by up to lr.)"""
    import torch.distributed as dist

    from repro_torch.core import overlap
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.launch import train as train_launch
    from repro_torch.launch.mesh import runtime_for_groups
    from repro_torch.train import loss as loss_lib
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step
    from repro_torch.train.train_step import TrainConfig, make_train_step

    started = train_launch.init_world(cuda)
    try:
        rt = runtime_for_groups(pods=1, data_per_pod=1, fsdp=mode == "fsdp")
        cfg = get_config("qwen2.5-3b", smoke=True)
        cfg = type(cfg)(**{**cfg.__dict__, "dtype": torch.float32})
        cpu = Model(cfg, rt, device="cpu").init(0)
        gpu = copy.deepcopy(cpu, {id(rt): rt}).to(cuda)
        tcfg = TrainConfig(comm_mode=mode, dcn_compression="int8",
                           opt=opt_lib.OptConfig(lr=1e-3, warmup_steps=1))
        n = (len(overlap.partition_tree(cpu.param_tree())) if mode == "hier_overlap"
             else len(cpu.train_leaves()))
        dcfg = DataConfig(vocab_size=cfg.vocab_size, global_batch=2, seq_len=64)
        losses = []
        for model in (cpu, gpu):
            step_fn, _ = make_train_step(model, tcfg)
            opt = opt_lib.adam_init(opt_lib.flat_params(model.train_leaves())[0])
            run = []
            for i in range(3):
                b = {k: torch.from_numpy(v).long().to(model.device)
                     for k, v in synth_batch(dcfg, i).items()}
                before = ops.launch_counts()
                m = step_fn(opt, b)
                after = ops.launch_counts()
                if model is gpu:
                    assert all(after[k] - before[k] == n
                               for k in ("amax_block", "quant_scaled", "dequant_int8"))
                assert not m["gated"]
                run.append(m["loss"])
            losses.append(run)
        assert max(abs(a - b) / abs(b) for a, b in zip(losses[1], losses[0])) < 1e-4

        ccfg = tcfg.comm_config(rt)
        leaves = gpu.train_leaves()
        params, _ = opt_lib.flat_params(leaves)
        b = {k: torch.from_numpy(v).long().to(cuda) for k, v in synth_batch(dcfg, 7).items()}

        def loss():
            with torch.enable_grad():
                return loss_lib.sharded_xent(gpu.apply_train(b["tokens"])[0], b["labels"],
                                             rt, cfg.vocab_size)[0]

        raw = torch.autograd.grad(loss(), params)
        card, host = [g.clone() for g in raw], [g.cpu() for g in raw]
        if mode == "hier_overlap":
            tree = gpu.param_tree()
            for grads in (card, host):
                by_id = dict(zip(map(id, params), grads))
                overlap.tree_hier_psum_overlap(_map_tree(tree, lambda t: by_id[id(t)]), ccfg)
            sync = overlap.BucketSync(tree, ccfg)
            lval = loss()
            with sync.attached(lval):
                inside = torch.autograd.grad(lval, params)
            assert all(torch.equal(a, c) for a, c in zip(inside, card))
            synced = (card, host)
        else:
            synced = []
            for grads in (card, host):
                it = iter(grads)
                synced.append([train_step.fsdp_sync([next(it) for _ in leaf]
                                                    if isinstance(leaf, list) else next(it),
                                                    False, ccfg, rt) for leaf in leaves])
        assert all(torch.equal(a.cpu(), c) for a, c in zip(*synced))
    finally:
        if started:
            dist.destroy_process_group()


def test_smoke_model_on_card_matches_cpu(cuda):
    cfg = get_config("qwen2.5-3b", smoke=True)
    cfg = type(cfg)(**{**cfg.__dict__, "dtype": torch.float32})
    cpu = Model(cfg, device="cpu").init(0)
    gpu = copy.deepcopy(cpu).to(cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 130))
    before = ops.launch_counts()["flash_attention_bhsd"]
    lc, cc = cpu.apply_prefill(toks)
    lg, cg = gpu.apply_prefill(toks.to(cuda))
    assert ops.launch_counts()["flash_attention_bhsd"] == before + cfg.n_layers
    assert (lg.cpu() - lc).abs().max().item() < 1e-3
    assert torch.equal(lg.argmax(-1).cpu(), lc.argmax(-1))


def test_smoke_encdec_model_on_card_matches_cpu(cuda):
    """The f32 smoke whisper with 130 frames: the encoder's self-attention,
    the decoder's and its cross-attention each launch flash once per layer
    in the prefill; logits within 1e-3 of the CPU's, tokens equal."""
    cfg = get_config("whisper-tiny", smoke=True)
    cfg = type(cfg)(**{**cfg.__dict__, "dtype": torch.float32})
    cpu = Model(cfg, device="cpu").init(0)
    gpu = copy.deepcopy(cpu).to(cuda)
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 130), generator=gen)
    frames = torch.randn(2, 130, cfg.d_model, generator=gen)
    before = ops.launch_counts()["flash_attention_bhsd"]
    lc, _ = cpu.apply_prefill(toks, frames)
    lg, _ = gpu.apply_prefill(toks.to(cuda), frames.to(cuda))
    assert (ops.launch_counts()["flash_attention_bhsd"]
            == before + cfg.n_enc_layers + 2 * cfg.n_layers)
    assert (lg.cpu() - lc).abs().max().item() < 1e-3
    assert torch.equal(lg.argmax(-1).cpu(), lc.argmax(-1))


SSD_CASES = [
    # (b, s, h, p, g, n, chunk, dtype): tests/test_kernels.py:46-52, then
    # p = 100, n = 16 (shape only) and the mamba2-2.7b prefill's shape
    (2, 256, 4, 32, 1, 64, 64, "f32"),
    (1, 128, 2, 64, 2, 32, 32, "f32"),
    (1, 128, 8, 32, 2, 32, 32, "f32"),       # h / (H/G) differs from h % G
    (1, 256, 8, 64, 1, 128, 128, "f32"),
    (2, 128, 4, 32, 1, 64, 64, "bf16"),
    (2, 256, 4, 100, 1, 16, 128, "bf16"),
    (4, 1024, 80, 64, 1, 128, 128, "bf16"),
    # the tensor-core kernels' grid: 6 heads over 2 groups (runs of heads
    # that do not divide a group), G = 2 with H = 8, q = 96
    (1, 256, 6, 64, 2, 64, 64, "bf16"),
    (1, 128, 8, 32, 2, 32, 32, "bf16"),
    (1, 192, 4, 64, 1, 64, 96, "bf16"),
    # the same grid in f32 (3xTF32), p = 100 with n = 16 and the
    # mamba2-2.7b prefill's shape; then p and n 4 past a multiple of 8 (x's
    # garbage columns, C B^T's zero-filled k), and p 120 and 128 at q = n =
    # 128, where one x buffer is all that fits
    (1, 256, 6, 64, 2, 64, 64, "f32"),
    (1, 192, 4, 64, 1, 64, 96, "f32"),
    (2, 256, 4, 100, 1, 16, 128, "f32"),
    (4, 1024, 80, 64, 1, 128, 128, "f32"),
    (1, 128, 2, 36, 1, 20, 32, "f32"),
    (1, 256, 4, 120, 1, 128, 128, "f32"),
    (1, 256, 2, 128, 1, 128, 128, "f32"),
]


def _ssd_inputs(case, dev):
    b, s, h, p, g, n, chunk, dt = case
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(b, s, h, p, device=dev, generator=gen).to(TDT[dt])
    dtv = torch.rand(b, s, h, device=dev, generator=gen) * 0.19 + 0.01
    A = -(torch.rand(h, device=dev, generator=gen) * 3.5 + 0.5)
    Bm = torch.randn(b, s, g, n, device=dev, generator=gen).to(TDT[dt])
    Cm = torch.randn(b, s, g, n, device=dev, generator=gen).to(TDT[dt])
    return x, dtv, A, Bm, Cm, chunk


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_chunk_vs_plain(cuda, case):
    before = tssd.ssd_chunk_call.launches
    args = _ssd_inputs(case, cuda)
    got = tssd.ssd_chunk_call(*args)
    want = tssd.ssd_chunk_plain(*args)
    torch.cuda.synchronize()
    assert tssd.ssd_chunk_call.launches == before + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item()


@pytest.mark.parametrize("heads_per_block", [1, 2, 3, 5, 32])
def test_ssd_chunk_bf16_heads_per_block(cuda, heads_per_block):
    """Every split of a group's heads over blocks gives the same function:
    runs of 1 to all 8 heads, uneven ones (3 -> 2 + 3 + 3, 5 -> 4 + 4)."""
    args = _ssd_inputs((2, 256, 8, 64, 1, 128, 128, "bf16"), cuda)
    got = tssd.ssd_chunk_call(*args, heads_per_block=heads_per_block)
    want = tssd.ssd_chunk_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item()


CONV_SLICE_SHAPES = [(2, 256, 4, 100, 1, 16, 128), (2, 256, 8, 64, 1, 128, 128),
                     (1, 128, 8, 32, 2, 32, 64)]


def _conv_slices(shape, dtype, dev):
    """x, dt, A, B, C with x, B and C column slices of one conv output in
    ``dtype``, as the model hands them over."""
    b, s, h, p, g, n, _ = shape
    gen = torch.Generator(device=dev).manual_seed(1)
    conv = torch.randn(b, s, h * p + 2 * g * n, device=dev, generator=gen).to(dtype)
    x = conv[..., :h * p].unflatten(-1, (h, p))
    Bm = conv[..., h * p:h * p + g * n].unflatten(-1, (g, n))
    Cm = conv[..., h * p + g * n:].unflatten(-1, (g, n))
    dt = torch.rand(b, s, h, device=dev, generator=gen) * 0.19 + 0.01
    A = -(torch.rand(h, device=dev, generator=gen) * 3.5 + 0.5)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("shape", CONV_SLICE_SHAPES)
def test_ssd_chunk_conv_slices(cuda, shape, dt):
    """x, B and C as column slices of one conv output, as the model hands
    them over: at p = 100 bf16 rows are only 8 bytes aligned, f32 rows 16
    bytes aligned but 100 floats apart."""
    args = _conv_slices(shape, TDT[dt], cuda)
    got = tssd.ssd_chunk_call(*args, shape[-1])
    want = tssd.ssd_chunk_plain(*args, shape[-1])
    torch.cuda.synchronize()
    for g_, w in zip(got, want):
        assert (g_ - w).abs().max().item() <= 1e-4 * w.abs().max().item()


# 4 x 8 blocks of 8 heads, which the launcher splits into runs of 2 heads
# (4 runs a group fill one wave of 132 SMs): head 0's block prefetches
# head 1's x while head 0 computes
NAN_NEIGHBOUR_SHAPES = [(4, 1024, 8, 100, 1, 16, 128), (4, 1024, 8, 64, 1, 128, 128),
                        (4, 512, 8, 36, 1, 20, 64)]


@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("shape", NAN_NEIGHBOUR_SHAPES)
def test_ssd_chunk_nan_beside_its_operands_stays_out(cuda, shape, dt):
    """NaN next to every region the kernels stage or read reaches no other
    output than the plain version's NaN: x, B and C are column slices of
    one conv output with NaN in the 4 columns after each; head 1's x is
    NaN throughout (the buffer next to head 0's, filled while head 0
    computes); row 5 of C is NaN in the first chunk (a row of C B^T, whose
    tiles follow B in shared memory).  The kernels' passes read past a
    staged row into the next region and throw those columns away, so the
    outputs are NaN exactly where the plain version's are (head 1; y_diag's
    row 5 of that chunk) and within 1e-4 of it elsewhere."""
    b, s, h, p, g, n, chunk = shape
    gen = torch.Generator(device=cuda).manual_seed(3)
    hp, gn = h * p, g * n
    conv = torch.randn(b, s, hp + 2 * gn + 12, device=cuda, generator=gen)
    for c0 in (hp, hp + gn + 4, hp + 2 * gn + 8):
        conv[..., c0:c0 + 4] = torch.nan
    conv[..., p:2 * p] = torch.nan                              # head 1's x
    conv[0, 5, hp + gn + 8:hp + 2 * gn + 8] = torch.nan         # C's row 5, batch 0
    conv = conv.to(TDT[dt])
    x = conv[..., :hp].unflatten(-1, (h, p))
    Bm = conv[..., hp + 4:hp + 4 + gn].unflatten(-1, (g, n))
    Cm = conv[..., hp + gn + 8:hp + 2 * gn + 8].unflatten(-1, (g, n))
    dtv = torch.rand(b, s, h, device=cuda, generator=gen) * 0.19 + 0.01
    A = -(torch.rand(h, device=cuda, generator=gen) * 3.5 + 0.5)
    got = tssd.ssd_chunk_call(x, dtv, A, Bm, Cm, chunk)
    want = tssd.ssd_chunk_plain(x, dtv, A, Bm, Cm, chunk)
    torch.cuda.synchronize()
    y_nan = torch.zeros(b, s // chunk, chunk, h, p, dtype=torch.bool, device=cuda)
    y_nan[:, :, :, 1] = True
    y_nan[0, 0, 5] = True
    st_nan = torch.zeros(b, s // chunk, h, p, n, dtype=torch.bool, device=cuda)
    st_nan[:, :, 1] = True
    for what, g_, w, nan in zip(("y_diag", "states"), got, want, (y_nan, st_nan)):
        assert torch.equal(w.isnan(), nan), f"plain {what}"
        assert torch.equal(g_.isnan(), nan), (
            f"{what}: {(g_.isnan() & ~nan).sum().item()} NaN outside the plain version's")
        err = (g_[~nan] - w[~nan]).abs().max().item()
        assert err <= 1e-4 * w[~nan].abs().max().item(), f"{what}: {err}"


def test_ssd_chunk_f32_at_the_mamba2_shape_is_3xtf32_accurate(cuda, full_f32_matmul):
    """f32 at the mamba2-2.7b prefill shape (4 x 1024, 80 heads of p 64,
    n 128, q 128) through the 3xTF32 kernel: y_diag and the states within
    1e-5 of the plain f32 version's largest magnitude (its products in
    full f32), ten times inside the 1e-4 the kernel is held to elsewhere;
    one TF32 product would miss 1e-4 (tests/test_torch_ssm.py)."""
    before = tssd.ssd_chunk_call.launches
    args = _ssd_inputs((4, 1024, 80, 64, 1, 128, 128, "f32"), cuda)
    got = tssd.ssd_chunk_call(*args)
    want = tssd.ssd_chunk_plain(*args)
    torch.cuda.synchronize()
    assert tssd.ssd_chunk_call.launches == before + 1
    for what, g_, w in zip(("y_diag", "states"), got, want):
        err = ((g_ - w).abs().max() / w.abs().max()).item()
        assert err <= 1e-5, f"{what}: {err:.3g} of the largest magnitude"


def test_ssd_chunk_refuses_heads_per_block(cuda):
    args = _ssd_inputs((1, 128, 4, 32, 1, 32, 64, "bf16"), cuda)
    with pytest.raises(ValueError):
        tssd.ssd_chunk_call(*args, heads_per_block=33)      # more than 32
    args = _ssd_inputs((1, 128, 4, 32, 1, 32, 64, "f32"), cuda)
    with pytest.raises(ValueError):
        tssd.ssd_chunk_call(*args, heads_per_block=2)       # f32: the launcher picks


def test_ssd_chunked_strided_views(cuda):
    """x, B and C as column slices of one conv output, as the model hands
    them over: the same bits as contiguous copies."""
    b, s, h, p, n = 2, 256, 8, 64, 32
    conv = torch.randn(b, s, h * p + 2 * n, device=cuda).to(torch.bfloat16)
    x = conv[..., :h * p].reshape(b, s, h, p)
    Bm = conv[..., h * p:h * p + n].reshape(b, s, 1, n)
    Cm = conv[..., h * p + n:].reshape(b, s, 1, n)
    dt = torch.rand(b, s, h, device=cuda) * 0.1 + 0.01
    A = -torch.linspace(1.0, 16.0, h, device=cuda)
    got = ops.ssd_chunked(x, dt, A, Bm, Cm)
    want = ops.ssd_chunked(x.contiguous(), dt, A, Bm.contiguous(), Cm.contiguous())
    assert all(torch.equal(a, w) for a, w in zip(got, want))


def test_ssd_chunk_refuses_shapes(cuda):
    args = list(_ssd_inputs((1, 96, 2, 32, 1, 16, 48, "f32"), cuda))
    with pytest.raises(ValueError):
        tssd.ssd_chunk_call(*args)                # chunk 48: not a multiple of 32
    args[-1] = 64
    with pytest.raises(ValueError):
        tssd.ssd_chunk_call(*args)                # 96 is not a multiple of 64
    args[-1] = 32
    conv = torch.randn(1, 96, 2 * 32 + 2 * 16 + 1, device=cuda)
    args[0] = conv[..., :64].reshape(1, 96, 2, 32)
    with pytest.raises(ValueError):
        tssd.ssd_chunk_call(*args)                # rows 97 elements apart


def test_mamba2_smoke_on_card_matches_cpu(cuda):
    cfg = get_config("mamba2-2.7b", smoke=True)
    cfg = type(cfg)(**{**cfg.__dict__, "dtype": torch.float32})
    cpu = Model(cfg, device="cpu").init(0)
    gpu = copy.deepcopy(cpu).to(cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 130))
    before = ops.launch_counts()["ssd_chunk"]
    lc, cc = cpu.apply_prefill(toks)
    lg, cg = gpu.apply_prefill(toks.to(cuda))
    assert ops.launch_counts()["ssd_chunk"] == before + cfg.n_layers
    assert (lg.cpu() - lc).abs().max().item() < 1e-3
    tok = lc.argmax(-1)
    assert torch.equal(lg.argmax(-1).cpu(), tok)
    for _ in range(4):
        lc, cc = cpu.apply_decode(tok, cc)
        lg, cg = gpu.apply_decode(tok.to(cuda), cg)
        assert (lg.cpu() - lc).abs().max().item() < 1e-3
        assert torch.equal(lg.argmax(-1).cpu(), lc.argmax(-1))
        tok = lc.argmax(-1)
    assert ops.launch_counts()["ssd_chunk"] == before + cfg.n_layers   # decode: none
    assert torch.equal(cg.length.cpu(), cc.length)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mixtral-8x7b"])
def test_moe_smoke_on_card_matches_cpu(cuda, arch):
    """The f32 MoE smoke models (mixtral's with its window of 32): prefill
    and four decode steps within 1e-3 of the CPU's logits, tokens equal,
    flash once per layer in the prefill and never in decode; then the
    MoE layer's training forward and backward within 1e-4."""
    cfg = get_config(arch, smoke=True)
    cfg = type(cfg)(**{**cfg.__dict__, "dtype": torch.float32})
    cpu = Model(cfg, device="cpu").init(0)
    gpu = copy.deepcopy(cpu).to(cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 130), generator=torch.Generator().manual_seed(0))
    before = ops.launch_counts()["flash_attention_bhsd"]
    lc, cc = cpu.apply_prefill(toks)
    lg, cg = gpu.apply_prefill(toks.to(cuda))
    assert ops.launch_counts()["flash_attention_bhsd"] == before + cfg.n_layers
    assert (lg.cpu() - lc).abs().max().item() < 1e-3
    tok = lc.argmax(-1)
    assert torch.equal(lg.argmax(-1).cpu(), tok)
    for _ in range(4):
        lc, cc = cpu.apply_decode(tok, cc)
        lg, cg = gpu.apply_decode(tok.to(cuda), cg)
        assert (lg.cpu() - lc).abs().max().item() < 1e-3
        assert torch.equal(lg.argmax(-1).cpu(), lc.argmax(-1))
        tok = lc.argmax(-1)
    assert ops.launch_counts()["flash_attention_bhsd"] == before + cfg.n_layers
    grads = []
    for model in (cpu, gpu):
        params = [p.requires_grad_(True) for p in model.layers[0]["moe"].values()]
        with torch.enable_grad():
            logits, aux = model.apply_train(toks[:, :64].to(model.device))
            grads.append([g.cpu() for g in torch.autograd.grad(
                logits.square().mean() + aux, params)])
    for g, c in zip(grads[1], grads[0]):
        assert (g - c).abs().max().item() <= 1e-4 * max(1.0, c.abs().max().item())


# ---------------------------------------------------------------------------
# The shape-only branches (the dry run's trace of the card's path)
# ---------------------------------------------------------------------------

def _shape_only_cases(dev):
    """name -> (wrapper, a function of the inputs, the inputs on ``dev``)
    at shapes the main path gives each kernel."""
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, dt=torch.bfloat16):
        return torch.randn(*shape, device=dev, generator=g).to(dt)

    x = rnd(5 * 1024 + 7)
    q, s = tquant.quant_int8_call(x)
    pieces = [(0, rnd(3, 1000)), (4096, rnd(2000, dt=torch.float32))]
    return {
        "quant_int8": (tquant.quant_int8_call, lambda a: tquant.quant_int8_call(a["x"]),
                       {"x": x}),
        "dequant_int8": (tquant.dequant_int8_call,
                         lambda a: tquant.dequant_int8_call(a["q"], a["s"], x.numel(),
                                                            torch.bfloat16),
                         {"q": q, "s": s}),
        "amax_block": (tquant.amax_block_call, lambda a: tquant.amax_block_call(a["x"]),
                       {"x": x}),
        "quant_scaled": (tquant.quant_scaled_call,
                         lambda a: tquant.quant_scaled_call(a["x"], a["s"]), {"x": x, "s": s}),
        "pack_slots": (tquant.pack_slots_call,
                       lambda a: tquant.pack_slots_call([(0, a["p0"]), (4096, a["p1"])], 8192,
                                                        torch.bfloat16),
                       {"p0": pieces[0][1], "p1": pieces[1][1]}),
        "fused_pack_quant": (tquant.fused_pack_quant_call,
                             lambda a: tquant.fused_pack_quant_call(
                                 [(0, a["p0"]), (4096, a["p1"])], 8192),
                             {"p0": pieces[0][1], "p1": pieces[1][1]}),
        "flash_attention": (tfa.flash_attention_bhsd,
                            lambda a: ops.flash_attention(a["q"], a["k"], a["v"]),
                            {"q": rnd(2, 256, 16, 128), "k": rnd(2, 256, 2, 128),
                             "v": rnd(2, 256, 2, 128)}),
        "ssd_chunk": (tssd.ssd_chunk_call,
                      lambda a: tssd.ssd_chunk_call(a["x"], a["dt"], a["A"], a["B"], a["C"], 128),
                      {"x": rnd(1, 512, 8, 64), "dt": rnd(1, 512, 8, dt=torch.float32).abs(),
                       "A": -rnd(8, dt=torch.float32).abs(), "B": rnd(1, 512, 1, 128),
                       "C": rnd(1, 512, 1, 128)}),
    }


@pytest.mark.parametrize("name", ["quant_int8", "dequant_int8", "amax_block", "quant_scaled",
                                  "pack_slots", "fused_pack_quant", "flash_attention",
                                  "ssd_chunk"])
def test_shape_only_branch_writes_the_launchs_layout(cuda, name):
    """The same call on the card's tensors and on their fakes: outputs of
    equal shapes, dtypes and strides; the real call counts a launch and
    no shape-only call, the fake one the other way round."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._pytree import tree_leaves

    wrapper, call, inputs = _shape_only_cases(cuda)[name]
    launches, fakes = wrapper.launches, wrapper.fake_launches
    with torch.no_grad():
        real = tree_leaves(call(inputs))
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.fake_launches) == (launches + 1, fakes)
    with FakeTensorMode() as mode, torch.no_grad():
        fake = tree_leaves(call({k: mode.from_tensor(v) for k, v in inputs.items()}))
    assert (wrapper.launches, wrapper.fake_launches) == (launches + 1, fakes + 1)
    assert [(tuple(t.shape), t.dtype, t.stride(), t.device) for t in fake] == [
        (tuple(t.shape), t.dtype, t.stride(), t.device) for t in real]


DRYRUN_COUNTS = """
import json
import torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_fake_world
one = {"pod": 1, "data": 1, "model": 1}
out = {}
for kind, mode in (("prefill", "hier"), ("decode", "hier"), ("train", "hier"),
                   ("train", "hier_overlap")):
    rt = make_fake_world(one)
    ops.reset_launch_counts()
    cell = dryrun.trace_cell(get_config("qwen2.5-3b"), ShapeConfig("c", kind, 1024, 4), rt, one,
                             comm_mode=mode, compression="int8", device="cuda")
    dist.destroy_process_group()
    out[f"{kind}/{mode}"] = [ops.fake_launch_counts(), ops.launch_counts(),
                             cell["memory"]["peak_bytes"]]
print(json.dumps(out))
"""


def test_dryrun_counts_the_cards_launches(cuda):
    """qwen2.5-3b's world of one traced with ``device="cuda"`` (a
    subprocess: the fake world is one per process): the shape-only calls
    equal the launches chip_smoke.py asserts on the card, and nothing
    launches."""
    import json
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", DRYRUN_COUNTS], capture_output=True, text=True,
                          timeout=900, env=dict(os.environ, PYTHONPATH=str(root / "src")))
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    codec = {"pack_slots": 1, "amax_block": 1, "quant_scaled": 1, "dequant_int8": 1}
    want = {"prefill/hier": {"flash_attention_bhsd": 36}, "decode/hier": {},
            "train/hier": codec, "train/hier_overlap": {k: 38 for k in codec}}
    for key, counts in want.items():
        fake, real, _ = got[key]
        assert fake == {k: counts.get(k, 0) for k in fake}, key
        assert set(real.values()) == {0}, key
