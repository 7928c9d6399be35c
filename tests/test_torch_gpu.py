"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device.  The
file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The int8 codec is bit-equal; flash attention agrees within
tests/test_kernels.py's tolerances (f32 2e-3, bf16 3e-2).
"""

import copy

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels import quant as tquant
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


FLASH_CASES = [
    # (B, Sq, Skv, H, K, dh, causal, window, dtype, tol)
    (4, 1024, 1024, 16, 2, 128, True, None, "bf16", 3e-2),
    (2, 256, 256, 4, 2, 64, True, None, "f32", 2e-3),
    (1, 192, 192, 2, 1, 80, False, None, "f32", 2e-3),
    (2, 130, 130, 2, 2, 64, True, 64, "f32", 2e-3),
    (2, 130, 130, 4, 2, 16, True, None, "f32", 2e-3),
    (1, 128, 256, 4, 2, 32, True, 100, "bf16", 3e-2),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_vs_plain(cuda, case):
    B, Sq, Skv, H, K, dh, causal, window, dt, tol = case
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(B, H, Sq, dh, device=cuda, generator=g).to(TDT[dt])
    k = torch.randn(B, K, Skv, dh, device=cuda, generator=g).to(TDT[dt])
    v = torch.randn(B, K, Skv, dh, device=cuda, generator=g).to(TDT[dt])
    for kw in (dict(), dict(q_offset=Skv - Sq + 3, valid_kv=Skv - 5)):
        got = tfa.flash_attention_bhsd(q, k, v, causal=causal, window=window, **kw)
        want = tfa.flash_attention_bhsd_plain(q, k, v, causal=causal,
                                              window=window, **kw)
        torch.cuda.synchronize()
        assert (got.float() - want.float()).abs().max().item() < tol, kw


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
