"""mixtral-8x7b [moe]: 8 experts top-2, GQA kv=8, SWA(4096).
[arXiv:2401.04088; hf]"""
from .base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", family="moe", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=32000,
        n_experts=8, top_k=2, moe_d_ff=14336, sliding_window=4096,
        rope_theta=1e6, max_seq=524_288)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
        n_experts=4, top_k=2, moe_d_ff=128, sliding_window=32,
        rope_theta=1e6)
