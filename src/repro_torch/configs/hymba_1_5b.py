"""hymba-1.5b [hybrid]: parallel attention + Mamba heads per layer,
sliding-window attention (global attn in the paper's 3 full layers is
simplified to SWA everywhere; backbone only, meta tokens omitted).
ssm_head_dim=100 keeps ssm heads (32) divisible by tp=16 — the paper's
per-attn-head SSM pairing does not constrain this.  [arXiv:2411.13676; hf]"""
from .base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", family="hybrid", n_layers=32, d_model=1600,
        n_heads=25, n_kv_heads=5, d_ff=5504, vocab_size=32001,
        parallel_ssm=True, ssm_state=16, ssm_head_dim=100, ssm_expand=2,
        sliding_window=1024, rope_theta=1e4, tie_embeddings=True,
        max_seq=524_288)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b-smoke", family="hybrid", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
        parallel_ssm=True, ssm_state=8, ssm_head_dim=16, ssm_expand=2,
        sliding_window=32, rope_theta=1e4, tie_embeddings=True)
