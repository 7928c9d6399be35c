"""mamba2-2.7b [ssm]: attention-free SSD (state-space duality).
d_inner=5120, 80 heads of dim 64, state 128.  [arXiv:2405.21060; unverified]"""
from .base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b", family="ssm", n_layers=64, d_model=2560,
        n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, conv_width=4,
        tie_embeddings=True, max_seq=524_288)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b-smoke", family="ssm", n_layers=2, d_model=64,
        n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=256,
        ssm_state=16, ssm_head_dim=16, ssm_expand=2, conv_width=4,
        tie_embeddings=True)
