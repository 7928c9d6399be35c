"""olmo-1b [dense]: MHA, non-parametric LayerNorm.  [arXiv:2402.00838; hf]"""
from .base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b", family="dense", n_layers=16, d_model=2048,
        n_heads=16, n_kv_heads=16, d_ff=8192, vocab_size=50304,
        norm="ln_nonparam", rope_theta=1e4, tie_embeddings=True)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
        norm="ln_nonparam", rope_theta=1e4, tie_embeddings=True)
