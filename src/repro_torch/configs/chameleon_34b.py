"""chameleon-34b [vlm]: early-fusion VQ image tokens (ids in the shared
vocab, so the modality frontend is the token embedding itself — stub per
spec), QK-norm.  [arXiv:2405.09818; unverified]"""
from .base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b", family="vlm", n_layers=48, d_model=8192,
        n_heads=64, n_kv_heads=8, d_ff=22016, vocab_size=65536,
        qk_norm=True, rope_theta=1e4, frontend="vq_tokens")


def smoke() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b-smoke", family="vlm", n_layers=2, d_model=64,
        n_heads=8, n_kv_heads=2, d_ff=160, vocab_size=512,
        qk_norm=True, rope_theta=1e4, frontend="vq_tokens")
