"""qwen2.5-3b [dense]: GQA (kv=2), QKV bias.  [hf:Qwen/Qwen2.5-3B; hf]"""
from .base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b", family="dense", n_layers=36, d_model=2048,
        n_heads=16, n_kv_heads=2, d_ff=11008, vocab_size=151936,
        qkv_bias=True, rope_theta=1e6, tie_embeddings=True)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=160, vocab_size=256,
        qkv_bias=True, rope_theta=1e6, tie_embeddings=True)
