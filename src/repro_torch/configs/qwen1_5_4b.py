"""qwen1.5-4b [dense]: MHA (kv=20), QKV bias.  [hf:Qwen/Qwen1.5-4B; hf]"""
from .base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b", family="dense", n_layers=40, d_model=2560,
        n_heads=20, n_kv_heads=20, d_ff=6912, vocab_size=151936,
        qkv_bias=True, rope_theta=1e6, tie_embeddings=True)


def smoke() -> ModelConfig:
    # 5 heads on 1 device exercises the padding path under tp>1 tests
    return ModelConfig(
        name="qwen1.5-4b-smoke", family="dense", n_layers=2, d_model=80,
        n_heads=5, n_kv_heads=5, d_ff=192, vocab_size=256,
        qkv_bias=True, rope_theta=1e6, tie_embeddings=True)
