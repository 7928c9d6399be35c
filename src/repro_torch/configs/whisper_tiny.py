"""whisper-tiny [audio]: enc-dec, conv frontend stubbed (input_specs
provides precomputed 1500-frame embeddings).  [arXiv:2212.04356; unverified]"""
from .base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny", family="encdec", n_layers=4, d_model=384,
        n_heads=6, n_kv_heads=6, d_ff=1536, vocab_size=51865,
        norm="ln", n_enc_layers=4, enc_seq=1500, frontend="audio_stub",
        tie_embeddings=True, max_seq=32_768)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny-smoke", family="encdec", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
        norm="ln", n_enc_layers=2, enc_seq=30, frontend="audio_stub",
        tie_embeddings=True, max_seq=512)
