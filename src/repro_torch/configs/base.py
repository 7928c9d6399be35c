"""Model + run configuration dataclasses.

One ``ModelConfig`` per assigned architecture lives in
``src/repro_torch/configs/<id>.py`` with the exact published dims; every arch
module also exposes ``smoke()`` — a reduced same-family config for CPU
tests.  ``ShapeConfig`` captures the assigned input-shape sets.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int                # 0 => attention-free (ssm)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0             # 0 => d_model // n_heads
    norm: str = "rmsnorm"       # rmsnorm | ln | ln_nonparam
    qkv_bias: bool = False
    qk_norm: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1e6
    sliding_window: int | None = None
    max_seq: int = 32768
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    router_aux_weight: float = 0.001
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    conv_width: int = 4
    # --- hybrid (Hymba): parallel attn + ssm heads per layer ---
    parallel_ssm: bool = False
    # --- encoder-decoder (Whisper) ---
    n_enc_layers: int = 0
    enc_seq: int = 0            # precomputed frame embeddings (stub frontend)
    frontend: str | None = None  # None | "audio_stub" | "vq_tokens"
    # --- numerics ---
    dtype: Any = torch.bfloat16

    # ------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // max(1, self.n_heads)

    def padded_heads(self, tp: int) -> int:
        """Q heads padded up to a multiple of tp for even sharding
        (zero-weight heads; waste is reported by the MODEL_FLOPS ratio
        in the roofline table)."""
        if self.n_heads == 0:
            return 0
        return math.ceil(self.n_heads / tp) * tp

    def padded_kv_heads(self, tp: int) -> int:
        """Global KV heads stored: padded to a multiple of tp when
        sharded (n_kv >= tp), or the true count when replicated
        (n_kv < tp; every device computes all KV heads and gathers the
        one(s) its local Q heads need)."""
        if self.n_kv_heads == 0:
            return 0
        if self.n_kv_heads >= tp:
            return math.ceil(self.n_kv_heads / tp) * tp
        return self.n_kv_heads

    def kv_replicated(self, tp: int) -> bool:
        return 0 < self.n_kv_heads < tp

    def local_q_heads(self, tp: int) -> int:
        return self.padded_heads(tp) // tp

    def local_kv_heads(self, tp: int) -> int:
        if self.n_kv_heads == 0:
            return 0
        if self.kv_replicated(tp):
            return self.n_kv_heads
        return self.padded_kv_heads(tp) // tp

    def padded_vocab(self, tp: int) -> int:
        return math.ceil(self.vocab_size / (tp * 128)) * tp * 128

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def ssm_heads(self, tp: int = 1) -> int:
        h = self.d_inner // self.ssm_head_dim
        assert h % tp == 0 or tp == 1, (h, tp)
        return h

    @property
    def is_subquadratic(self) -> bool:
        return (self.family in ("ssm", "hybrid")
                or self.sliding_window is not None)

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have a decoder stack

    def param_count(self) -> int:
        """Analytic parameter count (unpadded), for 6·N·D."""
        D, V, L = self.d_model, self.vocab_size, self.n_layers
        dh = self.head_dim
        n = V * D  # embed
        if not self.tie_embeddings:
            n += V * D
        def attn_params():
            qkv = D * (self.n_heads * dh) + 2 * D * (self.n_kv_heads * dh)
            return qkv + (self.n_heads * dh) * D

        def mlp_params(dff):
            return 3 * D * dff

        def ssm_params():
            di, ns, g = self.d_inner, self.ssm_state, self.ssm_groups
            h = di // self.ssm_head_dim
            in_p = D * (2 * di + 2 * g * ns + h)
            conv = (di + 2 * g * ns) * self.conv_width
            return in_p + conv + di * D + 2 * h

        per_layer = 0
        if self.family == "ssm":
            per_layer = ssm_params()
        elif self.family == "moe":
            per_layer = attn_params() + self.n_experts * mlp_params(self.moe_d_ff) \
                + D * self.n_experts
        elif self.family == "hybrid":
            per_layer = attn_params() + ssm_params() + mlp_params(self.d_ff)
        else:
            per_layer = attn_params() + mlp_params(self.d_ff)
        n += L * per_layer
        if self.n_enc_layers:
            n += self.n_enc_layers * (attn_params() + mlp_params(self.d_ff))
            n += L * attn_params()  # decoder cross-attention
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k experts only)."""
        if self.family != "moe":
            return self.param_count()
        D, L = self.d_model, self.n_layers
        full = self.param_count()
        moe_all = L * self.n_experts * 3 * D * self.moe_d_ff
        moe_act = L * self.top_k * 3 * D * self.moe_d_ff
        return full - moe_all + moe_act


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str           # train_4k | prefill_32k | decode_32k | long_500k
    kind: str           # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}
