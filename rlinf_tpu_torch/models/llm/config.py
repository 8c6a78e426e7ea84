"""LLM architecture config (Qwen2/Llama-family decoder).

The port's own copy of ``rlinf_tpu/models/llm/config.py``: same fields and
presets, with ``compute_dtype`` as a ``torch.dtype``. MoE fields are kept so
that one config describes both packages; the port's model raises on MoE.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class LLMConfig:
    vocab_size: int = 151936
    hidden_size: int = 896
    intermediate_size: int = 4864
    num_layers: int = 24
    num_heads: int = 14
    num_kv_heads: int = 2
    head_dim: Optional[int] = None  # defaults to hidden_size // num_heads
    rope_theta: float = 1e6
    rms_eps: float = 1e-6
    max_seq_len: int = 4096
    tie_word_embeddings: bool = True
    qkv_bias: bool = True  # Qwen2 uses qkv biases
    qk_norm: bool = False  # Qwen3: per-head RMSNorm on q/k before RoPE
    dtype: str = "bfloat16"  # activation/weight compute dtype
    num_experts: int = 0
    num_experts_per_token: int = 2
    moe_capacity_factor: float = 1.5
    moe_aux_loss_coef: float = 0.01
    moe_impl: str = "capacity"

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim_

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim_

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def num_params(self) -> int:
        """Analytic parameter count (embedding counted once if tied)."""
        d, f, l, v = self.hidden_size, self.intermediate_size, self.num_layers, self.vocab_size
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.qkv_bias:
            attn += self.q_dim + 2 * self.kv_dim
        if self.is_moe:
            mlp = d * self.num_experts + self.num_experts * 3 * d * f
        else:
            mlp = 3 * d * f
        norms = 2 * d
        per_layer = attn + mlp + norms
        emb = v * d if self.tie_word_embeddings else 2 * v * d
        return l * per_layer + emb + d

    @staticmethod
    def qwen2_0_5b() -> "LLMConfig":
        """Qwen2.5-0.5B geometry."""
        return LLMConfig(
            vocab_size=151936, hidden_size=896, intermediate_size=4864,
            num_layers=24, num_heads=14, num_kv_heads=2,
            rope_theta=1e6, tie_word_embeddings=True,
        )

    @staticmethod
    def qwen2_1_5b() -> "LLMConfig":
        return LLMConfig(
            vocab_size=151936, hidden_size=1536, intermediate_size=8960,
            num_layers=28, num_heads=12, num_kv_heads=2,
            rope_theta=1e6, tie_word_embeddings=True,
        )

    @staticmethod
    def qwen2_7b() -> "LLMConfig":
        return LLMConfig(
            vocab_size=152064, hidden_size=3584, intermediate_size=18944,
            num_layers=28, num_heads=28, num_kv_heads=4,
            rope_theta=1e6, tie_word_embeddings=False,
        )

    @staticmethod
    def qwen3_0_6b() -> "LLMConfig":
        """Qwen3-0.6B geometry (qk-norm, no qkv bias, head_dim 128)."""
        return LLMConfig(
            vocab_size=151936, hidden_size=1024, intermediate_size=3072,
            num_layers=28, num_heads=16, num_kv_heads=8, head_dim=128,
            rope_theta=1e6, tie_word_embeddings=True,
            qkv_bias=False, qk_norm=True,
        )

    @staticmethod
    def qwen3_1_7b() -> "LLMConfig":
        return LLMConfig(
            vocab_size=151936, hidden_size=2048, intermediate_size=6144,
            num_layers=28, num_heads=16, num_kv_heads=8, head_dim=128,
            rope_theta=1e6, tie_word_embeddings=True,
            qkv_bias=False, qk_norm=True,
        )

    @staticmethod
    def qwen3_moe_30b_a3b() -> "LLMConfig":
        """Qwen3-30B-A3B geometry (128 experts, top-8, expert ffn 768)."""
        return LLMConfig(
            vocab_size=151936, hidden_size=2048, intermediate_size=768,
            num_layers=48, num_heads=32, num_kv_heads=4, head_dim=128,
            rope_theta=1e6, tie_word_embeddings=False,
            qkv_bias=False, qk_norm=True,
            num_experts=128, num_experts_per_token=8,
        )

    @staticmethod
    def qwen3_moe_2b() -> "LLMConfig":
        """Small MoE geometry: 32 experts x ffn 768, top-2 routing."""
        return LLMConfig(
            vocab_size=151936, hidden_size=1024, intermediate_size=768,
            num_layers=24, num_heads=16, num_kv_heads=4, head_dim=64,
            rope_theta=1e6, tie_word_embeddings=True,
            qkv_bias=False, qk_norm=True,
            num_experts=32, num_experts_per_token=2,
        )

    @staticmethod
    def tiny(vocab_size: int = 256, max_seq_len: int = 128) -> "LLMConfig":
        """Tiny config for unit tests."""
        return LLMConfig(
            vocab_size=vocab_size, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=max_seq_len,
            rope_theta=1e4, tie_word_embeddings=True, dtype="float32",
        )
