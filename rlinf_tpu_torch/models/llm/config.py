"""LLM architecture config (Qwen2/Llama-family decoder).

The port's own copy of ``rlinf_tpu/models/llm/config.py``: same fields and
presets, with ``compute_dtype`` as a ``torch.dtype``. ``from_hf_config``
reads a Hugging Face config object or a ``config.json`` dict; for a dict it
fills each missing key with the default of transformers' config class for
the ``model_type`` (``HF_CONFIG_DEFAULTS``), as loading the file through
``AutoConfig`` would.
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

    @property
    def moe_config(self):
        from rlinf_tpu_torch.ops.moe import MoEConfig

        return MoEConfig(
            num_experts=self.num_experts,
            num_experts_per_token=self.num_experts_per_token,
            capacity_factor=self.moe_capacity_factor,
            aux_loss_coef=self.moe_aux_loss_coef,
            impl=self.moe_impl,
        )

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

    @staticmethod
    def from_hf_config(hf_cfg) -> "LLMConfig":
        """Build from a transformers config object or a ``config.json`` dict
        (Qwen2/Qwen3/Llama families), with the JAX package's rules:
        ``qkv_bias`` is ``"qwen2" in model_type``, ``qk_norm`` is ``"qwen3" in
        model_type``, and ``rope_scaling`` is ignored."""
        if isinstance(hf_cfg, dict):
            hf_cfg = _HFConfigView(hf_cfg)
        model_type = getattr(hf_cfg, "model_type", "")
        return LLMConfig(
            vocab_size=hf_cfg.vocab_size,
            hidden_size=hf_cfg.hidden_size,
            intermediate_size=hf_cfg.intermediate_size,
            num_layers=hf_cfg.num_hidden_layers,
            num_heads=hf_cfg.num_attention_heads,
            num_kv_heads=getattr(hf_cfg, "num_key_value_heads", hf_cfg.num_attention_heads),
            head_dim=getattr(hf_cfg, "head_dim", None),
            rope_theta=getattr(hf_cfg, "rope_theta", 1e4),
            rms_eps=getattr(hf_cfg, "rms_norm_eps", 1e-6),
            max_seq_len=getattr(hf_cfg, "max_position_embeddings", 4096),
            tie_word_embeddings=getattr(hf_cfg, "tie_word_embeddings", False),
            qkv_bias=("qwen2" in model_type),
            qk_norm=("qwen3" in model_type),
        )


#: the defaults of transformers' (4.57) ``Qwen2Config``, ``Qwen3Config`` and
#: ``LlamaConfig`` for the keys ``from_hf_config`` reads. ``None`` for
#: ``num_key_value_heads`` means "num_attention_heads" and for Llama's
#: ``head_dim`` "hidden_size // num_attention_heads", as the classes resolve
#: them; Qwen2's class has no ``head_dim`` unless the file gives one.
HF_CONFIG_DEFAULTS = {
    "qwen2": {
        "vocab_size": 151936, "hidden_size": 4096, "intermediate_size": 22016,
        "num_hidden_layers": 32, "num_attention_heads": 32, "num_key_value_heads": 32,
        "rope_theta": 10000.0, "rms_norm_eps": 1e-6, "max_position_embeddings": 32768,
        "tie_word_embeddings": False,
    },
    "qwen3": {
        "vocab_size": 151936, "hidden_size": 4096, "intermediate_size": 22016,
        "num_hidden_layers": 32, "num_attention_heads": 32, "num_key_value_heads": 32,
        "head_dim": 128, "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
        "max_position_embeddings": 32768, "tie_word_embeddings": False,
    },
    "llama": {
        "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 11008,
        "num_hidden_layers": 32, "num_attention_heads": 32, "num_key_value_heads": None,
        "head_dim": None, "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
        "max_position_embeddings": 2048, "tie_word_embeddings": False,
    },
}


class _HFConfigView:
    """Attribute view of a ``config.json`` dict, resolved as the transformers
    config class of its ``model_type`` would resolve it."""

    def __init__(self, data: dict):
        model_type = data.get("model_type")
        if model_type not in HF_CONFIG_DEFAULTS:
            raise ValueError(
                f"config.json model_type {model_type!r} is not supported "
                f"(supported: {sorted(HF_CONFIG_DEFAULTS)})")
        merged = {**HF_CONFIG_DEFAULTS[model_type], **data}
        if merged["num_key_value_heads"] is None:
            merged["num_key_value_heads"] = merged["num_attention_heads"]
        if model_type == "llama" and merged["head_dim"] is None:
            merged["head_dim"] = merged["hidden_size"] // merged["num_attention_heads"]
        self.__dict__.update(merged)
