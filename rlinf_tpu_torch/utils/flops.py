"""Analytic FLOP counts of the LLM paths.

The port's own copy of ``model_matmul_flops_per_token`` of
``rlinf_tpu/utils/flops.py``, on the port's ``LLMConfig``: the runner's
``perf/train_tflops_per_s`` counts with it. The JAX package's other
counts, roofline bounds and chip presets are not ported: nothing on the
port's path reads them yet.
"""

from __future__ import annotations

from rlinf_tpu_torch.models.llm.config import LLMConfig


def model_matmul_flops_per_token(cfg: LLMConfig) -> float:
    """Forward matmul FLOPs per token (2*params for the matmul weights).

    MoE models count ACTIVE compute only: router + top-k expert SwiGLUs
    (the reference's TFLOPs convention for its MoE GRPO numbers — activated
    params, not total)."""
    d, f = cfg.hidden_size, cfg.intermediate_size
    if cfg.is_moe:
        mlp = 2 * (d * cfg.num_experts
                   + cfg.num_experts_per_token * 3 * d * f)
    else:
        mlp = 2 * 3 * d * f
    per_layer = 2 * (
        d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
    ) + mlp
    lm = 2 * d * cfg.vocab_size
    return cfg.num_layers * per_layer + lm
