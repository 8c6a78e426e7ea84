"""Decoder-only LLM: config, params, forward, packed KV-cache sampler."""

from rlinf_tpu_torch.models.llm.config import LLMConfig
from rlinf_tpu_torch.models.llm.convert import params_from_numpy
from rlinf_tpu_torch.models.llm.model import (
    KVCache,
    decode_step_packed,
    decode_step_packed_q8,
    forward_hidden,
    init_kv_cache_packed,
    init_kv_cache_packed_q8,
    init_params,
    lm_head_logits,
    lm_head_weight,
    packed_cache_from_stacked,
    prefill,
)
from rlinf_tpu_torch.models.llm.quant import QTensor, quantize_params
from rlinf_tpu_torch.models.llm.sampler import (
    GenerateOutput,
    SamplingParams,
    generate,
    sample_from_logits,
)

__all__ = [
    "LLMConfig",
    "KVCache",
    "decode_step_packed",
    "decode_step_packed_q8",
    "forward_hidden",
    "init_kv_cache_packed",
    "init_kv_cache_packed_q8",
    "init_params",
    "lm_head_logits",
    "lm_head_weight",
    "packed_cache_from_stacked",
    "params_from_numpy",
    "prefill",
    "QTensor",
    "quantize_params",
    "GenerateOutput",
    "SamplingParams",
    "generate",
    "sample_from_logits",
]
