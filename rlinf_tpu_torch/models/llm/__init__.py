"""Decoder-only LLM: config, params, forward, the unpacked and packed KV-cache
decode steps, the sampler, HF import."""

from rlinf_tpu_torch.models.llm.config import LLMConfig
from rlinf_tpu_torch.models.llm.convert import params_from_numpy
from rlinf_tpu_torch.models.llm.hf_import import params_from_hf_state_dict
from rlinf_tpu_torch.models.llm.model import (
    KVCache,
    decode_step,
    decode_step_layered,
    decode_step_packed,
    decode_step_packed_q8,
    decode_step_ragged,
    forward_hidden,
    forward_logits,
    init_kv_cache,
    init_kv_cache_packed,
    init_kv_cache_packed_q8,
    init_params,
    layered_cache_from_stacked,
    lm_head_logits,
    lm_head_weight,
    packed_cache_from_stacked,
    partition_rules,
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
    "decode_step",
    "decode_step_layered",
    "decode_step_packed",
    "decode_step_packed_q8",
    "decode_step_ragged",
    "forward_hidden",
    "forward_logits",
    "init_kv_cache",
    "init_kv_cache_packed",
    "init_kv_cache_packed_q8",
    "init_params",
    "layered_cache_from_stacked",
    "lm_head_logits",
    "lm_head_weight",
    "packed_cache_from_stacked",
    "partition_rules",
    "params_from_hf_state_dict",
    "params_from_numpy",
    "prefill",
    "QTensor",
    "quantize_params",
    "GenerateOutput",
    "SamplingParams",
    "generate",
    "sample_from_logits",
]
