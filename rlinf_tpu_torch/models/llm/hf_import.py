"""Hugging Face checkpoint import and export: a transformers state dict <->
the port's stacked-layer params.

Port of ``rlinf_tpu/models/llm/hf_import.py``. Conversion is a relayout:
the per-layer tensors are stacked along a leading [L, ...] axis and the
linear weights transposed to [in, out]. Every value goes through f32 and
then to the model's dtype, as the JAX package's load through
``torch_dtype="float32"`` does, so a bf16 checkpoint loads bitwise. The
files are read by ``hf_files`` (no transformers or safetensors package).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Mapping, Tuple

import torch

from rlinf_tpu_torch.models.llm.config import LLMConfig
from rlinf_tpu_torch.models.llm.hf_files import load_state_dict, read_json
from rlinf_tpu_torch.utils.device import resolve_device


def params_from_hf_state_dict(state_dict: Mapping[str, torch.Tensor], cfg: LLMConfig,
                              device="cuda") -> Dict:
    """A Qwen2/Qwen3/Llama ``state_dict`` -> the port's params on ``device``.

    HF linear weights are [out, in]; the port's are [in, out]. A tied model
    reads no ``lm_head.weight``."""
    dev = resolve_device(device)
    sd = {k.removeprefix("model."): v for k, v in state_dict.items()}
    dt = cfg.compute_dtype

    def get(name: str) -> torch.Tensor:
        if name not in sd:
            raise KeyError(f"the checkpoint has no tensor {name!r}")
        return sd[name].float().to(dt)

    def stack(name: str, transpose: bool = False) -> torch.Tensor:
        ts = [get(f"layers.{i}.{name}") for i in range(cfg.num_layers)]
        return torch.stack([t.T if transpose else t for t in ts]).to(dev)

    blocks = {
        "attn_norm": stack("input_layernorm.weight"),
        "wq": stack("self_attn.q_proj.weight", True),
        "wk": stack("self_attn.k_proj.weight", True),
        "wv": stack("self_attn.v_proj.weight", True),
        "wo": stack("self_attn.o_proj.weight", True),
        "mlp_norm": stack("post_attention_layernorm.weight"),
        "gate": stack("mlp.gate_proj.weight", True),
        "up": stack("mlp.up_proj.weight", True),
        "down": stack("mlp.down_proj.weight", True),
    }
    if cfg.qkv_bias:
        blocks["bq"] = stack("self_attn.q_proj.bias")
        blocks["bk"] = stack("self_attn.k_proj.bias")
        blocks["bv"] = stack("self_attn.v_proj.bias")
    if cfg.qk_norm:
        blocks["q_norm"] = stack("self_attn.q_norm.weight")
        blocks["k_norm"] = stack("self_attn.k_norm.weight")
    params = {
        "embed": get("embed_tokens.weight").to(dev),
        "blocks": blocks,
        "final_norm": get("norm.weight").to(dev),
    }
    if not cfg.tie_word_embeddings:
        # lm_head lives outside the "model." prefix in HF checkpoints
        params["lm_head"] = get("lm_head.weight").T.contiguous().to(dev)
    return params


def load_hf_config(path: str) -> LLMConfig:
    """``LLMConfig`` of the ``config.json`` in ``path``."""
    return LLMConfig.from_hf_config(read_json(os.path.join(path, "config.json")))


def load_hf_pretrained(path: str, dtype: str = "bfloat16", device="cuda") -> Tuple[LLMConfig, Dict]:
    """(cfg, params) of a local HF causal-LM checkpoint directory."""
    cfg = dataclasses.replace(load_hf_config(path), dtype=dtype)
    params = params_from_hf_state_dict(load_state_dict(path), cfg, device=device)
    return cfg, params


def params_to_hf_state_dict(params, cfg: LLMConfig) -> Dict[str, torch.Tensor]:
    """The inverse relayout: the port's params -> a HF Qwen2/Qwen3/Llama
    state dict of f32 CPU tensors. A tied model gets an ``lm_head.weight``
    equal to the embedding, as a HF state dict holds one."""
    blocks = params["blocks"]

    def f32(t: torch.Tensor) -> torch.Tensor:
        return t.detach().to("cpu", torch.float32)

    out: Dict[str, torch.Tensor] = {
        "model.embed_tokens.weight": f32(params["embed"]),
        "model.norm.weight": f32(params["final_norm"]),
    }
    names = [
        ("input_layernorm.weight", "attn_norm", False),
        ("self_attn.q_proj.weight", "wq", True),
        ("self_attn.k_proj.weight", "wk", True),
        ("self_attn.v_proj.weight", "wv", True),
        ("self_attn.o_proj.weight", "wo", True),
        ("post_attention_layernorm.weight", "mlp_norm", False),
        ("mlp.gate_proj.weight", "gate", True),
        ("mlp.up_proj.weight", "up", True),
        ("mlp.down_proj.weight", "down", True),
    ]
    if cfg.qkv_bias:
        names += [("self_attn.q_proj.bias", "bq", False),
                  ("self_attn.k_proj.bias", "bk", False),
                  ("self_attn.v_proj.bias", "bv", False)]
    if cfg.qk_norm:
        names += [("self_attn.q_norm.weight", "q_norm", False),
                  ("self_attn.k_norm.weight", "k_norm", False)]
    stacked = {key: f32(blocks[key]) for _, key, _ in names}
    for i in range(cfg.num_layers):
        for hf_name, key, transpose in names:
            t = stacked[key][i]
            out[f"model.layers.{i}.{hf_name}"] = t.T.contiguous() if transpose else t
    if cfg.tie_word_embeddings:
        out["lm_head.weight"] = out["model.embed_tokens.weight"]
    else:
        out["lm_head.weight"] = f32(params["lm_head"]).T.contiguous()
    return out
