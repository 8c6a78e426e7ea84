"""Analytic FLOPs/bytes accounting + speed-of-light estimates.

Port of ``rlinf_tpu/utils/flops.py`` on the port's ``LLMConfig``. Reference
analog: rlinf/utils/flops.py:45 (prefill/decode/train FLOPs -> TFLOPs/GPU
metrics in runners/reasoning_runner.py:322-357), with a roofline
speed-of-light model. The chip presets are the port's own: ``ChipSpec.h100``
(the figures of the H100 SXM data sheet) in place of the JAX package's TPU
presets.
"""

from __future__ import annotations

import dataclasses

from rlinf_tpu_torch.models.llm.config import LLMConfig


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    bf16_flops: float      # peak FLOP/s
    hbm_bw: float          # bytes/s
    hbm_bytes: float

    @staticmethod
    def h100() -> "ChipSpec":
        # H100 SXM: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, 80 GB
        return ChipSpec("h100-sxm", 989e12, 3.35e12, 80e9)


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


def attention_flops(cfg: LLMConfig, seq_len: int, kv_len: float) -> float:
    """Per-token attention FLOPs at the given average kv length."""
    return cfg.num_layers * 2 * 2 * cfg.num_heads * cfg.head_dim_ * kv_len


def train_step_flops(cfg: LLMConfig, batch: int, seq_len: int) -> float:
    """fwd + bwd (2x fwd) matmul FLOPs + causal attention, for B*S tokens."""
    tokens = batch * seq_len
    mat = 3 * model_matmul_flops_per_token(cfg) * tokens
    attn = 3 * attention_flops(cfg, seq_len, seq_len / 2) * tokens
    return mat + attn


def prefill_flops(cfg: LLMConfig, batch: int, seq_len: int) -> float:
    tokens = batch * seq_len
    return (
        model_matmul_flops_per_token(cfg) * tokens
        + attention_flops(cfg, seq_len, seq_len / 2) * tokens
    )


def decode_step_bytes(cfg: LLMConfig, batch: int, kv_len: float) -> float:
    """HBM bytes per decode step: all weights + the batch's KV cache.

    Weights are counted at bf16, the JAX package's convention: the roofline
    models the reference's bf16 serving stack, so int8 weight-only decode
    can run under this bound."""
    weight_bytes = cfg.num_params() * 2  # bf16 baseline convention
    kv_bytes = (
        batch * cfg.num_layers * 2 * kv_len * cfg.kv_dim * 2
    )
    return weight_bytes + kv_bytes


def decode_sol_time(
    cfg: LLMConfig, chip: ChipSpec, batch: int, kv_len: float
) -> float:
    """Roofline lower bound for one decode step (whole batch, one token each)."""
    flops = batch * (
        model_matmul_flops_per_token(cfg)
        + attention_flops(cfg, 1, kv_len)
    )
    return max(flops / chip.bf16_flops, decode_step_bytes(cfg, batch, kv_len) / chip.hbm_bw)


def train_sol_time(cfg: LLMConfig, chip: ChipSpec, batch: int, seq_len: int) -> float:
    return train_step_flops(cfg, batch, seq_len) / chip.bf16_flops


def train_mfu(
    cfg: LLMConfig, chip: ChipSpec, batch: int, seq_len: int, seconds: float
) -> float:
    return train_step_flops(cfg, batch, seq_len) / (seconds * chip.bf16_flops)


# ---------------------------------------------------------------------------
# VLA rooflines: analytic FLOPs/bytes for the pi0 prefill + flow-step
# rollout and the OpenVLA autoregressive action decode.
# ---------------------------------------------------------------------------

def vit_encode_flops(
    hidden: int, layers: int, num_patches: int, mlp_ratio: int = 4
) -> float:
    """Matmul + attention FLOPs for ONE image through a ViT encoder."""
    d = hidden
    per_tok_mat = 2 * (4 * d * d + 2 * d * d * mlp_ratio)
    per_tok_attn = 2 * 2 * num_patches * d
    return layers * num_patches * (per_tok_mat + per_tok_attn)


def trunk_flops_per_token(cfg: LLMConfig) -> float:
    """Forward matmul FLOPs per token through the decoder trunk WITHOUT the
    lm head (the pi0 prefix encode never projects to vocab)."""
    return model_matmul_flops_per_token(cfg) - 2 * cfg.hidden_size * cfg.vocab_size


def pi0_rollout_sol_time(
    vlm_cfg: LLMConfig, chip: ChipSpec, *,
    batch: int, num_patches: int, text_len: int,
    expert_hidden: int, expert_ffn: int, action_chunk: int,
    num_flow_steps: int, vit_hidden: int, vit_layers: int,
    param_bytes: float,
) -> float:
    """Roofline for one pi0 action-chunk prediction (prefill + flow loop).

    Phases: ViT encode (compute) + prefix prefill through the VLM trunk
    (compute) + num_flow_steps expert passes over the (chunk+1)-token
    suffix attending to the cached prefix (compute vs weight-stream bytes,
    whichever binds). ``param_bytes`` is the full on-device tree (streamed
    at least once per chunk)."""
    Np = num_patches + text_len
    Ns = action_chunk + 1
    v = vlm_cfg
    vit = batch * vit_encode_flops(vit_hidden, vit_layers, num_patches)
    prefill = batch * Np * (
        trunk_flops_per_token(v) + attention_flops(v, Np, Np / 2)
    )
    De, Fe = expert_hidden, expert_ffn
    expert_mats = 2 * (
        De * v.q_dim + 2 * De * v.kv_dim + v.q_dim * De + 3 * De * Fe
    )
    expert_attn = 2 * 2 * v.num_heads * v.head_dim_ * (Np + Ns)
    flow = (num_flow_steps * batch * Ns
            * v.num_layers * (expert_mats + expert_attn))
    compute = (vit + prefill + flow) / chip.bf16_flops
    bytes_bound = param_bytes / chip.hbm_bw
    return max(compute, bytes_bound)


def openvla_decode_sol_time(
    vlm_cfg: LLMConfig, chip: ChipSpec, *,
    batch: int, num_patches: int, text_len: int, action_tokens: int,
    vit_hidden: int, vit_layers: int, n_vits: int = 1,
) -> float:
    """Roofline for one OpenVLA action decode: ViT(s) + prompt prefill
    (compute-bound) + ``action_tokens`` greedy decode steps (each streams
    the full trunk at the BASELINE bf16-bytes convention, like
    decode_step_bytes)."""
    v = vlm_cfg
    Np = num_patches * n_vits + text_len
    vit = batch * n_vits * vit_encode_flops(vit_hidden, vit_layers, num_patches)
    prefill = batch * Np * (
        model_matmul_flops_per_token(v) + attention_flops(v, Np, Np / 2)
    )
    compute = (vit + prefill) / chip.bf16_flops
    decode = sum(
        decode_sol_time(v, chip, batch, Np + t) for t in range(action_tokens)
    )
    return compute + decode
