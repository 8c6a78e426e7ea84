"""Decoder-only transformer (Qwen2/Llama family), plain functions on tensors.

Port of ``rlinf_tpu/models/llm/model.py``: the differentiable forward of
training (with per-block rematerialization), prefill, and the packed (bf16
and int8) KV-cache decode steps. Parameters are a dict of
tensors with the JAX package's key names and layouts: layer weights are
stacked along a leading [L, ...] axis and matmul weights are [D_in, D_out]
(``convert.params_from_numpy`` turns a JAX param tree into this dict).
Layers run as a Python loop where JAX used ``lax.scan``. All matmuls run in
the config compute dtype with fp32 softmax/norm statistics.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from rlinf_tpu_torch.models.llm.config import LLMConfig
from rlinf_tpu_torch.models.llm.quant import QTensor, mm
from rlinf_tpu_torch.ops.attention import causal_attention
from rlinf_tpu_torch.ops.cuda.decode_attention import (
    decode_attention_packed,
    decode_attention_packed_q8,
    decode_attention_packed_q8_xla,
    decode_attention_packed_xla,
    quantize_kv_token,
)
from rlinf_tpu_torch.ops.norm import rms_norm
from rlinf_tpu_torch.ops.rope import apply_rope, rope_frequencies
from rlinf_tpu_torch.utils.device import resolve_device

Params = Dict[str, object]


class KVCache(NamedTuple):
    """Decode cache: k/v of [L, B, S_max, K, D]."""

    k: torch.Tensor
    v: torch.Tensor


def init_params(cfg: LLMConfig, seed: int, device="cuda") -> Params:
    """Random init matching the HF Qwen2 scheme (normal(0.02), ones norms),
    drawn with numpy from ``seed`` so that it does not depend on the device."""
    if cfg.is_moe:
        raise NotImplementedError("MoE layers are not ported yet")
    device = resolve_device(device)
    dt = cfg.compute_dtype
    d, f, l = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    qd, kvd = cfg.q_dim, cfg.kv_dim
    rng = np.random.default_rng(seed)

    def normal(shape):
        a = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
        return a.to(device=device).to(dt) * 0.02

    def ones(shape):
        return torch.ones(shape, dtype=dt, device=device)

    def zeros(shape):
        return torch.zeros(shape, dtype=dt, device=device)

    blocks = {
        "attn_norm": ones((l, d)),
        "wq": normal((l, d, qd)),
        "wk": normal((l, d, kvd)),
        "wv": normal((l, d, kvd)),
        "wo": normal((l, qd, d)),
        "mlp_norm": ones((l, d)),
        "gate": normal((l, d, f)),
        "up": normal((l, d, f)),
        "down": normal((l, f, d)),
    }
    params: Params = {
        "embed": normal((cfg.vocab_size, d)),
        "blocks": blocks,
        "final_norm": ones((d,)),
    }
    if cfg.qkv_bias:
        blocks["bq"] = zeros((l, qd))
        blocks["bk"] = zeros((l, kvd))
        blocks["bv"] = zeros((l, kvd))
    if cfg.qk_norm:
        blocks["q_norm"] = ones((l, cfg.head_dim_))
        blocks["k_norm"] = ones((l, cfg.head_dim_))
    if not cfg.tie_word_embeddings:
        params["lm_head"] = normal((d, cfg.vocab_size))
    return params


def _layers(blocks: Params, n: int):
    """Every layer of the stacked block params, as views (no copies) from
    one ``unbind`` per leaf: under autograd the gradients of all layers are
    stacked once, where one index per layer would add an [L, ...] buffer
    per layer."""
    cols = {
        k: ([QTensor(q, s) for q, s in zip(w.q.unbind(0), w.scale.unbind(0))]
            if isinstance(w, QTensor) else w.unbind(0))
        for k, w in blocks.items()
    }
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _project_qkv(cfg: LLMConfig, layer: Params, h: torch.Tensor, B: int, S: int):
    """qkv projection + bias + head reshape + optional Qwen3 qk-norm.
    h: [B, S, D] -> q [B,S,H,Hd], k/v [B,S,K,Hd] (pre-RoPE)."""
    Hd = cfg.head_dim_
    if "wqkv" in layer:
        # fused decode weights (quantize_params(fuse=True)): one matmul
        qkv = mm(h, layer["wqkv"])
        qd, kd = cfg.q_dim, cfg.kv_dim
        q, k, v = qkv[..., :qd], qkv[..., qd:qd + kd], qkv[..., qd + kd:]
    else:
        q = mm(h, layer["wq"])
        k = mm(h, layer["wk"])
        v = mm(h, layer["wv"])
    if cfg.qkv_bias:
        q = q + layer["bq"]
        k = k + layer["bk"]
        v = v + layer["bv"]
    q = q.reshape(B, S, cfg.num_heads, Hd)
    k = k.reshape(B, S, cfg.num_kv_heads, Hd)
    v = v.reshape(B, S, cfg.num_kv_heads, Hd)
    if cfg.qk_norm:
        q = rms_norm(q, layer["q_norm"], cfg.rms_eps)
        k = rms_norm(k, layer["k_norm"], cfg.rms_eps)
    return q, k, v


def _mlp_or_moe(cfg: LLMConfig, x: torch.Tensor, layer: Params) -> torch.Tensor:
    """Dense SwiGLU MLP, residual included."""
    if cfg.is_moe:
        raise NotImplementedError("MoE layers are not ported yet")
    h = rms_norm(x, layer["mlp_norm"], cfg.rms_eps)
    if "wgu" in layer:
        gu = mm(h, layer["wgu"])
        f = gu.shape[-1] // 2
        gated = F.silu(gu[..., :f]) * gu[..., f:]
    else:
        gated = F.silu(mm(h, layer["gate"])) * mm(h, layer["up"])
    return x + mm(gated, layer["down"])


def _block(
    cfg: LLMConfig,
    x: torch.Tensor,
    layer: Params,
    cos: torch.Tensor,
    sin: torch.Tensor,
    positions: torch.Tensor,
    kv_valid_mask: Optional[torch.Tensor],
    attn_impl: str,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One transformer block. Returns (x_out, (k, v)) with k/v [B,S,K,D]."""
    B, S, _ = x.shape
    h = rms_norm(x, layer["attn_norm"], cfg.rms_eps)
    q, k, v = _project_qkv(cfg, layer, h, B, S)
    q, k = apply_rope(q, k, cos, sin, positions)
    attn = causal_attention(
        q, k, v,
        positions_q=positions,
        positions_kv=positions,
        kv_valid_mask=kv_valid_mask,
        impl=attn_impl,
    )
    x = x + mm(attn.reshape(B, S, cfg.q_dim), layer["wo"])
    return _mlp_or_moe(cfg, x, layer), (k, v)


def forward_hidden(
    params: Params,
    cfg: LLMConfig,
    input_ids: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
    attention_mask: Optional[torch.Tensor] = None,
    *,
    attn_impl: str = "xla",
    return_kv: bool = False,
    remat=False,
    unroll_layers: bool = False,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Token ids [B, S] -> final hidden states [B, S, D] (pre-lm_head).

    attention_mask: [B, S] bool, False = padding (left or right).
    remat: True or "full" recomputes each block in the backward
      (``torch.utils.checkpoint``, non-reentrant), as ``jax.checkpoint``
      does; "dots" (keep the matmul outputs) has no counterpart yet.
    unroll_layers: accepted for the JAX signature; the port always runs the
      layers as a Python loop.
    """
    del unroll_layers
    if remat == "dots":
        raise NotImplementedError(
            "remat='dots' (save matmul outputs, recompute the rest) comes with a "
            "later slice of the port; use remat=True")
    if remat not in (False, True, "full"):
        raise ValueError(f"remat must be False, True, 'full' or 'dots', got {remat!r}")
    B, S = input_ids.shape
    dev = input_ids.device
    if positions is None:
        if attention_mask is not None:
            positions = (attention_mask.to(torch.int32).cumsum(dim=-1) - 1).clamp_min(0)
        else:
            positions = torch.arange(S, device=dev).expand(B, S)

    cos, sin = rope_frequencies(cfg.head_dim_, cfg.max_seq_len, cfg.rope_theta, dev)
    x = params["embed"][input_ids.long()].to(cfg.compute_dtype)

    def block_fn(x, layer):
        return _block(cfg, x, layer, cos, sin, positions, attention_mask, attn_impl)

    ks, vs = [], []
    for layer in _layers(params["blocks"], cfg.num_layers):
        if remat and torch.is_grad_enabled():
            x, (k, v) = checkpoint(block_fn, x, layer, use_reentrant=False)
        else:
            x, (k, v) = block_fn(x, layer)
        if return_kv:
            ks.append(k)
            vs.append(v)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    cache = KVCache(k=torch.stack(ks), v=torch.stack(vs)) if return_kv else None
    return x, cache


def lm_head_weight(params: Params, cfg: LLMConfig):
    if "lm_head" in params:
        return params["lm_head"]
    return params["embed"].T


def lm_head_logits(params: Params, cfg: LLMConfig, hidden: torch.Tensor) -> torch.Tensor:
    """hidden [..., D] -> fp32 logits [..., V]; handles a QTensor lm_head.

    A plain lm_head is applied in fp32 on exact fp32 copies of the operands:
    the JAX package's einsum with an fp32 result type."""
    w = lm_head_weight(params, cfg)
    if isinstance(w, QTensor):
        return mm(hidden, w).float()
    return hidden.float() @ w.float()


def forward_logits(
    params: Params,
    cfg: LLMConfig,
    input_ids: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
    attention_mask: Optional[torch.Tensor] = None,
    **kw,
) -> torch.Tensor:
    """Full-vocab fp32 logits [B, S, V]. Prefer the fused logprob ops for
    training: this materializes the logits tensor."""
    hidden, _ = forward_hidden(params, cfg, input_ids, positions, attention_mask, **kw)
    return lm_head_logits(params, cfg, hidden)


# ---------------------------------------------------------------------------
# Decode path (KV cache)
# ---------------------------------------------------------------------------

def prefill(
    params: Params,
    cfg: LLMConfig,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    max_cache_len: int,
    *,
    attn_impl: str = "xla",
) -> Tuple[torch.Tensor, KVCache]:
    """Run the prompt through the model, returning the last-position hidden
    state [B, D] and a KV cache padded to ``max_cache_len``.

    Prompts are LEFT-padded so every sequence's last token sits at index
    S-1; cache slots [0, S) are the (masked) prompt, decode appends at S.
    """
    B, S = input_ids.shape
    if max_cache_len < S:
        raise ValueError(f"max_cache_len {max_cache_len} < prompt length {S}")
    hidden, kv = forward_hidden(
        params, cfg, input_ids, attention_mask=attention_mask,
        attn_impl=attn_impl, return_kv=True,
    )
    pad = max_cache_len - S
    k = F.pad(kv.k, (0, 0, 0, 0, 0, pad))
    v = F.pad(kv.v, (0, 0, 0, 0, 0, pad))
    return hidden[:, -1, :], KVCache(k=k, v=v)


# ---------------------------------------------------------------------------
# Packed decode path
# ---------------------------------------------------------------------------
#
# Cache layout [B, S_max, Kv*Hd] per layer, read by the decode-attention
# kernels (ops/cuda/decode_attention.py). The decode steps write the new
# token's k/v into the layer buffers IN PLACE, where the JAX package
# returned new buffers from dynamic_update_slice / .at[].set (which XLA
# lowered to in-place updates of loop-carried buffers).

PackedKVLayers = Tuple[Tuple[torch.Tensor, torch.Tensor], ...]


def init_kv_cache_packed(cfg: LLMConfig, batch: int, max_len: int, device="cuda") -> PackedKVLayers:
    """Tuple of per-layer (k, v), each [B, S_max, Kv*Hd]."""
    device = resolve_device(device)
    shape = (batch, max_len, cfg.kv_dim)
    dt = cfg.compute_dtype
    return tuple(
        (torch.zeros(shape, dtype=dt, device=device),
         torch.zeros(shape, dtype=dt, device=device))
        for _ in range(cfg.num_layers)
    )


def packed_cache_from_stacked(cache: KVCache) -> PackedKVLayers:
    """KVCache [L,B,S,K,D] -> per-layer packed (k, v) [B,S,K*D] (views)."""
    L, B, S = cache.k.shape[:3]
    kd = cache.k.shape[3] * cache.k.shape[4]
    return tuple(
        (cache.k[i].reshape(B, S, kd), cache.v[i].reshape(B, S, kd))
        for i in range(L)
    )


def default_decode_attn_impl(device) -> str:
    """The hand-written kernel on the card, the plain version elsewhere."""
    return "pallas" if torch.device(device).type == "cuda" else "xla"


def _packed_decode_attn(q, kc, vc, starts, lengths, num_kv, impl):
    if impl == "pallas":
        return decode_attention_packed(q, kc, vc, starts, lengths, num_kv=num_kv)
    return decode_attention_packed_xla(q, kc, vc, starts, lengths, num_kv=num_kv)


def _write_slot(buf: torch.Tensor, write_pos, rows, value: torch.Tensor) -> None:
    """buf[b, write_pos(b)] = value[b], in place; write_pos scalar or [B]."""
    if rows is None:
        buf[:, write_pos] = value
    else:
        buf[rows, write_pos] = value


def _decode_inputs(params, cfg, token_ids, write_pos):
    B = token_ids.shape[0]
    dev = token_ids.device
    cos, sin = rope_frequencies(cfg.head_dim_, cfg.max_seq_len, cfg.rope_theta, dev)
    x = params["embed"][token_ids.long()][:, None, :].to(cfg.compute_dtype)
    uniform_slot = not torch.is_tensor(write_pos) or write_pos.ndim == 0
    rows = None if uniform_slot else torch.arange(B, device=dev)
    if not uniform_slot:
        write_pos = write_pos.long()
    return x, cos, sin, rows, write_pos


def decode_step_packed(
    params: Params,
    cfg: LLMConfig,
    token_ids: torch.Tensor,    # [B] current input token per row
    kv_layers: PackedKVLayers,
    write_pos,                  # int or [B]: cache slot for this token's kv
    positions: torch.Tensor,    # [B] rope position of this token
    starts: torch.Tensor,       # [B] int32 first valid cache slot
    lengths: torch.Tensor,      # [B] int32 end of valid interval INCLUDING this slot
    *,
    attn_impl: Optional[str] = None,
) -> Tuple[torch.Tensor, PackedKVLayers]:
    """One decode step on the packed cache. Returns ([B, D] hidden, cache);
    the cache buffers are updated in place and returned.

    ``write_pos`` is one slot for every row (static engine) or a [B] vector
    (continuous batching: per-row slots).
    """
    B = token_ids.shape[0]
    impl = attn_impl or default_decode_attn_impl(token_ids.device)
    kd = cfg.kv_dim
    x, cos, sin, rows, write_pos = _decode_inputs(params, cfg, token_ids, write_pos)
    pos = positions[:, None]
    for (kc, vc), layer in zip(kv_layers, _layers(params["blocks"], len(kv_layers))):
        h = rms_norm(x, layer["attn_norm"], cfg.rms_eps)
        q, k, v = _project_qkv(cfg, layer, h, B, 1)
        q, k = apply_rope(q, k, cos, sin, pos)
        _write_slot(kc, write_pos, rows, k.reshape(B, kd))
        _write_slot(vc, write_pos, rows, v.reshape(B, kd))
        attn = _packed_decode_attn(
            q.reshape(B, cfg.num_heads, cfg.head_dim_), kc, vc,
            starts, lengths, cfg.num_kv_heads, impl,
        )
        x = x + mm(attn.reshape(B, 1, cfg.q_dim), layer["wo"])
        x = _mlp_or_moe(cfg, x, layer)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return x[:, 0, :], kv_layers


# ---------------------------------------------------------------------------
# int8 KV cache decode (scales fold into the attention's score/prob rows)
# ---------------------------------------------------------------------------

PackedKVQ8Layers = Tuple[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], ...]


def init_kv_cache_packed_q8(cfg: LLMConfig, batch: int, max_len: int, device="cuda") -> PackedKVQ8Layers:
    """Per-layer (k int8 [B,S,KD], v int8, k_scale f32 [B,S], v_scale)."""
    device = resolve_device(device)
    shape = (batch, max_len, cfg.kv_dim)
    return tuple(
        (torch.zeros(shape, dtype=torch.int8, device=device),
         torch.zeros(shape, dtype=torch.int8, device=device),
         torch.ones((batch, max_len), dtype=torch.float32, device=device),
         torch.ones((batch, max_len), dtype=torch.float32, device=device))
        for _ in range(cfg.num_layers)
    )


def quantize_packed_kv(k: torch.Tensor):
    """[..., KD] -> (int8, f32 scale [...]) per token (max-abs / 127)."""
    return quantize_kv_token(k)


def decode_step_packed_q8(
    params: Params,
    cfg: LLMConfig,
    token_ids: torch.Tensor,
    kv_layers: PackedKVQ8Layers,
    write_pos,
    positions: torch.Tensor,
    starts: torch.Tensor,
    lengths: torch.Tensor,
    *,
    attn_impl: Optional[str] = None,
) -> Tuple[torch.Tensor, PackedKVQ8Layers]:
    """decode_step_packed on an int8 KV cache: the new k/v are quantized on
    write (per-token max-abs scale) into the buffers in place, and attention
    folds the scales into score/prob rows (no wide dequantization)."""
    B = token_ids.shape[0]
    impl = attn_impl or default_decode_attn_impl(token_ids.device)
    kd = cfg.kv_dim
    x, cos, sin, rows, write_pos = _decode_inputs(params, cfg, token_ids, write_pos)
    pos = positions[:, None]
    for (kc, vc, ksc, vsc), layer in zip(kv_layers, _layers(params["blocks"], len(kv_layers))):
        h = rms_norm(x, layer["attn_norm"], cfg.rms_eps)
        q, k, v = _project_qkv(cfg, layer, h, B, 1)
        q, k = apply_rope(q, k, cos, sin, pos)
        kq, ks = quantize_packed_kv(k.reshape(B, kd))
        vq, vs = quantize_packed_kv(v.reshape(B, kd))
        _write_slot(kc, write_pos, rows, kq)
        _write_slot(vc, write_pos, rows, vq)
        _write_slot(ksc, write_pos, rows, ks)
        _write_slot(vsc, write_pos, rows, vs)
        qh = q.reshape(B, cfg.num_heads, cfg.head_dim_)
        if impl == "pallas":
            attn = decode_attention_packed_q8(
                qh, kc, vc, ksc, vsc, starts, lengths, num_kv=cfg.num_kv_heads)
        else:
            attn = decode_attention_packed_q8_xla(
                qh, kc, vc, ksc, vsc, starts, lengths, num_kv=cfg.num_kv_heads)
        x = x + mm(attn.reshape(B, 1, cfg.q_dim), layer["wo"])
        x = _mlp_or_moe(cfg, x, layer)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return x[:, 0, :], kv_layers
