"""Attention: causal (prefill) and KV-cache decode.

Plain PyTorch implementations here (the JAX package's "xla" path); the
hand-written flash-attention kernel K1 lives in
``rlinf_tpu_torch.ops.cuda.flash_attention`` and is selected with
``causal_attention(..., impl="pallas")`` (or ``"flash"``). Softmax is
computed in float32.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.0**30  # large finite negative; avoids NaN from (-inf) - (-inf)


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: [B, Sq, H, D], k: [B, Sk, K, D] with H = K * G -> [B, K, G, Sq, Sk]."""
    B, Sq, H, D = q.shape
    K = k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, D)
    return torch.einsum("bqkgd,bskd->bkgqs", qg, k)


def causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    positions_q: Optional[torch.Tensor] = None,
    positions_kv: Optional[torch.Tensor] = None,
    kv_valid_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    impl: str = "xla",
) -> torch.Tensor:
    """Causal (optionally padded) grouped-query attention.

    q: [B, Sq, H, D]; k, v: [B, Sk, K, D]. Causality is ``pos_kv <= pos_q``
    over absolute positions (default arange), so left-padded prompts and
    chunked prefill take one path; ``kv_valid_mask`` [B, Sk] bool marks
    padding keys False. Returns [B, Sq, H, D] in q.dtype.
    """
    if impl in ("pallas", "flash"):
        from rlinf_tpu_torch.ops.cuda.flash_attention import flash_attention

        return flash_attention(
            q, k, v,
            positions_q=positions_q,
            positions_kv=positions_kv,
            kv_valid_mask=kv_valid_mask,
            scale=scale,
        )
    if impl == "ring":
        # Context parallelism needs a mesh with a context axis of size > 1;
        # without one the JAX package takes the plain path below, and the
        # port has no mesh yet.
        impl = "xla"
    if impl != "xla":
        raise ValueError(
            f"unknown attention impl {impl!r}; use xla | pallas | flash | ring")

    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if scale is None:
        scale = D**-0.5
    if positions_q is None:
        positions_q = torch.arange(Sq, device=q.device).expand(B, Sq)
    if positions_kv is None:
        positions_kv = torch.arange(Sk, device=q.device).expand(B, Sk)

    scores = _gqa_scores(q, k).float() * scale                      # [B,K,G,Sq,Sk]
    mask = positions_kv[:, None, :] <= positions_q[:, :, None]      # [B, Sq, Sk]
    if kv_valid_mask is not None:
        mask = mask & kv_valid_mask.bool()[:, None, :]
    scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Sq, H, D)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    valid_mask: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token attention against a preallocated KV cache.

    q: [B, 1, H, D]; k_cache/v_cache: [B, S_max, K, D]; valid_mask:
    [B, S_max] bool, True where a cache slot holds a real token.
    """
    B, _, H, D = q.shape
    if scale is None:
        scale = D**-0.5
    scores = _gqa_scores(q, k_cache).float() * scale                # [B,K,G,1,S]
    scores = scores.masked_fill(~valid_mask.bool()[:, None, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v_cache)
    return out.reshape(B, 1, H, D)
