"""Rotary position embeddings (HF Llama/Qwen2 layout: rotate_half pairing).

Computed in float32 regardless of activation dtype.
"""

from __future__ import annotations

import torch


def rope_frequencies(
    head_dim: int,
    max_position: int,
    theta: float = 10000.0,
    device="cpu",
) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables of shape [max_position, head_dim], fp32.

    HF convention: inv_freq over even indices, duplicated across both halves
    (rotate_half), not interleaved.
    """
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    t = torch.arange(max_position, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(
    q: torch.Tensor,
    k: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    positions: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply rotary embedding at ``positions``.

    q: [B, S, H, D], k: [B, S, K, D], positions: [B, S] integer.
    """
    cos_p = cos[positions][:, :, None, :]
    sin_p = sin[positions][:, :, None, :]
    q32, k32 = q.float(), k.float()
    q_out = q32 * cos_p + _rotate_half(q32) * sin_p
    k_out = k32 * cos_p + _rotate_half(k32) * sin_p
    return q_out.to(q.dtype), k_out.to(k.dtype)
