"""Kernels K2/K3: packed-cache decode attention, and their plain versions.

Port of ``rlinf_tpu/ops/pallas/decode_attention.py``. The cache is packed
``[B, S_max, Kv*Hd]`` per layer, bf16 (K2) or int8 with one f32 scale per
(row, slot) (K3). Slot ``s`` of row ``b`` takes part iff
``start[b] <= s < length[b]``; an empty interval gives 0. The CUDA source
is ``csrc/decode_attention.cu``: both split-KV over 16-key blocks
(``split_plan``) on the tensor cores, then a merge of the splits, in one
call each. K2 takes up to 16 query heads per kv head, K3 up to 8.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from rlinf_tpu_torch.ops.cuda._build import (
    F, I, P, CudaKernel, check_cuda_tensor, sm_count, stream_handle,
)
from rlinf_tpu_torch.ops.cuda.geometry import check_heads

NEG_INF = -2.0**30

KERNEL_BF16 = CudaKernel(
    "decode_attention.cu", "decode_attention_bf16",
    [I, P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, P],
)
KERNEL_Q8 = CudaKernel(
    "decode_attention.cu", "decode_attention_q8",
    [I, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, P],
)

#: keys of one block of K2 and K3 (csrc KEYS): their splits are runs of whole blocks
KEY_BLOCK = 16
#: CTAs the split grids of K2, K3 and K10 aim at, per SM
CTAS_PER_SM = 4
#: fewest units a split (K3's 16-key blocks, K10's pages): one for each warp of a CTA
MIN_SPLIT_UNITS = 4


@functools.lru_cache(maxsize=None)
def split_plan(rows: int, max_units: int, sms: int) -> Tuple[int, int]:
    """-> (units per split, number of splits) for ``rows`` (row, kv head)
    pairs whose valid keys span up to ``max_units`` units (K2, K3: 16-key blocks,
    K10: pages): enough splits that the grid (rows x splits CTAs) covers
    ``sms`` SMs CTAS_PER_SM times, but no fewer than MIN_SPLIT_UNITS units a
    split (one for each warp of a CTA), so that a few long rows are not cut
    into many tiny splits. Split ``s`` of a row of n units covers its units
    ``[s * ups, min((s + 1) * ups, n))``; the kernels' splits past the last
    unit return at once. Cached: a decode loop asks for one plan at every
    call."""
    want = -(-CTAS_PER_SM * sms // max(rows, 1))
    ups = min(max_units, max(MIN_SPLIT_UNITS, max_units // want))
    return ups, -(-max_units // ups)


def _plain(q, k, v, k_scale, v_scale, starts, lengths, num_kv, scale):
    """fp32 decode attention with optional per-slot scales folded into the
    score (k) and the probability (v), as the kernels compute it."""
    B, H, Hd = q.shape
    S = k.shape[1]
    G = H // num_kv
    if scale is None:
        scale = Hd**-0.5
    kf = k.float().reshape(B, S, num_kv, Hd)
    vf = v.float().reshape(B, S, num_kv, Hd)
    qg = q.float().reshape(B, num_kv, G, Hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, kf) * scale
    if k_scale is not None:
        s = s * k_scale.float()[:, None, None, :]
    pos = torch.arange(S, device=q.device)[None, :]
    valid = (pos >= starts[:, None]) & (pos < lengths[:, None])          # [B, S]
    valid = valid[:, None, None, :]
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if v_scale is not None:
        p = p * v_scale.float()[:, None, None, :]
    out = torch.einsum("bkgs,bskd->bkgd", p, vf) / l_safe
    return out.reshape(B, H, Hd).to(q.dtype)


def decode_attention_packed_xla(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
    starts: torch.Tensor, lengths: torch.Tensor, *,
    num_kv: int, scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version of K2 -> [B, H, Hd] in q.dtype (fp32 inside)."""
    return _plain(q, k_cache, v_cache, None, None, starts, lengths, num_kv, scale)


def decode_attention_packed_q8_xla(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
    k_scale: torch.Tensor, v_scale: torch.Tensor,
    starts: torch.Tensor, lengths: torch.Tensor, *,
    num_kv: int, scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version of K3: the scales fold into scores and probabilities;
    the cache is not dequantized."""
    return _plain(q, k_cache, v_cache, k_scale, v_scale, starts, lengths, num_kv, scale)


def _check_common(kernel, q, k_cache, v_cache, starts, lengths, num_kv, cache_dtype):
    B, H, Hd = q.shape
    S = k_cache.shape[1]
    check_heads(kernel, H, num_kv, Hd)
    check_cuda_tensor("q", q, torch.bfloat16, (B, H, Hd))
    check_cuda_tensor("k_cache", k_cache, cache_dtype, (B, S, num_kv * Hd))
    check_cuda_tensor("v_cache", v_cache, cache_dtype, (B, S, num_kv * Hd))
    check_cuda_tensor("starts", starts, torch.int32, (B,))
    check_cuda_tensor("lengths", lengths, torch.int32, (B,))
    return B, H, Hd, S


def decode_attention_packed(
    q: torch.Tensor,          # [B, H, Hd] bf16, one decode token per row
    k_cache: torch.Tensor,    # [B, S_max, Kv*Hd] bf16
    v_cache: torch.Tensor,
    starts: torch.Tensor,     # [B] int32 first valid slot
    lengths: torch.Tensor,    # [B] int32 end of the valid interval (exclusive)
    *,
    num_kv: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """K2 -> [B, H, Hd] in q.dtype: the split kernel and the merge, one
    launch in the count. CPU tensors run the plain version."""
    if q.device.type == "cpu":
        return decode_attention_packed_xla(
            q, k_cache, v_cache, starts, lengths, num_kv=num_kv, scale=scale)
    B, H, Hd, S = _check_common(
        "decode_attention_bf16", q, k_cache, v_cache, starts, lengths, num_kv, torch.bfloat16)
    dev = q.device.index
    bps, splits = split_plan(B * num_kv, -(-S // KEY_BLOCK), sm_count(dev))
    # the splits' o [B * Kv, splits, G, Hd], then their (m, l) [B * Kv, splits, G, 2]
    part = torch.empty((B * H * splits * (Hd + 2),), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    KERNEL_BF16(
        dev, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), starts.data_ptr(),
        lengths.data_ptr(), part.data_ptr(), out.data_ptr(), B, H, num_kv, S, Hd, bps, splits,
        float(Hd**-0.5 if scale is None else scale), stream_handle(),
    )
    return out


def decode_attention_packed_q8(
    q: torch.Tensor,          # [B, H, Hd] bf16
    k_cache: torch.Tensor,    # [B, S, Kv*Hd] int8
    v_cache: torch.Tensor,    # [B, S, Kv*Hd] int8
    k_scale: torch.Tensor,    # [B, S] f32
    v_scale: torch.Tensor,    # [B, S] f32
    starts: torch.Tensor,
    lengths: torch.Tensor,
    *,
    num_kv: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """K3 -> [B, H, Hd] in q.dtype: the split kernel and the merge, one
    launch in the count. CPU tensors run the plain version."""
    if q.device.type == "cpu":
        return decode_attention_packed_q8_xla(
            q, k_cache, v_cache, k_scale, v_scale, starts, lengths,
            num_kv=num_kv, scale=scale)
    B, H, Hd, S = _check_common(
        "decode_attention_q8", q, k_cache, v_cache, starts, lengths, num_kv, torch.int8)
    check_cuda_tensor("k_scale", k_scale, torch.float32, (B, S))
    check_cuda_tensor("v_scale", v_scale, torch.float32, (B, S))
    dev = q.device.index
    bps, splits = split_plan(B * num_kv, -(-S // KEY_BLOCK), sm_count(dev))
    # the splits' o [B * Kv, splits, G, Hd], then their (m, l) [B * Kv, splits, G, 2]
    part = torch.empty((B * H * splits * (Hd + 2),), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    KERNEL_Q8(
        dev, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), starts.data_ptr(), lengths.data_ptr(), part.data_ptr(),
        out.data_ptr(), B, H, num_kv, S, Hd, bps, splits,
        float(Hd**-0.5 if scale is None else scale), stream_handle(),
    )
    return out


def quantize_kv_token(k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., KD] -> (int8 values, f32 scale [...]) per token.

    max-abs / 127 with a floor of 1e-8, round half to even (``torch.round``),
    clip to +-127: bit for bit the JAX package's quantize_kv_token.
    """
    a = k.float()
    s = (a.abs().amax(dim=-1) / 127.0).clamp_min(1e-8)
    q = torch.round(a / s[..., None]).clamp(-127, 127).to(torch.int8)
    return q, s
