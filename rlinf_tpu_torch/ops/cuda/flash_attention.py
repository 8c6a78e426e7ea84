"""Kernel K1: causal GQA flash-attention forward, and its plain version.

Port of ``rlinf_tpu/ops/pallas/flash_attention.py`` (forward only; the
backward comes with the training slice). The CUDA source is
``csrc/flash_attention_fwd.cu``. Masking model: ``pos_kv <= pos_q`` over
caller-provided positions AND a kv validity mask, so one path covers left
padding and chunked prefill.

Fully masked query rows: the kernel and the plain version give 0 there,
where the Pallas kernel averages the values of the key blocks it visited.
The serving path never has such a row (every left-padded prompt has a
valid key at position 0, which every pad query sees).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rlinf_tpu_torch.ops.cuda._build import (
    F, I, P, CudaKernel, check_cuda_tensor, stream_handle,
)

NEG_INF = -2.0**30

KERNEL = CudaKernel(
    "flash_attention_fwd.cu", "flash_attention_fwd",
    [I, P, P, P, P, P, P, P, P, I, I, I, I, I, I, F, P],
)


def flash_attention_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    pos_q: torch.Tensor, pos_kv: torch.Tensor, valid: torch.Tensor,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1 -> (o [B,Sq,H,D] in q.dtype, lse [B,H,Sq] f32).

    fp32 throughout, masked keys get probability 0 (as in the kernel).
    """
    B, Sq, H, D = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.float().reshape(B, Sq, K, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    mask = (pos_kv[:, None, :] <= pos_q[:, :, None]) & valid.bool()[:, None, :]
    mask = mask[:, None, None]                                   # [B,1,1,Sq,Sk]
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float()) / l_safe.permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(l_safe))[..., 0].reshape(B, H, Sq)
    return o.reshape(B, Sq, H, D).to(q.dtype), lse


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    pos_q: torch.Tensor, pos_kv: torch.Tensor, valid: torch.Tensor,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 -> (o [B,Sq,H,D], lse [B,H,Sq] f32).

    q [B,Sq,H,D] bf16; k/v [B,Sk,K,D] bf16; pos_q [B,Sq] / pos_kv [B,Sk]
    int32; valid [B,Sk] uint8. D is 64 or 128. CPU tensors run the plain
    version.
    """
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, pos_q, pos_kv, valid, scale)
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if D not in (64, 128) or K == 0 or H % K:
        raise ValueError(f"flash_attention_fwd: unsupported H={H} K={K} D={D}")
    check_cuda_tensor("q", q, torch.bfloat16, (B, Sq, H, D))
    check_cuda_tensor("k", k, torch.bfloat16, (B, Sk, K, D))
    check_cuda_tensor("v", v, torch.bfloat16, (B, Sk, K, D))
    check_cuda_tensor("pos_q", pos_q, torch.int32, (B, Sq))
    check_cuda_tensor("pos_kv", pos_kv, torch.int32, (B, Sk))
    check_cuda_tensor("valid", valid, torch.uint8, (B, Sk))
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    KERNEL(
        q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        pos_q.data_ptr(), pos_kv.data_ptr(), valid.data_ptr(),
        o.data_ptr(), lse.data_ptr(), B, Sq, Sk, H, K, D, float(scale),
        stream_handle(),
    )
    return o, lse


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    positions_q: Optional[torch.Tensor] = None,
    positions_kv: Optional[torch.Tensor] = None,
    kv_valid_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """GQA causal flash attention. q: [B, Sq, H, D]; k/v: [B, Sk, K, D]."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    dev = q.device
    if scale is None:
        scale = D**-0.5
    if positions_q is None:
        positions_q = torch.arange(Sq, device=dev).expand(B, Sq)
    if positions_kv is None:
        positions_kv = torch.arange(Sk, device=dev).expand(B, Sk)
    if kv_valid_mask is None:
        kv_valid_mask = torch.ones((B, Sk), dtype=torch.bool, device=dev)
    o, _ = flash_attention_fwd(
        q.contiguous(), k.contiguous(), v.contiguous(),
        positions_q.to(torch.int32).contiguous(),
        positions_kv.to(torch.int32).contiguous(),
        kv_valid_mask.to(torch.uint8).contiguous(),
        float(scale),
    )
    return o
