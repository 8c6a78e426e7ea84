"""Kernels K1 (forward), K7 and K8 (backward): causal GQA flash attention,
and their plain versions.

Port of ``rlinf_tpu/ops/pallas/flash_attention.py``. The CUDA sources are
``csrc/flash_attention_fwd.cu`` (K1) and ``csrc/flash_attention_bwd.cu``
(K7 dq, K8 dk/dv). ``flash_attention`` goes through ``FlashAttention``, a
``torch.autograd.Function`` whose forward is K1 (which writes the
log-sum-exp) and whose backward is K7 and K8. Masking model: ``pos_kv <=
pos_q`` over caller-provided positions AND a kv validity mask, so one path
covers left padding, right padding and chunked prefill.

Fully masked query rows: K1 and its plain version give 0 there, where the
Pallas kernel averages the values of the key blocks it visited. The
backward masks p before the exponent, as the Pallas backward does, so such
a row contributes no gradient on either side. Neither the serving path
(every left-padded prompt has a valid key at position 0) nor a batch of
``build_train_batch`` (a right-pad query sits at the last valid position)
has such a row.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rlinf_tpu_torch.ops.cuda._build import (
    F, I, P, CudaKernel, check_cuda_tensor, dtype_code, stream_handle,
)
from rlinf_tpu_torch.ops.cuda.geometry import check_heads

NEG_INF = -2.0**30

KERNEL = CudaKernel(
    "flash_attention_fwd.cu", "flash_attention_fwd",
    [I, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, P],
)
KERNEL_DQ = CudaKernel(
    "flash_attention_bwd.cu", "flash_attention_bwd_dq",
    [I, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, P],
)
KERNEL_DKV = CudaKernel(
    "flash_attention_bwd.cu", "flash_attention_bwd_dkv",
    [I, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, P],
)


def _mask(pos_q, pos_kv, valid):
    """[B, 1, 1, Sq, Sk] bool: key visible to query."""
    m = (pos_kv[:, None, :] <= pos_q[:, :, None]) & valid.bool()[:, None, :]
    return m[:, None, None]


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
    mask = _mask(pos_q, pos_kv, valid)
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
    """K1 -> (o [B,Sq,H,D] in q's dtype, lse [B,H,Sq] f32).

    q [B,Sq,H,D], k/v [B,Sk,K,D] of one dtype: bf16, f16 or f32; pos_q
    [B,Sq] / pos_kv [B,Sk] int32; valid [B,Sk] uint8. D is 16, 32, 64 or
    128 (bf16 and f16 at 64 and 128 run the wgmma kernel, the rest its mma.sync
    form). CPU tensors run the plain version.
    """
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, pos_q, pos_kv, valid, scale)
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    check_heads("flash_attention", H, K, D)
    code = dtype_code("q", q)
    check_cuda_tensor("q", q, q.dtype, (B, Sq, H, D))
    check_cuda_tensor("k", k, q.dtype, (B, Sk, K, D))
    check_cuda_tensor("v", v, q.dtype, (B, Sk, K, D))
    check_cuda_tensor("pos_q", pos_q, torch.int32, (B, Sq))
    check_cuda_tensor("pos_kv", pos_kv, torch.int32, (B, Sk))
    check_cuda_tensor("valid", valid, torch.uint8, (B, Sk))
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    KERNEL(
        q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        pos_q.data_ptr(), pos_kv.data_ptr(), valid.data_ptr(),
        o.data_ptr(), lse.data_ptr(), B, Sq, Sk, H, K, D, code, float(scale),
        stream_handle(),
    )
    return o, lse


def _delta(o, do):
    """rowsum(o * do) in fp32 -> [B, H, Sq], as the JAX package forms it
    outside its kernels (on the card K7 forms it in its prologue)."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q, k, v, pos_q, pos_kv, valid, o, lse, do, scale):
    """Plain version of K7 and K8 -> (dq, dk, dv) in the inputs' dtypes.

    p = exp(s - lse) where unmasked, 0 elsewhere; fp32 throughout; dk/dv
    summed over the query heads of each kv head before the cast.
    """
    delta = _delta(o, do)
    B, Sq, H, D = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.float().reshape(B, Sq, K, G, D)
    dog = do.float().reshape(B, Sq, K, G, D)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, kf) * scale
    lse_g = lse.reshape(B, K, G, Sq)[..., None]
    delta_g = delta.reshape(B, K, G, Sq)[..., None]
    p = torch.where(_mask(pos_q, pos_kv, valid), torch.exp(s - lse_g), 0.0)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, vf)
    ds = p * (dp - delta_g) * scale
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf).reshape(B, Sq, H, D)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q, k, v, pos_q, pos_kv, valid, o, lse, do, scale):
    """K7 + K8 -> (dq, dk, dv) in the inputs' dtype (bf16, f16 or f32) from
    the forward's o and lse and the output gradient do. K7 forms delta =
    rowsum(o * do) itself and writes it for K8, which runs after it on the
    same stream. CPU tensors run the plain version."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, pos_q, pos_kv, valid, o, lse, do, scale)
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    check_heads("flash_attention", H, K, D)
    code = dtype_code("q", q)
    for name, t, shape in (("q", q, (B, Sq, H, D)), ("o", o, (B, Sq, H, D)),
                           ("do", do, (B, Sq, H, D)), ("k", k, (B, Sk, K, D)),
                           ("v", v, (B, Sk, K, D))):
        check_cuda_tensor(name, t, q.dtype, shape)
    check_cuda_tensor("pos_q", pos_q, torch.int32, (B, Sq))
    check_cuda_tensor("pos_kv", pos_kv, torch.int32, (B, Sk))
    check_cuda_tensor("valid", valid, torch.uint8, (B, Sk))
    check_cuda_tensor("lse", lse, torch.float32, (B, H, Sq))
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), pos_q.data_ptr(), pos_kv.data_ptr(),
              valid.data_ptr())
    dims = (B, Sq, Sk, H, K, D, code, float(scale), stream_handle())
    KERNEL_DQ(q.device.index, *common, o.data_ptr(), do.data_ptr(), lse.data_ptr(),
              delta.data_ptr(), dq.data_ptr(), *dims)
    KERNEL_DKV(q.device.index, *common, do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
               dk.data_ptr(), dv.data_ptr(), *dims)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v) through K1; dq, dk, dv through K7 and K8."""

    @staticmethod
    def forward(ctx, q, k, v, pos_q, pos_kv, valid, scale):
        o, lse = flash_attention_fwd(q, k, v, pos_q, pos_kv, valid, scale)
        ctx.save_for_backward(q, k, v, pos_q, pos_kv, valid, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, pos_q, pos_kv, valid, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, pos_q, pos_kv, valid, o, lse,
                                         do.contiguous(), ctx.scale)
        return dq, dk, dv, None, None, None, None


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
    """GQA causal flash attention. q: [B, Sq, H, D]; k/v: [B, Sk, K, D].

    Differentiable: gradients reach q, k and v through K7 and K8."""
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
    return FlashAttention.apply(
        q.contiguous(), k.contiguous(), v.contiguous(),
        positions_q.to(torch.int32).contiguous(),
        positions_kv.to(torch.int32).contiguous(),
        kv_valid_mask.to(torch.uint8).contiguous(),
        float(scale),
    )
