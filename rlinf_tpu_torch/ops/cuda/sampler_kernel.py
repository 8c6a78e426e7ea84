"""Kernel K4: fused int8 lm-head + sampling, and its plain version.

Port of ``rlinf_tpu/ops/pallas/sampler_kernel.py``; the CUDA source is
``csrc/sampler.cu``. Semantics:

  * token ~ Categorical(softmax(logits / T)) by Gumbel-max; the logprob is
    the temperature-scaled behaviour logprob of the drawn token;
  * greedy (or T == 0): argmax of the raw logits, logprob under the
    unscaled softmax;
  * no top-k / top-p: ``models/llm/sampler.py`` routes those to the plain
    logits path.

The noise is a counter-based Philox4x32-10 keyed by (seed, row, column).
``philox_bits`` below reproduces the kernel's generator in torch integer
ops, so the kernel and its plain version draw from the same noise.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rlinf_tpu_torch.ops.cuda._build import (
    F, I, P, U32, CudaKernel, check_cuda_tensor, stream_handle,
)

VOCAB_TILE = 128  # columns per CTA of the tile pass (csrc/sampler.cu VT)

KERNEL = CudaKernel(
    "sampler.cu", "fused_lmhead_sample",
    [I, P, P, P, P, P, P, P, I, I, I, F, I, U32, P],
)

_MASK32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of m * x for x in [0, 2**32), in int64.

    The product needs 64 unsigned bits, so it is formed from 16-bit halves
    of x: m * x = a * 2**16 + c with a, c < 2**48.
    """
    a = m * (x >> 16)
    c = m * (x & 0xFFFF)
    hi = (a + (c >> 16)) >> 16
    lo = (((a & 0xFFFF) << 16) + c) & _MASK32
    return hi, lo


def philox_bits(seed: int, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Philox4x32-10 first output word for counters (col, row, 0, 0) and key
    (seed, 0), as int64 in [0, 2**32). rows/cols broadcast together."""
    c0, c1 = torch.broadcast_tensors(cols.long(), rows.long())
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    k0, k1 = seed & _MASK32, 0
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & _MASK32
            k1 = (k1 + _PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0


def gumbel_noise(seed: int, batch: int, vocab: int, device) -> torch.Tensor:
    """[batch, vocab] f32 Gumbel noise of the kernel's generator: 23 mantissa
    bits -> u in [0, 1), clamped at 1e-10, then -log(-log u)."""
    rows = torch.arange(batch, device=device)[:, None]
    cols = torch.arange(vocab, device=device)[None, :]
    bits = philox_bits(seed, rows, cols)
    u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    u = u.clamp_min(1e-10)
    return -torch.log(-torch.log(u))


def fused_lmhead_sample_plain(
    hidden: torch.Tensor, lm_q: torch.Tensor, lm_scale: torch.Tensor,
    seed: int, *, temperature: float = 1.0, greedy: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4 -> (token [B] int32, logprob [B] f32)."""
    greedy = greedy or temperature == 0.0
    inv_temp = 1.0 if greedy else 1.0 / temperature
    B = hidden.shape[0]
    V = lm_q.shape[1]
    z = (hidden.float() @ lm_q.float()) * lm_scale.reshape(1, V).float() * inv_temp
    score = z if greedy else z + gumbel_noise(seed, B, V, z.device)
    tok = score.argmax(dim=-1)
    lp = z.gather(1, tok[:, None])[:, 0] - torch.logsumexp(z, dim=-1)
    return tok.to(torch.int32), lp


def fused_lmhead_sample(
    hidden: torch.Tensor,     # [B, D] bf16
    lm_q: torch.Tensor,       # [D, V] int8
    lm_scale: torch.Tensor,   # [1, V] or [V] f32 per-output-channel scale
    seed: int,                # uint32 noise key for this step
    *,
    temperature: float = 1.0,
    greedy: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 -> (token [B] int32, behaviour logprob [B] f32).

    CPU tensors run the plain version."""
    if hidden.device.type == "cpu":
        return fused_lmhead_sample_plain(
            hidden, lm_q, lm_scale, seed, temperature=temperature, greedy=greedy)
    greedy = greedy or temperature == 0.0
    inv_temp = 1.0 if greedy else 1.0 / temperature
    B, D = hidden.shape
    V = lm_q.shape[1]
    lm_scale = lm_scale.reshape(V)
    check_cuda_tensor("hidden", hidden, torch.bfloat16, (B, D))
    check_cuda_tensor("lm_q", lm_q, torch.int8, (D, V))
    check_cuda_tensor("lm_scale", lm_scale, torch.float32, (V,))
    n_tiles = -(-V // VOCAB_TILE)
    part_f = torch.empty((4, n_tiles, B), dtype=torch.float32, device=hidden.device)
    part_i = torch.empty((n_tiles, B), dtype=torch.int32, device=hidden.device)
    tok = torch.empty((B,), dtype=torch.int32, device=hidden.device)
    lp = torch.empty((B,), dtype=torch.float32, device=hidden.device)
    KERNEL(
        hidden.device.index, hidden.data_ptr(), lm_q.data_ptr(),
        lm_scale.data_ptr(), part_f.data_ptr(), part_i.data_ptr(),
        tok.data_ptr(), lp.data_ptr(), B, D, V, float(inv_temp), int(greedy),
        int(seed) & 0xFFFFFFFF, stream_handle(),
    )
    return tok, lp
