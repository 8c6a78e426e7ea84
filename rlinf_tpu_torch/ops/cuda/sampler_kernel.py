"""Kernel K4: fused int8 lm-head + sampling, and its plain version.

Port of ``rlinf_tpu/ops/pallas/sampler_kernel.py``; the CUDA source is
``csrc/sampler.cu``. Semantics:

  * token ~ Categorical(softmax(logits / T)) by Gumbel-max; the logprob is
    the temperature-scaled behaviour logprob of the drawn token;
  * greedy (or T == 0): argmax of the raw logits, logprob under the
    unscaled softmax;
  * no top-k / top-p: ``models/llm/sampler.py`` routes those to the plain
    logits path.

The kernel reads the lm head packed once per set of decode weights
(``pack_lm_head``): for each group of 64 vocabulary columns and each 64-deep
k-block, 4 KB laid out as the wgmma A fragments of the kernel's 128 threads
(32 contiguous bytes each), the depth padded to a multiple of 512 and the
vocabulary to a multiple of 64 with zeros. The serving paths call
``fused_lmhead_sample_packed`` on it; ``fused_lmhead_sample`` on an unpacked
``[D, V]`` head packs and then calls the packed entry.

The noise is a counter-based Philox4x32-10 keyed by (seed, row, column).
``philox_bits`` below reproduces the kernel's generator in torch integer
ops, so the kernel and its plain version draw from the same noise.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from rlinf_tpu_torch.ops.cuda._build import (
    F as C_F, I, P, U32, CudaKernel, check_cuda_tensor, dtype_code, sm_count, stream_handle,
)

# constants of csrc/sampler.cu
WARPGROUPS = 2            # WG: warpgroups of a CTA, each a partial slot
COL_GROUP = 64            # GROUP: vocab columns of a group, the M of the wgmma
DEPTH_QUANTUM = 512       # KBLK * U: the packed depth is a multiple of this
ROW_BLOCKS = (16, 32, 64)  # hidden rows staged at once: the N of the wgmma
Z_STRIDE = 68             # ZLD: f32 row stride of the transposed logits tile
SMEM_CAP = 232448         # shared memory a CTA can have on sm_90

KERNEL = CudaKernel(
    "sampler.cu", "fused_lmhead_sample",
    [I, P, P, P, P, P, P, P, I, I, I, I, I, I, I, C_F, I, U32, I, P],
)


class PackedLMHead(NamedTuple):
    """The int8 lm head in the kernel's layout (``pack_lm_head``)."""

    w: torch.Tensor       # [Vp/64, Dp/64, 4096] int8
    scale: torch.Tensor   # [Vp] f32, 0 beyond V
    D: int
    V: int

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


# Depth d = 64 kb + 16 j + 8 hi + 2 t + e and column v = 64 m + 16 w + 8 r + g
# of the padded [Dp, Vp] head; the packed byte of (m, kb) is
# ((w * 32 + 4 g + t) * 8 + 2 j + r) * 4 + 2 hi + e: thread 4 g + t of warp
# w finds, as word 2 j + r, the depths 16 j + 2 t + {0, 1, 8, 9} of column
# 16 w + g + 8 r, which are its wgmma A fragment registers of k16 step j.
_PACKED_DIMS = (5, 0, 6, 8, 3, 1, 7, 2, 4)        # (kb, j, hi, t, e, m, w, r, g) -> packed order
_UNPACKED_DIMS = (1, 5, 7, 4, 8, 0, 2, 6, 3)      # its inverse


def pack_lm_head(lm_q: torch.Tensor, lm_scale: torch.Tensor) -> PackedLMHead:
    """[D, V] int8 + per-column scale -> the kernel's packed head, on the
    same device. Once per set of decode weights, never per step: at
    Qwen2-1.5B it is a second 233 MB copy of the head."""
    D, V = lm_q.shape
    Dp = -(-D // DEPTH_QUANTUM) * DEPTH_QUANTUM
    Vp = -(-V // COL_GROUP) * COL_GROUP
    q = F.pad(lm_q, (0, Vp - V, 0, Dp - D))
    t = q.reshape(Dp // 64, 4, 2, 4, 2, Vp // 64, 4, 2, 8)
    w = t.permute(*_PACKED_DIMS).reshape(Vp // 64, Dp // 64, 4096).contiguous()
    scale = F.pad(lm_scale.reshape(V).float(), (0, Vp - V)).contiguous()
    return PackedLMHead(w, scale, D, V)


def unpack_lm_head(head: PackedLMHead) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inverse of ``pack_lm_head`` -> (lm_q [D, V], lm_scale [V])."""
    Vp64, Dp64 = head.w.shape[:2]
    t = head.w.reshape(Vp64, Dp64, 4, 8, 4, 4, 2, 2, 2)
    q = t.permute(*_UNPACKED_DIMS).reshape(Dp64 * 64, Vp64 * 64)
    return q[:head.D, :head.V], head.scale[:head.V]


def fused_lmhead_sample_packed_plain(
    hidden: torch.Tensor, head: PackedLMHead, seed: int, *,
    temperature: float = 1.0, greedy: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the packed entry: unpack, then the plain version."""
    lm_q, lm_scale = unpack_lm_head(head)
    return fused_lmhead_sample_plain(
        hidden, lm_q, lm_scale, seed, temperature=temperature, greedy=greedy)


def smem_bytes(rows: int, Dp: int, split: bool = False) -> int:
    """Shared memory of the kernel at ``rows`` staged rows (csrc smem_bytes):
    two transposed logits tiles, alignment room, the hidden block (two bf16
    blocks, hi and lo, for an f32 hidden state: ``split``)."""
    return WARPGROUPS * rows * Z_STRIDE * 4 + 1024 + rows * Dp * 2 * (2 if split else 1)


def _row_block(B: int, Dp: int, split: bool = False) -> int:
    """Hidden rows staged at once, the N of the wgmma: the fewest of 16, 32,
    64 that hold B (64 above that), or fewer where the depth does not fit."""
    fit = [n for n in ROW_BLOCKS if smem_bytes(n, Dp, split) <= SMEM_CAP]
    if not fit:
        raise ValueError(f"fused_lmhead_sample: a hidden size of {Dp} does not fit the "
                         f"kernel's shared-memory stage")
    return next((n for n in fit if n >= B), fit[-1])


def fused_lmhead_sample_packed(
    hidden: torch.Tensor,     # [B, D] bf16, f16 or f32
    head: PackedLMHead,       # from pack_lm_head
    seed: int,                # uint32 noise key for this step
    *,
    temperature: float = 1.0,
    greedy: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 on the packed head -> (token [B] int32, behaviour logprob [B] f32).

    CPU tensors run the plain version."""
    if hidden.device.type == "cpu":
        return fused_lmhead_sample_packed_plain(
            hidden, head, seed, temperature=temperature, greedy=greedy)
    greedy = greedy or temperature == 0.0
    inv_temp = 1.0 if greedy else 1.0 / temperature
    B, D = hidden.shape
    Vp64, Dp64 = head.w.shape[:2]
    Dp, Vp = Dp64 * 64, Vp64 * 64
    hdt = dtype_code("hidden", hidden)
    check_cuda_tensor("hidden", hidden, hidden.dtype, (B, head.D))
    check_cuda_tensor("lm_head packed", head.w, torch.int8, (Vp64, Dp64, 4096))
    check_cuda_tensor("lm_head scale", head.scale, torch.float32, (Vp,))
    if D % 8 or Dp % DEPTH_QUANTUM or Vp % COL_GROUP:
        raise ValueError(f"fused_lmhead_sample: D={D} must be a multiple of 8 and the "
                         f"packed head padded to {DEPTH_QUANTUM} x {COL_GROUP}")
    rb = _row_block(B, Dp, hdt == 2)
    dev = hidden.device
    grid = min(sm_count(dev.index), -(-Vp // (COL_GROUP * WARPGROUPS)))
    slots = grid * WARPGROUPS
    part_f = torch.empty((4, slots, B), dtype=torch.float32, device=dev)
    part_i = torch.empty((slots, B), dtype=torch.int32, device=dev)
    tok = torch.empty((B,), dtype=torch.int32, device=dev)
    lp = torch.empty((B,), dtype=torch.float32, device=dev)
    KERNEL(
        dev.index, hidden.data_ptr(), head.w.data_ptr(), head.scale.data_ptr(),
        part_f.data_ptr(), part_i.data_ptr(), tok.data_ptr(), lp.data_ptr(),
        B, D, Dp, head.V, Vp, grid, rb, float(inv_temp), int(greedy),
        int(seed) & 0xFFFFFFFF, hdt, stream_handle(),
    )
    return tok, lp


def fused_lmhead_sample(
    hidden: torch.Tensor,     # [B, D] bf16, f16 or f32
    lm_q: torch.Tensor,       # [D, V] int8
    lm_scale: torch.Tensor,   # [1, V] or [V] f32 per-output-channel scale
    seed: int,                # uint32 noise key for this step
    *,
    temperature: float = 1.0,
    greedy: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 -> (token [B] int32, behaviour logprob [B] f32) on an unpacked
    head: packs it (``pack_lm_head``), then runs the packed entry. The
    serving paths pack once and call ``fused_lmhead_sample_packed``.

    CPU tensors run the plain version."""
    if hidden.device.type == "cpu":
        return fused_lmhead_sample_plain(
            hidden, lm_q, lm_scale, seed, temperature=temperature, greedy=greedy)
    check_cuda_tensor("lm_q", lm_q, torch.int8, tuple(lm_q.shape))
    return fused_lmhead_sample_packed(
        hidden, pack_lm_head(lm_q, lm_scale), seed, temperature=temperature, greedy=greedy)
