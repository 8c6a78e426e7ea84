"""Kernels K5/K6: fused linear cross-entropy forward and backward, and
their plain versions.

Port of ``rlinf_tpu/ops/pallas/linear_ce.py`` (``fused_linear_ce``). The
CUDA source is ``csrc/linear_ce.cu``. Per row of ``hidden`` the target
logprob and the entropy of ``softmax(hidden @ W / T)``, differentiable,
without the [rows, V] logits in the forward. W is ``[D, V]`` ("dv") or the
tied embedding ``[V, D]`` ("vd"). Both kernels run one mainloop (wgmma fed
by TMA) over 128 x 128 logits tiles: the forward reduces each tile to its
rows' softmax statistics and a combine merges them in a fixed order
(``combine_segments``); the backward writes ``dz`` (bf16 ``[rows,
V_pad]``) and ``dh``; the weight gradient ``dz^T h`` is a plain matrix
product, as in the JAX package.

The plain versions reproduce the Pallas kernels' roundings: ``dz`` is cast
to bf16 before ``dh`` and ``dw`` are formed, and ``dh`` is cast to
``h.dtype``.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from rlinf_tpu_torch.ops.cuda._build import (
    F as C_F, I, P, CudaKernel, check_cuda_tensor, sm_count, stream_handle,
)

VOCAB_TILE = 128    # vocab columns per tile (csrc GN); dz is [rows, V_pad]
GEMM_TILE = 128     # tile rows and columns (csrc GM, GN); rows past n are masked
VOCAB_BLOCK = 64    # depth of a stage (csrc GK): pass B's slices are whole blocks
CONSUMERS = 2       # consumer warpgroups of a CTA (one CTA an SM)
MAX_SLICES = 32     # most vocab slices of K6 pass B
ROW_ALIGN = 8       # TMA row strides are multiples of 16 bytes: 8 bf16
COMBINE_SEGMENTS = 8  # K5's combine: segments of a row's tiles (csrc COMBINE_SEGS)

KERNEL_FWD = CudaKernel(
    "linear_ce.cu", "linear_ce_fwd", [I, P, P, P, P, P, P, P, I, I, I, I, I, I, C_F, P])
KERNEL_BWD = CudaKernel(
    "linear_ce.cu", "linear_ce_bwd",
    [I, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, C_F, P])


def vocab_slices(v_pad: int, n_slices: int) -> List[Tuple[int, int]]:
    """K6 pass B's cut of [0, v_pad) into ``n_slices`` runs of whole 64-blocks,
    in order (csrc decode_item: block slice * n_kb // n_slices onward)."""
    n_kb = -(-v_pad // VOCAB_BLOCK)
    edges = [s * n_kb // n_slices * VOCAB_BLOCK for s in range(n_slices + 1)]
    edges[-1] = v_pad
    return list(zip(edges[:-1], edges[1:]))


def combine_segments(n_tiles: int) -> List[Tuple[int, int]]:
    """K5's combine order: the runs of a row's vocabulary tiles that its
    threads merge, each in tile order, before the runs are merged in order
    (csrc ce_fwd_combine_kernel). Runs may be empty when n_tiles < 8."""
    edges = [s * n_tiles // COMBINE_SEGMENTS for s in range(COMBINE_SEGMENTS + 1)]
    return list(zip(edges[:-1], edges[1:]))


def dh_slices(n: int, D: int, v_pad: int, sms: int) -> int:
    """Vocab slices of K6 pass B: the fewest that make tiles x slices fill
    whole rounds of the card's consumers (two an SM), else the least idle
    share of the last round. Each slice keeps at least one 64-block."""
    tiles = -(-n // GEMM_TILE) * -(-D // GEMM_TILE)
    slots = CONSUMERS * sms
    best, best_waste = 1, None
    for s in range(1, min(MAX_SLICES, -(-v_pad // VOCAB_BLOCK)) + 1):
        items = tiles * s
        waste = -(-items // slots) * slots / items
        if best_waste is None or waste < best_waste - 1e-12:
            best, best_waste = s, waste
        if items % slots == 0:
            break
    return best


def _vocab(w: torch.Tensor, w_layout: str) -> int:
    return w.shape[1] if w_layout == "dv" else w.shape[0]


def _v_pad(v: int) -> int:
    return -(-v // VOCAB_TILE) * VOCAB_TILE


def _logits_plain(h2, w, w_layout, inv_temp):
    wf = w.float() if w_layout == "dv" else w.float().t()
    return (h2.float() @ wf) * inv_temp


def ce_forward_plain(h2, w, tgt, inv_temp: float, w_layout: str):
    """Plain version of K5 -> (lp, ent, lse), each f32 [n]."""
    x = _logits_plain(h2, w, w_layout, inv_temp)
    lse = torch.logsumexp(x, dim=-1)
    lp = x.gather(1, tgt.long()[:, None])[:, 0] - lse
    ent = lse - (torch.softmax(x, dim=-1) * x).sum(-1)
    return lp, ent, lse


def ce_backward_plain(h2, w, tgt, lse, mu, g_lp, g_ent, inv_temp: float, w_layout: str):
    """Plain version of K6 -> (dz bf16 [n, V_pad], dh [n, D] in h2.dtype)."""
    V = _vocab(w, w_layout)
    x = _logits_plain(h2, w, w_layout, inv_temp)
    p = torch.exp(x - lse[:, None])
    onehot = torch.zeros_like(x).scatter_(1, tgt.long()[:, None], 1.0)
    dx = g_lp[:, None] * (onehot - p) - g_ent[:, None] * (p * (x - mu[:, None]))
    dz = (dx * inv_temp).bfloat16()
    wf = w.float().t() if w_layout == "dv" else w.float()
    dh = (dz.float() @ wf).to(h2.dtype)
    return F.pad(dz, (0, _v_pad(V) - V)), dh


def pad_depth(h2, w, w_layout: str):
    """(h2, w) with the depth D zero-padded to a multiple of ``ROW_ALIGN``,
    as the tensor maps need. Exact: a zero depth column adds nothing to
    any logit, and the pad columns of dh are sliced off."""
    pad = (-h2.shape[1]) % ROW_ALIGN
    if not pad:
        return h2, w
    w = F.pad(w, (0, 0, 0, pad)) if w_layout == "dv" else F.pad(w, (0, pad))
    return F.pad(h2, (0, pad)), w


def _check_inputs(h2, w, tgt, w_layout):
    n, D = h2.shape
    V = _vocab(w, w_layout)
    check_cuda_tensor("hidden", h2, torch.bfloat16, (n, D))
    check_cuda_tensor("w", w, torch.bfloat16, (D, V) if w_layout == "dv" else (V, D))
    check_cuda_tensor("target_ids", tgt, torch.int32, (n,))
    return n, D, V


def _tma_operands(h2, w, w_layout: str, V: int):
    """(h2, w) as the tensor maps take them. Any D and V: the depth is
    zero-padded to a multiple of 8 (``pad_depth``), and an untied ``[D, V]``
    weight with V % 8 != 0 is copied into rows of a multiple of 8 whose
    stride the kernels take apart from V (they read V columns of each, so
    the pad columns stay masked like those past V). Either padding copies
    the whole weight (and the depth padding h2) on every call: a
    configuration with D % 8 != 0, or an untied weight with V % 8 != 0,
    pays one [V, D] copy per call; D = 1536, V = 151936 pay none."""
    h2p, wp = pad_depth(h2, w, w_layout)
    if w_layout == "dv" and V % ROW_ALIGN:
        wp = F.pad(wp, (0, (-V) % ROW_ALIGN))
    return h2p, wp


def ce_forward(h2, w, tgt, inv_temp: float, w_layout: str):
    """K5 -> (lp, ent, lse) f32 [n]. h2 [n, D] bf16, tgt [n] int32; any n
    (the kernels mask rows past n), D and V (``_tma_operands``). CPU tensors run the
    plain version. The tiles' f32 statistics take 16 x n x ceil(V / 128)
    bytes of scratch (78 MB at 4096 rows, V = 151936)."""
    if h2.device.type == "cpu":
        return ce_forward_plain(h2, w, tgt, inv_temp, w_layout)
    n, _, V = _check_inputs(h2, w, tgt, w_layout)
    h2p, wp = _tma_operands(h2, w, w_layout, V)
    dev = h2.device
    part = torch.empty((4, -(-V // VOCAB_TILE), n), dtype=torch.float32, device=dev)
    lp, ent, lse = (torch.empty((n,), dtype=torch.float32, device=dev) for _ in range(3))
    KERNEL_FWD(
        dev.index, h2p.data_ptr(), wp.data_ptr(), tgt.data_ptr(), part.data_ptr(),
        lp.data_ptr(), ent.data_ptr(), lse.data_ptr(), n, h2p.shape[1], V, wp.shape[1],
        int(w_layout == "vd"), sm_count(dev.index), float(inv_temp), stream_handle(),
    )
    return lp, ent, lse


def ce_backward(h2, w, tgt, lse, mu, g_lp, g_ent, inv_temp: float, w_layout: str):
    """K6 -> (dz bf16 [n, V_pad], dh bf16 [n, D]). CPU tensors run the plain
    version. Any D and V, as K5 (``_tma_operands``). Pass B's f32 partials
    take ``dh_slices`` x n x D x 4 bytes of scratch (277 MB at 4096 rows,
    D = 1536, 11 slices)."""
    if h2.device.type == "cpu":
        return ce_backward_plain(h2, w, tgt, lse, mu, g_lp, g_ent, inv_temp, w_layout)
    n, D, V = _check_inputs(h2, w, tgt, w_layout)
    for name, t in (("lse", lse), ("mu", mu), ("g_lp", g_lp), ("g_ent", g_ent)):
        check_cuda_tensor(name, t, torch.float32, (n,))
    h2p, wp = _tma_operands(h2, w, w_layout, V)
    Dp = h2p.shape[1]
    vp = _v_pad(V)
    dev = h2.device
    sms = sm_count(dev.index)
    n_slices = dh_slices(n, Dp, vp, sms)
    dz = torch.empty((n, vp), dtype=torch.bfloat16, device=dev)
    dh = torch.empty((n, Dp), dtype=torch.bfloat16, device=dev)
    part = torch.empty((n_slices, n, Dp), dtype=torch.float32, device=dev)
    KERNEL_BWD(
        dev.index, h2p.data_ptr(), wp.data_ptr(), tgt.data_ptr(), lse.data_ptr(),
        mu.data_ptr(), g_lp.data_ptr(), g_ent.data_ptr(), dz.data_ptr(), dh.data_ptr(),
        part.data_ptr(), n, Dp, V, vp, wp.shape[1], int(w_layout == "vd"), n_slices, sms,
        float(inv_temp), stream_handle(),
    )
    if Dp != D:
        dh = dh[:, :D].contiguous()
    return dz, dh


def weight_grad(h2, dz, w_layout: str, V: int, dtype) -> torch.Tensor:
    """dw from the saved dz, one plain matrix product with an f32 sum
    (cuBLAS accumulates bf16 products in f32; on the CPU the operands are
    widened first)."""
    dzv = dz[:, :V]
    if not h2.is_cuda:
        h2, dzv = h2.float(), dzv.float()
    g = h2.t() @ dzv if w_layout == "dv" else dzv.t() @ h2
    return g.to(dtype)


class LinearCE(torch.autograd.Function):
    """(lp, ent) of one chunk of rows through K5, gradients through K6."""

    @staticmethod
    def forward(ctx, h2, w, tgt, inv_temp, w_layout):
        lp, ent, lse = ce_forward(h2, w, tgt, inv_temp, w_layout)
        ctx.save_for_backward(h2, w, tgt, lse, ent)
        ctx.inv_temp, ctx.w_layout = inv_temp, w_layout
        return lp, ent

    @staticmethod
    def backward(ctx, g_lp, g_ent):
        h2, w, tgt, lse, ent = ctx.saved_tensors
        g_lp = torch.zeros_like(lse) if g_lp is None else g_lp.float().contiguous()
        g_ent = torch.zeros_like(lse) if g_ent is None else g_ent.float().contiguous()
        dz, dh = ce_backward(h2, w, tgt, lse, lse - ent, g_lp, g_ent, ctx.inv_temp,
                             ctx.w_layout)
        dw = weight_grad(h2, dz, ctx.w_layout, _vocab(w, ctx.w_layout), w.dtype)
        return dh, dw, None, None, None


def fused_linear_ce(
    hidden: torch.Tensor,      # [B, S, D] (or [N, D])
    w: torch.Tensor,           # [D, V] ("dv") or [V, D] ("vd", tied embedding)
    target_ids: torch.Tensor,  # [B, S] (or [N]) int
    *,
    temperature: float = 1.0,
    w_layout: str = "dv",
    row_chunk: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logprob of target, entropy) per position, f32, differentiable.

    Above ``row_chunk`` rows they run in chunks of ``row_chunk``, which
    bounds the backward's ``dz`` (bf16 [rows, V], about 0.3 GB per 1k rows
    at a 152k vocab); autograd sums the per-chunk ``dw``.
    """
    if w_layout not in ("dv", "vd"):
        raise ValueError(f"w_layout must be dv or vd, got {w_layout!r}")
    lead = hidden.shape[:-1]
    h2 = hidden.reshape(-1, hidden.shape[-1])
    tgt = target_ids.reshape(-1).to(torch.int32)
    inv_temp = 1.0 / temperature
    lps, ents = [], []
    for hc, tc in zip(h2.split(row_chunk), tgt.split(row_chunk)):
        lp, ent = LinearCE.apply(hc.contiguous(), w.contiguous(), tc.contiguous(), inv_temp,
                                 w_layout)
        lps.append(lp)
        ents.append(ent)
    return torch.cat(lps).reshape(lead), torch.cat(ents).reshape(lead)
