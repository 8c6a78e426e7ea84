#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rlinf_tpu_torch``) on one GPU:
the rollout serving paths (static, megakernel, continuous and paged
engines) and the GRPO training path.

    python3 chip_smoke.py [--seed 0]

Phases, each printing one JSON line:

1. build: compile every kernel of ``rlinf_tpu_torch/csrc`` with nvcc
   (sm_90a), all sources at once, and report the seconds.
2. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the shapes of the main path (Qwen2-1.5B, 64 prompts of up
   to 512 tokens, 256 new tokens): error against a stated tolerance, the
   kernel's, the plain version's and one library call's time (CUDA events),
   and the least time the card could take (bytes or operations at the
   card's published peak).
3. main path: ``build_rollout_engine`` (static engine, int8 weights,
   hand-written kernels, bf16 packed KV cache) rolls out 64 prompts of
   128-512 tokens to 256 new tokens at the full width and depth of
   Qwen2-1.5B with random weights from --seed; then ``generate`` with the
   int8 KV cache on the same prompts. Launch counts are zeroed before and
   read after each run and must show every kernel of that run.
4. greedy check: a 16-token greedy run at Qwen2-1.5B for each KV-cache
   type in which every kernel call is checked against its plain version
   on the same inputs (token agreement > 0.95, logprob error < 0.15,
   attention error < 2e-2); whole-run agreement with the plain path is
   reported. Then whole 16-token greedy runs, kernels against plain, at
   the small configuration of the JAX package's check_q8_generate, with
   its bar (agreement > 0.95, logprob error < 0.15). Then a profile of a
   few decode steps.

5. training kernels: K5/K6 (fused linear cross-entropy) at one row chunk
   of the training path (4096 rows, tied [V, D] embedding, non-zero
   entropy gradient) and K7/K8 (flash-attention backward) at one
   microbatch of the training batch (16 right-padded rows, T=768), each
   against its plain version with a stated tolerance and timed beside its
   bound, its plain version and a library call.
6. training path: GRPO on phase 3's rollout (64 rows as 8 groups of 8,
   a stated reward rule on the token ids), ``build_train_batch`` (T=768),
   ``make_logprob_fn`` (recompute), then two ``make_policy_train_step``
   calls at full width and depth (remat, attn_impl="pallas", 4
   microbatches, adamw with master weights, entropy bonus 1e-3). Gates:
   every training kernel launched, finite loss and grad norm, step-1
   |approx_kl| < 1e-3, params moved. A third step runs under the profiler.
7. whole-step check: one train step at check_q8_generate's configuration,
   kernels against the plain path from the same params.

Between phases 4 and 5, the megakernel, continuous and paged paths:

8. engine kernels: K10 (paged attention; 64 rows, 48 pages of 16 tokens a
   row, ragged lengths with a 0) and K9 (the whole-step decode megakernel
   on Qwen2-1.5B packed weights and a random int8 cache: a small shape
   first, then B=64, S=768 with one write slot and with per-row slots, and
   B=8), each against its plain version with stated limits, timed beside
   its bound; K10 beside scaled_dot_product_attention, K9 beside the
   device-busy time of one per-layer int8-KV decode step.
9. megakernel generate: ``generate(kv_quant="int8", mega=...)`` on phase
   3's prompts; launch gate K9 = 255, K3 = 0, K1 = 28, K4 = 256; the idle
   share of a decode step.
10. engine shadow: a 16-token greedy ``generate(mega=)`` and a 16-token
   paged-engine run at full size with every K9 / K10 call checked against
   its plain version on the same inputs.
11. engines: on one long-tail mix (128 requests, prompts of 128-512 tokens,
   budgets of 32-256 tokens, no eos) the continuous engine through
   ``build_rollout_engine(engine="auto")`` with the per-layer kernels, the
   continuous engine with ``use_mega="auto"`` and the fused sampler (both
   cache layouts must be seen, K9 launched with per-row write slots), and
   the paged engine (K10 = layers x decode steps, page pool empty at the
   end). Every request must be answered with exactly its budget.
12. engine small checks: whole greedy runs at the configurations of the
   JAX package's on-chip gates (check_megakernel_generate,
   check_mega_engine, check_paged_kernel, paged against dense engine),
   kernels against plain paths from the same params, with their bars.

The last lines are the GPU's name and power limit (nvidia-smi), one JSON
line with every kernel's figures, and ``{"ok": true, "device": ...}``.
Any failure raises: the script exits non-zero and prints no result. It
imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

# Published dense peaks (NVIDIA data sheets): memory bytes/s, bf16 FLOP/s.
PEAKS = {
    "H100 SXM": (3.35e12, 989e12),
    "H100 PCIe": (2.0e12, 756e12),
    "H100 NVL": (3.9e12, 835e12),
    "H200": (4.8e12, 989e12),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def card_peaks(name: str):
    for key, label in (("PCIe", "H100 PCIe"), ("NVL", "H100 NVL"), ("H200", "H200")):
        if key in name:
            return label, PEAKS[label]
    return "H100 SXM", PEAKS["H100 SXM"]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one call: CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, peaks):
    bw, fl = peaks
    t_bytes, t_ops = nbytes / bw * 1e3, flops / fl * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class Rotation:
    """Cycle through copies of a kernel's inputs so that repeated timing
    calls do not find them in the 50 MB L2 cache."""

    def __init__(self, make, copies: int):
        self.sets = [make() for _ in range(copies)]
        self.i = 0

    def next(self):
        self.i = (self.i + 1) % len(self.sets)
        return self.sets[self.i]


# ---------------------------------------------------------------------------
# Phase 2: every kernel against its plain version
# ---------------------------------------------------------------------------

def check_kernels(cfg, B, P, N, prompt_lens, peaks, seed):
    from rlinf_tpu_torch.models.llm.quant import quantize_tensor
    from rlinf_tpu_torch.ops.cuda import decode_attention as DA
    from rlinf_tpu_torch.ops.cuda import flash_attention as FA
    from rlinf_tpu_torch.ops.cuda import sampler_kernel as SK

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    H, Kv, Hd, D, V = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_, cfg.hidden_size, cfg.vocab_size
    G = H // Kv
    S_max = P + N
    plen = torch.as_tensor(prompt_lens, device=dev, dtype=torch.int32)
    results = []

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    # --- K1: prefill flash attention, [B, P] left-padded --------------------
    valid = torch.arange(P, device=dev)[None, :] >= (P - plen)[:, None]
    pos = (valid.to(torch.int32).cumsum(-1) - 1).clamp_min(0).to(torch.int32)
    valid_u8 = valid.to(torch.uint8)
    rot = Rotation(lambda: (randn(B, P, H, Hd), randn(B, P, Kv, Hd), randn(B, P, Kv, Hd)), 3)
    q, k, v = rot.sets[0]
    scale = Hd**-0.5
    o, lse = FA.flash_attention_fwd(q, k, v, pos, pos, valid_u8, scale)
    o_ref, lse_ref = FA.flash_attention_fwd_plain(q, k, v, pos, pos, valid_u8, scale)
    torch.cuda.synchronize()
    err = (o.float() - o_ref.float()).abs().max().item()
    lse_err = (lse - lse_ref).abs().max().item()
    ms = cuda_ms(lambda: FA.flash_attention_fwd(*rot.next(), pos, pos, valid_u8, scale), 10)
    plain_ms = cuda_ms(lambda: FA.flash_attention_fwd_plain(q, k, v, pos, pos, valid_u8, scale), 3)
    mask4 = ((pos[:, None, :] <= pos[:, :, None]) & valid[:, None, :])[:, None]
    qt, kt, vt = (q.transpose(1, 2), k.repeat_interleave(G, 2).transpose(1, 2),
                  v.repeat_interleave(G, 2).transpose(1, 2))
    lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask4), 5)
    pairs = int(mask4.sum().item())
    b_ms, b_by = bound(nbytes(q, k, v, pos, pos, valid_u8, o, lse), 4.0 * Hd * H * pairs, peaks)
    results.append(dict(
        name="flash_attention_fwd", route="cuda",
        source="rlinf_tpu_torch/csrc/flash_attention_fwd.cu",
        replaces="rlinf_tpu/ops/pallas/flash_attention.py:166",
        shapes=f"q[{B},{P},{H},{Hd}] k/v[{B},{P},{Kv},{Hd}] bf16",
        max_abs_err=err, lse_max_abs_err=lse_err, tolerance=2e-2,
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms, library="scaled_dot_product_attention",
        bound_ms=b_ms, bound_by=b_by))
    if not err < 2e-2 or not lse_err < 2e-2:
        raise AssertionError(f"K1 disagrees with its plain version: {err} (lse {lse_err})")
    del rot, q, k, v, o, o_ref, qt, kt, vt, mask4

    # --- K2/K3: decode attention over [B, S_max] packed caches, mid decode --
    starts = (P - plen).to(torch.int32)
    lengths = torch.full((B,), P + N // 2 + 1, dtype=torch.int32, device=dev)
    slots = int((lengths - starts).sum().item())
    KD = Kv * Hd
    pos_s = torch.arange(S_max, device=dev)
    valid_s = (pos_s[None, :] >= starts[:, None]) & (pos_s[None, :] < lengths[:, None])
    smask = valid_s[:, None, None, :]

    def sdpa_decode(qd, kd, vd):
        kk = kd.reshape(B, S_max, Kv, Hd).repeat_interleave(G, 2).transpose(1, 2)
        vv = vd.reshape(B, S_max, Kv, Hd).repeat_interleave(G, 2).transpose(1, 2)
        qq = qd[:, :, None, :]
        return lambda: torch.nn.functional.scaled_dot_product_attention(qq, kk, vv, attn_mask=smask)

    rot = Rotation(lambda: (randn(B, H, Hd), randn(B, S_max, KD, scale=0.5),
                            randn(B, S_max, KD, scale=0.5)), 4)
    qd, kc, vc = rot.sets[0]
    out = DA.decode_attention_packed(qd, kc, vc, starts, lengths, num_kv=Kv)
    ref = DA.decode_attention_packed_xla(qd, kc, vc, starts, lengths, num_kv=Kv)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    ms = cuda_ms(lambda: DA.decode_attention_packed(*rot.next(), starts, lengths, num_kv=Kv), 50)
    plain_ms = cuda_ms(lambda: DA.decode_attention_packed_xla(
        qd, kc, vc, starts, lengths, num_kv=Kv), 10)
    lib_ms = cuda_ms(sdpa_decode(qd, kc, vc), 20)
    b_ms, b_by = bound(nbytes(qd, starts, lengths, out) + 2 * slots * KD * 2,
                       4.0 * Hd * H * slots, peaks)
    results.append(dict(
        name="decode_attention_bf16", route="cuda",
        source="rlinf_tpu_torch/csrc/decode_attention.cu",
        replaces="rlinf_tpu/ops/pallas/decode_attention.py:200",
        shapes=f"q[{B},{H},{Hd}] cache[{B},{S_max},{KD}] bf16, {slots} valid slots",
        max_abs_err=err, tolerance=2e-2, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        library="scaled_dot_product_attention", bound_ms=b_ms, bound_by=b_by))
    if not err < 2e-2:
        raise AssertionError(f"K2 disagrees with its plain version: {err}")

    def q8_set():
        qq, kk, vv = randn(B, H, Hd), randn(B, S_max, KD, scale=0.5), randn(B, S_max, KD, scale=0.5)
        kq, ks = DA.quantize_kv_token(kk)
        vq, vs = DA.quantize_kv_token(vv)
        return qq, kq, vq, ks, vs

    rot = Rotation(q8_set, 4)
    qd, kq, vq, ks, vs = rot.sets[0]
    out = DA.decode_attention_packed_q8(qd, kq, vq, ks, vs, starts, lengths, num_kv=Kv)
    ref = DA.decode_attention_packed_q8_xla(qd, kq, vq, ks, vs, starts, lengths, num_kv=Kv)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    ms = cuda_ms(lambda: DA.decode_attention_packed_q8(*rot.next(), starts, lengths, num_kv=Kv), 50)
    plain_ms = cuda_ms(lambda: DA.decode_attention_packed_q8_xla(
        qd, kq, vq, ks, vs, starts, lengths, num_kv=Kv), 10)
    kdq = (kq.float() * ks[..., None]).bfloat16()
    vdq = (vq.float() * vs[..., None]).bfloat16()
    lib_ms = cuda_ms(sdpa_decode(qd, kdq, vdq), 20)
    b_ms, b_by = bound(nbytes(qd, starts, lengths, out) + 2 * slots * (KD + 4),
                       4.0 * Hd * H * slots, peaks)
    results.append(dict(
        name="decode_attention_q8", route="cuda",
        source="rlinf_tpu_torch/csrc/decode_attention.cu",
        replaces="rlinf_tpu/ops/pallas/decode_attention.py:418",
        shapes=f"q[{B},{H},{Hd}] cache[{B},{S_max},{KD}] int8 + scales, {slots} valid slots",
        max_abs_err=err, tolerance=2e-2, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        library="scaled_dot_product_attention on dequantized bf16", bound_ms=b_ms, bound_by=b_by))
    if not err < 2e-2:
        raise AssertionError(f"K3 disagrees with its plain version: {err}")
    del rot, kdq, vdq

    # --- K4: fused int8 lm-head sampler at [B, D] x [D, V] -------------------
    hidden = randn(B, D)
    lm = quantize_tensor(randn(D, V, scale=0.02, dtype=torch.float32))
    lm_q, lm_s = lm.q, lm.scale
    tok, lp = SK.fused_lmhead_sample(hidden, lm_q, lm_s, 3, greedy=True)
    tok_r, lp_r = SK.fused_lmhead_sample_plain(hidden, lm_q, lm_s, 3, greedy=True)
    tok_s, lp_s = SK.fused_lmhead_sample(hidden, lm_q, lm_s, 11, temperature=0.9)
    tok_sr, _ = SK.fused_lmhead_sample_plain(hidden, lm_q, lm_s, 11, temperature=0.9)
    z = (hidden.float() @ lm_q.float()) * lm_s.reshape(1, V) / 0.9
    lp_given = torch.log_softmax(z, -1).gather(1, tok_s.long()[:, None])[:, 0]
    torch.cuda.synchronize()
    greedy_agree = (tok == tok_r).float().mean().item()
    err = (lp - lp_r).abs().max().item()
    sampled_lp_err = (lp_s - lp_given).abs().max().item()
    sampled_agree = (tok_s == tok_sr).float().mean().item()
    ms = cuda_ms(lambda: SK.fused_lmhead_sample(hidden, lm_q, lm_s, 5, temperature=1.0), 10)
    plain_ms = cuda_ms(lambda: SK.fused_lmhead_sample_plain(
        hidden, lm_q, lm_s, 5, temperature=1.0), 3)
    lm_bf16 = (lm_q.float() * lm_s).bfloat16()

    def library():
        logits = torch.matmul(hidden, lm_bf16).float()
        return torch.log_softmax(logits, -1), logits.argmax(-1)

    lib_ms = cuda_ms(library, 10)
    b_ms, b_by = bound(nbytes(hidden, lm_q, lm_s, tok, lp), 2.0 * B * D * V, peaks)
    results.append(dict(
        name="fused_lmhead_sample", route="cuda", source="rlinf_tpu_torch/csrc/sampler.cu",
        replaces="rlinf_tpu/ops/pallas/sampler_kernel.py:167",
        shapes=f"hidden[{B},{D}] bf16 lm_q[{D},{V}] int8",
        max_abs_err=err, tolerance=5e-3, greedy_token_agreement=greedy_agree,
        sampled_token_agreement=sampled_agree, sampled_logprob_err=sampled_lp_err,
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        library="matmul(bf16) + log_softmax + argmax", bound_ms=b_ms, bound_by=b_by))
    if greedy_agree != 1.0 or not err < 5e-3 or not sampled_lp_err < 5e-3:
        raise AssertionError(
            f"K4 disagrees with its plain version: greedy agreement {greedy_agree}, "
            f"lp err {err}, sampled lp err {sampled_lp_err}")
    return results


def rel_err(a, b) -> float:
    """max |a - b| over max |b|."""
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


# ---------------------------------------------------------------------------
# Phase 8: the paged-attention kernel and the decode megakernel
# ---------------------------------------------------------------------------

def random_q8_cache(L, B, S, KD, gen):
    """A random plausible stacked int8 cache (values in +-80, scales of the
    size that unit-variance keys give)."""
    dev = gen.device
    kc = torch.randint(-80, 81, (L, B, S, KD), generator=gen, device=dev, dtype=torch.int8)
    vc = torch.randint(-80, 81, (L, B, S, KD), generator=gen, device=dev, dtype=torch.int8)
    ks = torch.rand((L, B, S), generator=gen, device=dev) * 0.02 + 0.005
    vs = torch.rand((L, B, S), generator=gen, device=dev) * 0.02 + 0.005
    return kc, vc, ks, vs


def mega_case(MK, plan, mw, cfg, qparams, B, S, wp, positions, starts, gen):
    """One K9 launch against the plain version on the same inputs ->
    (errors, the inputs for timing). ``wp`` is an int or a [B] tensor."""
    from rlinf_tpu_torch.ops.rope import rope_frequencies

    dev = gen.device
    cache = random_q8_cache(plan.L, B, S, plan.KVD, gen)
    tok = torch.randint(0, cfg.vocab_size, (B,), generator=gen, device=dev)
    x0 = qparams["embed"][tok].to(torch.bfloat16)
    cos, sin = rope_frequencies(cfg.head_dim_, cfg.max_seq_len, cfg.rope_theta, dev)
    args = (x0, wp, positions, starts, cos, sin)
    before = [t.clone() for t in cache]
    ref_cache = [t.clone() for t in cache]
    hid, kc, vc, ks, vs = MK.decode_step_mega(plan, mw, x0, *cache, wp, positions, starts, cos, sin)
    torch.cuda.synchronize()
    ref, rkc, rvc, rks, rvs = MK.decode_step_mega_plain(
        plan, mw, x0, *ref_cache, wp, positions, starts, cos, sin)
    rows = torch.arange(B, device=dev)
    slot = (wp if torch.is_tensor(wp) else torch.full((B,), wp, device=dev)).long()
    deq = lambda c, s: c[:, rows, slot].float() * s[:, rows, slot][..., None]
    errs = {"hidden_rel": rel_err(hid, ref), "k_rel": rel_err(deq(kc, ks), deq(rkc, rks)),
            "v_rel": rel_err(deq(vc, vs), deq(rvc, rvs)),
            "hidden_abs": (hid.float() - ref.float()).abs().max().item(),
            "finite": bool(torch.isfinite(hid.float()).all())}
    # every slot but the written one is bit-equal to the input
    untouched = True
    for new, old in zip((kc, vc, ks, vs), before):
        old[:, rows, slot] = new[:, rows, slot]
        untouched = untouched and bool(torch.equal(new, old))
    errs["other_slots_untouched"] = untouched
    return errs, cache, args


def check_new_kernels(cfg, qparams, peaks, seed):
    """K10 at the paged engine's shapes (64 rows, 48 pages of 16 tokens a
    row, ragged lengths with a 0) and K9 on Qwen2-1.5B packed weights and a
    random int8 cache: first at a small shape (a grid that does not fit
    deadlocks rather than errs), then B=64, S=768 with one write slot and
    with ragged per-row slots, and once at B=8."""
    from rlinf_tpu_torch.models.llm import model as M
    from rlinf_tpu_torch.models.llm.config import LLMConfig
    from rlinf_tpu_torch.models.llm.quant import quantize_params
    from rlinf_tpu_torch.ops.cuda import decode_megakernel as MK
    from rlinf_tpu_torch.ops.cuda import paged_attention as PA

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 40)
    H, Kv, Hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    G = H // Kv
    results = []

    # --- K10 -----------------------------------------------------------------
    B, Pg, max_pages = 64, 16, 48
    num_pages = 1 + B * max_pages
    lengths = torch.randint(1, max_pages * Pg + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    lengths[3] = 0
    lengths[5] = max_pages * Pg
    table = torch.zeros((B, max_pages), dtype=torch.int32, device=dev)
    perm = (torch.randperm(num_pages - 1, generator=g, device=dev) + 1).to(torch.int32)
    used = (lengths + Pg - 1) // Pg
    at = 0
    for b in range(B):
        n = int(used[b])
        table[b, :n] = perm[at:at + n]
        at += n

    def pools():
        return tuple((torch.randn((num_pages, Kv, Pg, Hd), generator=g, device=dev) * 0.5
                      ).to(torch.bfloat16) for _ in range(2))

    rot = Rotation(pools, 3)
    kp, vp = rot.sets[0]
    q = torch.randn((B, H, Hd), generator=g, device=dev).to(torch.bfloat16)
    out = PA.paged_attention(q, kp, vp, table, lengths)
    ref = PA.paged_attention_xla(q, kp, vp, table, lengths)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    empty_row = out[3].float().abs().max().item()
    ms = cuda_ms(lambda: PA.paged_attention(q, *rot.next(), table, lengths), 50)
    plain_ms = cuda_ms(lambda: PA.paged_attention_xla(q, kp, vp, table, lengths), 10)
    S = max_pages * Pg
    dense = lambda p: p[table.long()].permute(0, 2, 1, 3, 4).reshape(B, Kv, S, Hd)
    kd = dense(kp).repeat_interleave(G, 1)
    vd = dense(vp).repeat_interleave(G, 1)
    smask = (torch.arange(S, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None, :], kd, vd, attn_mask=smask), 20)
    tokens = int(lengths.sum().item())
    b_ms, b_by = bound(nbytes(q, out, lengths) + int(used.sum().item()) * 4
                       + 2 * tokens * Kv * Hd * 2, 4.0 * Hd * H * tokens, peaks)
    results.append(dict(
        name="paged_attention", route="cuda", source="rlinf_tpu_torch/csrc/paged_attention.cu",
        replaces="rlinf_tpu/ops/pallas/paged_attention.py:152",
        shapes=f"q[{B},{H},{Hd}] pages[{num_pages},{Kv},{Pg},{Hd}] bf16 table[{B},{max_pages}], "
               f"{tokens} valid tokens, one row of length 0",
        max_abs_err=err, tolerance=1e-2, empty_row_max_abs=empty_row,
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        library="scaled_dot_product_attention on pages gathered beforehand",
        bound_ms=b_ms, bound_by=b_by))
    if not err < 1e-2 or empty_row != 0.0:
        raise AssertionError(f"K10 disagrees with its plain version: {err}, empty row {empty_row}")
    del rot, kp, vp, kd, vd

    # --- K9, small shape first ----------------------------------------------
    small = LLMConfig(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
                      head_dim=64, intermediate_size=512, max_seq_len=256)
    sq = quantize_params(M.init_params(small, seed, device="cuda"))
    splan, smw = MK.pack_decode_weights(sq, small)
    wp = torch.randint(5, 127, (8,), generator=g, device=dev, dtype=torch.int32)
    k9 = {}
    k9["small_ragged"], _, _ = mega_case(MK, splan, smw, small, sq, 8, 128, wp, wp,
                                         torch.zeros(8, dtype=torch.int32, device=dev), g)
    emit({"phase": "megakernel_small", **k9["small_ragged"]})

    # --- K9 at Qwen2-1.5B ------------------------------------------------------
    plan, mw = MK.pack_decode_weights(qparams, cfg)
    B, S = 64, 768
    plens = torch.randint(128, 513, (B,), generator=g, device=dev, dtype=torch.int32)
    starts = (512 - plens).to(torch.int32)
    slot = 512 + 128
    k9["uniform"], cache, args = mega_case(MK, plan, mw, cfg, qparams, B, S, slot,
                                           (plens + 128).to(torch.int32), starts, g)
    run = lambda: MK.decode_step_mega(plan, mw, args[0], *cache, *args[1:])
    ms = cuda_ms(run, 5)
    plain_ms = cuda_ms(lambda: MK.decode_step_mega_plain(plan, mw, args[0], *cache, *args[1:]),
                       1, warmup=1)
    clock = torch.zeros((plan.L * len(MK.PHASES) + 2,), dtype=torch.int64, device=dev)
    MK.decode_step_mega(plan, mw, args[0], *cache, *args[1:], phase_clock=clock)
    edges = clock.cpu().numpy()
    spans = np.diff(edges[:-1]).reshape(plan.L, len(MK.PHASES)) / 1e3
    phase_us = {name: float(spans[:, i].mean()) for i, name in enumerate(MK.PHASES)}
    phase_us["whole_launch"] = float(edges[-1] - edges[0]) / 1e3
    valid_slots = int((slot - starts).sum().item())
    layers = tuple((cache[0][l], cache[1][l], cache[2][l], cache[3][l]) for l in range(plan.L))
    tok = torch.zeros((B,), dtype=torch.long, device=dev)
    per_layer_busy = profile_window(lambda: M.decode_step_packed_q8(
        qparams, cfg, tok, layers, slot, args[2], starts,
        torch.full((B,), slot + 1, dtype=torch.int32, device=dev), attn_impl="pallas")
    )["device_busy_ms"]
    del cache, layers

    wps = torch.randint(8, S - 1, (B,), generator=g, device=dev, dtype=torch.int32)
    wps[0], wps[1] = 0, S - 1          # a free slot of the engine, and a full row
    zeros = torch.zeros((B,), dtype=torch.int32, device=dev)
    k9["ragged"], cache, args = mega_case(MK, plan, mw, cfg, qparams, B, S, wps, wps, zeros, g)
    ragged_ms = cuda_ms(lambda: MK.decode_step_mega(plan, mw, args[0], *cache, *args[1:]), 5)
    del cache
    wp8 = torch.randint(8, S - 1, (8,), generator=g, device=dev, dtype=torch.int32)
    k9["ragged_b8"], cache, args = mega_case(MK, plan, mw, cfg, qparams, 8, S, wp8, wp8,
                                             zeros[:8], g)
    b8_ms = cuda_ms(lambda: MK.decode_step_mega(plan, mw, args[0], *cache, *args[1:]), 5)
    del cache

    KVD, L = plan.KVD, plan.L
    moved = (nbytes(mw.stream, mw.scales, mw.norms, mw.bias) + 2 * B * plan.D * 2
             + L * valid_slots * (2 * KVD + 8) + L * B * (2 * KVD + 8))
    b_ms, b_by = bound(moved, 2.0 * B * plan.layer_bytes * L
                       + 4.0 * Hd * H * (valid_slots + B) * L, peaks)
    worst = {k: max(v[k] for v in k9.values()) for k in ("hidden_rel", "k_rel", "v_rel")}
    results.append(dict(
        name="decode_megakernel", route="cuda", source="rlinf_tpu_torch/csrc/decode_megakernel.cu",
        replaces="rlinf_tpu/ops/pallas/decode_megakernel.py:598",
        shapes=f"x0[{B},{plan.D}] bf16, {L} layers of int8 weights ({plan.layer_bytes} B a layer), "
               f"cache[{L},{B},{S},{KVD}] int8 + scales, {valid_slots} valid slots a layer",
        max_abs_err=max(v["hidden_abs"] for v in k9.values()), rel_err=worst, cases=k9,
        tolerance_rel={"hidden_rel": 5e-2, "k_rel": 3e-2, "v_rel": 3e-2},
        ms=ms, ragged_ms=ragged_ms, b8_ms=b8_ms, plain_ms=plain_ms, library_ms=None,
        per_layer_step_device_busy_ms=per_layer_busy, phase_us_mean_over_layers=phase_us,
        comparison="no one PyTorch call computes a whole step; per_layer_step_device_busy_ms is "
                   "the device-busy time of one decode_step_packed_q8 step (K3 and eager "
                   "PyTorch, 28 layers) at the same shape",
        bound_ms=b_ms, bound_by=b_by))
    bad = [k for k, v in k9.items()
           if not (v["hidden_rel"] < 5e-2 and v["k_rel"] < 3e-2 and v["v_rel"] < 3e-2
                   and v["finite"] and v["other_slots_untouched"])]
    if bad:
        raise AssertionError(f"K9 disagrees with its plain version in {bad}: {k9}")
    return results[::-1], (plan, mw)      # K9, then K10


# ---------------------------------------------------------------------------
# Phase 5: the training kernels against their plain versions
# ---------------------------------------------------------------------------


def check_training_kernels(cfg, attention_mask, peaks, seed):
    """K5/K6 at one row chunk of the training path (4096 rows, the tied
    [V, D] embedding) and K7/K8 at one microbatch (the training batch's
    first 16 rows, right-padded, T=768)."""
    from rlinf_tpu_torch.ops.cuda import flash_attention as FA
    from rlinf_tpu_torch.ops.cuda import linear_ce as LCE

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 20)
    H, Kv, Hd, D, V = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_, cfg.hidden_size, cfg.vocab_size
    G = H // Kv
    results = []

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    # --- K5: fused linear-CE forward ----------------------------------------
    n = 4096
    h, w = randn(n, D), randn(V, D, scale=0.02)
    tgt = torch.randint(0, V, (n,), generator=g, device=dev, dtype=torch.int32)
    lp, ent, lse = LCE.ce_forward(h, w, tgt, 1.0, "vd")
    ref = LCE.ce_forward_plain(h, w, tgt, 1.0, "vd")
    torch.cuda.synchronize()
    errs = [(a - b).abs().max().item() for a, b in zip((lp, ent, lse), ref)]
    del ref
    ms = cuda_ms(lambda: LCE.ce_forward(h, w, tgt, 1.0, "vd"), 3, warmup=1)
    plain_ms = cuda_ms(lambda: LCE.ce_forward_plain(h, w, tgt, 1.0, "vd"), 2, warmup=1)
    hl, wl = h.clone().requires_grad_(True), w.clone().requires_grad_(True)

    def library():
        logp = torch.log_softmax((hl @ wl.t()).float(), -1)
        return logp.gather(1, tgt.long()[:, None])[:, 0], -(logp.exp() * logp).sum(-1)

    with torch.no_grad():
        lib_ms = cuda_ms(library, 3, warmup=1)
    b_ms, b_by = bound(nbytes(h, w, tgt, lp, ent, lse), 2.0 * n * D * V, peaks)
    results.append(dict(
        name="linear_ce_fwd", route="cuda", source="rlinf_tpu_torch/csrc/linear_ce.cu",
        replaces="rlinf_tpu/ops/pallas/linear_ce.py:234",
        shapes=f"h[{n},{D}] bf16 w[{V},{D}] bf16 (vd) targets int32",
        max_abs_err=max(errs), lp_ent_lse_err=errs, tolerance=2e-3,
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        library="matmul(bf16) + log_softmax + gather/entropy", bound_ms=b_ms, bound_by=b_by))
    if not max(errs) < 2e-3:
        raise AssertionError(f"K5 disagrees with its plain version: {errs}")

    # --- K6: fused linear-CE backward (non-zero entropy gradient) -----------
    g_lp, g_ent = randn(n, dtype=torch.float32), randn(n, scale=0.1, dtype=torch.float32)
    mu = lse - ent
    dz, dh = LCE.ce_backward(h, w, tgt, lse, mu, g_lp, g_ent, 1.0, "vd")
    dz_r, dh_r = LCE.ce_backward_plain(h, w, tgt, lse, mu, g_lp, g_ent, 1.0, "vd")
    dw = LCE.weight_grad(h, dz, "vd", V, w.dtype)
    dw_r = LCE.weight_grad(h, dz_r, "vd", V, w.dtype)
    torch.cuda.synchronize()
    k6 = {"dz": rel_err(dz, dz_r), "dh": rel_err(dh, dh_r), "dw": rel_err(dw, dw_r)}
    dh_abs = (dh.float() - dh_r.float()).abs().max().item()
    del dz_r, dh_r, dw, dw_r
    ms = cuda_ms(lambda: LCE.ce_backward(h, w, tgt, lse, mu, g_lp, g_ent, 1.0, "vd"), 3, warmup=1)
    plain_ms = cuda_ms(lambda: LCE.ce_backward_plain(
        h, w, tgt, lse, mu, g_lp, g_ent, 1.0, "vd"), 2, warmup=1)
    lpv, entv = library()
    loss = (lpv * g_lp + entv * g_ent).sum()
    lib_ms = cuda_ms(lambda: torch.autograd.grad(loss, (hl,), retain_graph=True), 3, warmup=1)
    del lpv, entv, loss, hl, wl
    b_ms, b_by = bound(nbytes(h, w, tgt, lse, mu, g_lp, g_ent, dz, dh), 4.0 * n * D * V, peaks)
    results.append(dict(
        name="linear_ce_bwd", route="cuda", source="rlinf_tpu_torch/csrc/linear_ce.cu",
        replaces="rlinf_tpu/ops/pallas/linear_ce.py:283",
        shapes=f"as K5, dz[{n},{dz.shape[1]}] bf16 out",
        max_abs_err=dh_abs, rel_err=k6, tolerance_rel=1e-2,
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        library="autograd backward of the K5 library call, d/dh", bound_ms=b_ms, bound_by=b_by))
    if not max(k6.values()) < 1e-2:
        raise AssertionError(f"K6 disagrees with its plain version: {k6}")
    del h, w, tgt, lp, ent, lse, dz, dh, mu
    torch.cuda.empty_cache()

    # --- K7 / K8: flash-attention backward at one microbatch ----------------
    valid = torch.as_tensor(attention_mask, device=dev)
    B, T = valid.shape
    pos = (valid.to(torch.int32).cumsum(-1) - 1).clamp_min(0).to(torch.int32)
    valid_u8 = valid.to(torch.uint8)
    q, k, v, do = randn(B, T, H, Hd), randn(B, T, Kv, Hd), randn(B, T, Kv, Hd), randn(B, T, H, Hd)
    scale = Hd**-0.5
    o, lse = FA.flash_attention_fwd(q, k, v, pos, pos, valid_u8, scale)
    got = FA.flash_attention_bwd(q, k, v, pos, pos, valid_u8, o, lse, do, scale)
    want = FA.flash_attention_bwd_plain(q, k, v, pos, pos, valid_u8, o, lse, do, scale)
    torch.cuda.synchronize()
    errs = {nm: rel_err(a, b) for nm, a, b in zip(("dq", "dk", "dv"), got, want)}
    abs_errs = {nm: (a.float() - b.float()).abs().max().item()
                for nm, a, b in zip(("dq", "dk", "dv"), got, want)}
    dq, dk, dv = got
    del want
    delta = FA._delta(o, do)
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), pos.data_ptr(),
              valid_u8.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr())

    def dims():
        return (B, T, T, H, Kv, Hd, float(scale), torch.cuda.current_stream().cuda_stream)

    ms_dq = cuda_ms(lambda: FA.KERNEL_DQ(0, *common, dq.data_ptr(), *dims()), 5)
    ms_dkv = cuda_ms(lambda: FA.KERNEL_DKV(0, *common, dk.data_ptr(), dv.data_ptr(), *dims()), 5)
    plain_ms = cuda_ms(lambda: FA.flash_attention_bwd_plain(
        q, k, v, pos, pos, valid_u8, o, lse, do, scale), 2, warmup=1)
    mask = (pos[:, None, :] <= pos[:, :, None]) & valid[:, None, :]
    ql = q.transpose(1, 2).detach().requires_grad_(True)
    kl_ = k.detach().requires_grad_(True)
    vl = v.detach().requires_grad_(True)
    ol = torch.nn.functional.scaled_dot_product_attention(
        ql, kl_.repeat_interleave(G, 2).transpose(1, 2), vl.repeat_interleave(G, 2).transpose(1, 2),
        attn_mask=mask[:, None])
    do_t = do.transpose(1, 2)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(ol, (ql, kl_, vl), do_t, retain_graph=True), 5)
    pairs = int(mask.sum().item())
    ins = nbytes(q, k, v, do, pos, pos, valid_u8, lse, delta)
    for name, site, out_bytes, products, ms_k in (
            ("flash_attention_bwd_dq", 311, nbytes(dq), 3, ms_dq),
            ("flash_attention_bwd_dkv", 342, nbytes(dk, dv), 4, ms_dkv)):
        b_ms, b_by = bound(ins + out_bytes, 2.0 * products * Hd * H * pairs, peaks)
        results.append(dict(
            name=name, route="cuda", source="rlinf_tpu_torch/csrc/flash_attention_bwd.cu",
            replaces=f"rlinf_tpu/ops/pallas/flash_attention.py:{site}",
            shapes=f"q/do[{B},{T},{H},{Hd}] k/v[{B},{T},{Kv},{Hd}] bf16, right-padded rows",
            max_abs_err=max(abs_errs.values()), rel_err=errs, tolerance_rel=2e-2,
            ms=ms_k, plain_ms=plain_ms, plain="dq, dk and dv together", library_ms=lib_ms,
            library="autograd backward of scaled_dot_product_attention (dq, dk, dv)",
            bound_ms=b_ms, bound_by=b_by))
    if not max(errs.values()) < 2e-2:
        raise AssertionError(f"K7/K8 disagree with their plain version: {errs}")
    return results


# ---------------------------------------------------------------------------
# Phases 3 and 4: the main path
# ---------------------------------------------------------------------------

def _kernel_sites():
    """(module, attribute, kernel name, plain version) of every kernel
    wrapper the main path calls, at the name the caller looks it up by."""
    from rlinf_tpu_torch.models.llm import model as M
    from rlinf_tpu_torch.models.llm import sampler as S
    from rlinf_tpu_torch.ops.cuda import decode_attention as DA
    from rlinf_tpu_torch.ops.cuda import flash_attention as FA
    from rlinf_tpu_torch.ops.cuda import sampler_kernel as SK

    return [(FA, "flash_attention_fwd", "flash_attention_fwd", FA.flash_attention_fwd_plain),
            (M, "decode_attention_packed", "decode_attention_bf16",
             DA.decode_attention_packed_xla),
            (M, "decode_attention_packed_q8", "decode_attention_q8",
             DA.decode_attention_packed_q8_xla),
            (S, "fused_lmhead_sample", "fused_lmhead_sample", SK.fused_lmhead_sample_plain)]


def _engine_sites():
    """The serving sites and those of the megakernel and paged paths."""
    from rlinf_tpu_torch.models.llm import sampler as S
    from rlinf_tpu_torch.ops.cuda import decode_megakernel as MK
    from rlinf_tpu_torch.ops.cuda import paged_attention as PA
    from rlinf_tpu_torch.rollout import continuous_engine as CE
    from rlinf_tpu_torch.rollout import paged_engine as PE

    return _kernel_sites() + [
        (S, "decode_step_mega", "decode_megakernel", MK.decode_step_mega_plain),
        (CE, "decode_step_mega", "decode_megakernel", MK.decode_step_mega_plain),
        (PE, "paged_attention", "paged_attention", PA.paged_attention_xla)]


@contextlib.contextmanager
def kernels_replaced(make, sites=None):
    """Replace each kernel wrapper of the path (the serving path's unless
    ``sites`` names others) by ``make(name, kernel, plain)``."""
    sites = _kernel_sites() if sites is None else sites
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _, _ in sites]
    for mod, attr, name, plain in sites:
        setattr(mod, attr, make(name, getattr(mod, attr), plain))
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def plain_only(name, kernel, plain):
    return plain


def shadowed(stats: dict):
    """Run each kernel and then its plain version on the same inputs; keep
    the kernel's output and record the disagreement in ``stats``."""
    def make(name, kernel, plain):
        def run(*args, **kwargs):
            if name == "decode_megakernel":
                # K9 fills its cache arguments in place: the plain version gets copies
                ref = plain(*args[:3], *(t.clone() for t in args[3:7]), *args[7:], **kwargs)
                out = kernel(*args, **kwargs)
            else:
                out, ref = kernel(*args, **kwargs), plain(*args, **kwargs)
            st = stats.setdefault(name, {"calls": 0, "max_abs_err": 0.0})
            st["calls"] += 1
            if name == "decode_megakernel":
                st["max_rel_err"] = max(st.get("max_rel_err", 0.0), rel_err(out[0], ref[0]))
                err = (out[0].float() - ref[0].float()).abs().max().item()
            elif name == "fused_lmhead_sample":
                agree = (out[0] == ref[0]).float().mean().item()
                st["token_agree"] = min(st.get("token_agree", 1.0), agree)
                err = (out[1] - ref[1]).abs().max().item()
            else:
                o, r = (out[0], ref[0]) if isinstance(out, tuple) else (out, ref)
                err = (o.float() - r.float()).abs().max().item()
            st["max_abs_err"] = max(st["max_abs_err"], err)
            return out
        return run
    return make


def profile_window(fn, top: int = 10) -> dict:
    """Host time of one call of ``fn`` (no profiler), and the device time of
    its GPU kernels by name over a second call under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # "Command Buffer Full" is CUPTI's marker of a full launch queue, not a kernel
    events = [e for e in prof.key_averages()
              if e.device_time_total > 0 and e.key != "Command Buffer Full"]
    events.sort(key=lambda e: e.device_time_total, reverse=True)
    return {"wall_ms": wall_ms,
            "device_busy_ms": sum(e.device_time_total for e in events) / 1e3,
            "by_kernel_ms": {e.key[:60]: e.device_time_total / 1e3 for e in events[:top]}}


def run_counted(kernels, fn):
    """Zero every launch count, run ``fn`` to completion, return
    (result, seconds, counts)."""
    for kern in kernels.values():
        kern.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return out, secs, {name: kern.launches for name, kern in kernels.items()}


def free_running_check(kerns, seed) -> dict:
    """Whole 16-token greedy runs, kernel path against plain path, at the
    configuration of the JAX package's on-chip gate check_q8_generate
    (2 layers, D=256, V=512, B=8, P=64), with its bar: token agreement
    > 0.95, logprob error < 0.15. At Qwen2-1.5B depth with random weights
    two plain paths already part after a few tokens (PERF.md, Findings), so
    there the gate is the per-call shadow check instead."""
    from rlinf_tpu_torch.models.llm import model as M
    from rlinf_tpu_torch.models.llm.config import LLMConfig
    from rlinf_tpu_torch.models.llm.quant import quantize_params
    from rlinf_tpu_torch.models.llm.sampler import SamplingParams, generate

    cfg = LLMConfig(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
                    num_kv_heads=2, head_dim=64, intermediate_size=512, max_seq_len=256)
    params = M.init_params(cfg, seed, device="cuda")
    qparams = quantize_params(params)
    rng = np.random.default_rng(seed + 5)
    ids = rng.integers(0, cfg.vocab_size, (8, 64))
    mask = np.ones((8, 64), bool)
    sp = SamplingParams(max_new_tokens=16, greedy=True, eos_token_id=-1)
    out = {}
    for kv in ("none", "int8"):
        def run():
            return generate(params, cfg, torch.Generator(), ids, mask, sp, attn_impl="pallas",
                            decode_params=qparams, decode_attn_impl="pallas", kv_quant=kv,
                            device="cuda")
        fast, _, counts = run_counted(kerns, run)
        with kernels_replaced(plain_only):
            plain = run()
        agree = (fast.response_ids == plain.response_ids).float().mean().item()
        lp_err = (fast.response_logprobs - plain.response_logprobs).abs().max().item()
        out[f"kv_{kv}"] = {"greedy_agree": agree, "lp_max_err": lp_err, "launches": counts}
        ran = [k for k, c in counts.items() if c]
        if not (agree > 0.95 and lp_err < 0.15 and len(ran) == 3):
            raise AssertionError(f"free-running greedy check failed (kv {kv}): {out[f'kv_{kv}']}")
    return out


# ---------------------------------------------------------------------------
# Phases 9-12: megakernel generate, the continuous and paged engines
# ---------------------------------------------------------------------------

def long_tail_mix(cfg, seed, n=128):
    """128 requests: prompts of 128-512 tokens, budgets spread over 32-256."""
    from rlinf_tpu_torch.data.io_struct import RolloutRequest

    r = np.random.default_rng(seed + 60)
    lens = r.integers(128, 513, n)
    budgets = [int(b) for b in r.integers(32, 257, n)]
    prompts = [list(map(int, r.integers(0, cfg.vocab_size, k))) for k in lens]
    return RolloutRequest(prompt_ids=prompts, max_new_tokens=budgets), budgets


def check_answers(res, budgets, V):
    lens = res.response_mask.sum(1)
    if not np.array_equal(lens, budgets):
        raise AssertionError(f"requests not answered with their budgets: {lens} vs {budgets}")
    lps = res.response_logprobs[res.response_mask]
    if not (np.isfinite(lps).all() and (lps <= 0).all()):
        raise AssertionError("logprobs must be finite and <= 0")
    if not ((res.response_ids >= 0) & (res.response_ids < V)).all():
        raise AssertionError("token ids out of range")


def timed(seen, key, fn):
    """``fn`` with its seconds on the host clock, device work included,
    added to ``seen[key]``."""
    def run(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        seen[key] = seen.get(key, 0.0) + time.perf_counter() - t0
        return out
    return run


def watch_engine(eng):
    """Count the engine's decode rounds, prefill calls and compactions, note
    the cache layout of every round (True = stacked), and time the three."""
    seen = {"decode_rounds": 0, "prefill_calls": 0, "compactions": 0, "stacked": [],
            "pool_sizes": []}
    harvest = timed(seen, "decode_s", eng.decode_and_harvest)
    refill = timed(seen, "prefill_s", eng._refill_impl)
    compact = timed(seen, "compact_s", eng.compact_pool)

    def on_harvest(pool, *a):
        seen["decode_rounds"] += 1
        seen["stacked"].append(eng._is_stacked(pool.kv_layers))
        seen["pool_sizes"].append(pool.size)
        t0 = seen.get("decode_s", 0.0)
        out = harvest(pool, *a)
        key = "stacked_decode_s" if seen["stacked"][-1] else "per_layer_decode_s"
        seen[key] = seen.get(key, 0.0) + seen["decode_s"] - t0
        return out

    def on_refill(*a):
        seen["prefill_calls"] += 1
        return refill(*a)

    def on_compact(pool):
        out = compact(pool)
        seen["compactions"] += out.size < pool.size
        return out

    eng.decode_and_harvest, eng._refill_impl, eng.compact_pool = on_harvest, on_refill, on_compact
    return seen


def engine_phases(cfg, params, kerns, gpu, seed):
    """The continuous engine (a) through build_rollout_engine with the
    per-layer kernels, (b) with use_mega="auto" and the fused sampler, and
    the paged engine, all on one long-tail mix at full width and depth."""
    from rlinf_tpu_torch.config import RolloutConfig
    from rlinf_tpu_torch.models.llm.sampler import SamplingParams
    from rlinf_tpu_torch.rollout import build_rollout_engine
    from rlinf_tpu_torch.rollout import continuous_engine as CE
    from rlinf_tpu_torch.rollout import paged_engine as PE

    request, budgets = long_tail_mix(cfg, seed)
    tokens = int(sum(budgets))
    sp = SamplingParams(max_new_tokens=256, temperature=1.0, eos_token_id=-1)
    L = cfg.num_layers

    def trainer_cfg(**ro):
        return types.SimpleNamespace(
            model=cfg, sampling=sp, attn_impl="pallas",
            rollout=RolloutConfig(num_slots=64, decode_chunk=16, prompt_bucket=64, **ro),
            data=types.SimpleNamespace(max_prompt_len=512),
            algorithm=types.SimpleNamespace(recompute_logprobs=None))

    out = {"phase": "engines", "gpu": gpu, "model": "qwen2_1_5b", "layers": L,
           "requests": len(budgets), "generated_tokens": tokens, "slots": 64, "decode_chunk": 16}
    total = dict.fromkeys(kerns, 0)

    def run(name, eng, want, zero):
        seen = watch_engine(eng)
        res, secs, counts = run_counted(kerns, lambda: eng.rollout(
            params, request, torch.Generator().manual_seed(seed + 2)))
        check_answers(res, budgets, cfg.vocab_size)
        missing = [k for k in want if not counts[k]] + [k for k in zero if counts[k]]
        out[name] = {"seconds": secs, "generated_tokens_per_s": tokens / secs,
                     "decode_rounds": seen["decode_rounds"], "prefill_calls": seen["prefill_calls"],
                     "compactions": seen["compactions"], "pool_sizes": sorted(set(seen["pool_sizes"])),
                     "stacked_rounds": sum(seen["stacked"]),
                     **{k: v for k, v in seen.items() if k.endswith("_s")}, "launches": counts}
        for k, c in counts.items():
            total[k] += c
        if missing or seen["prefill_calls"] < 2:
            raise AssertionError(f"{name}: launch gate failed on {missing}: {out[name]}")
        return seen, counts

    # (a) engine="auto" resolves to the continuous engine
    eng = build_rollout_engine(trainer_cfg(engine="auto", weight_quant="int8", kv_quant="int8"),
                               device="cuda")
    if type(eng) is not CE.ContinuousBatchingEngine:
        raise AssertionError(f"engine='auto' built {type(eng)}")
    run("continuous_per_layer", eng, ("flash_attention_fwd", "decode_attention_q8"),
        ("decode_megakernel", "decode_attention_bf16", "paged_attention"))
    del eng

    # (b) hybrid: per-layer kernels on the large pool, K9 after compaction
    eng = CE.ContinuousBatchingEngine(
        cfg, sp, num_slots=64, max_seq_len=768, prompt_bucket=64, decode_chunk=16,
        weight_quant="int8", kv_quant="int8", decode_attn_impl="pallas", attn_impl="pallas",
        use_mega="auto", mega_threshold=32, sampler_impl="fused", device="cuda")
    slot_dims = set()
    real_step = CE.decode_step_mega

    def noting_step(*a):
        slot_dims.add(a[7].ndim if torch.is_tensor(a[7]) else 0)
        return real_step(*a)

    CE.decode_step_mega = noting_step
    try:
        seen, counts = run(
            "continuous_hybrid", eng,
            ("flash_attention_fwd", "decode_attention_q8", "fused_lmhead_sample",
             "decode_megakernel"), ("decode_attention_bf16", "paged_attention"))
    finally:
        CE.decode_step_mega = real_step
    if set(seen["stacked"]) != {False, True} or slot_dims != {1}:
        raise AssertionError(f"hybrid engine: layouts {set(seen['stacked'])}, "
                             f"write_pos dims {slot_dims}")
    if counts["decode_megakernel"] != 16 * sum(seen["stacked"]):
        raise AssertionError(f"K9 launches {counts['decode_megakernel']} for "
                             f"{sum(seen['stacked'])} stacked rounds of 16 steps")
    del eng
    torch.cuda.empty_cache()

    # the paged engine, page pool watched
    class WatchedPool(PE.PagePool):
        made = []

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.peak = 0
            WatchedPool.made.append(self)

        def append_tokens_chunk(self, *a):
            res = super().append_tokens_chunk(*a)
            self.peak = max(self.peak, self.num_pages - 1 - self.free_pages)
            return res

    eng = build_rollout_engine(trainer_cfg(engine="paged", page_size=16), device="cuda")
    if type(eng) is not PE.PagedContinuousEngine or eng.attn_impl != "pallas":
        raise AssertionError(f"engine='paged' built {type(eng)} with {eng.attn_impl}")
    rounds, split = [], {}
    decode = timed(split, "decode_s", eng._decode_paged_impl)
    eng._decode_paged_impl = lambda *a: (rounds.append(a[-1]), decode(*a))[1]
    eng._prefill_paged_impl = timed(split, "prefill_s", eng._prefill_paged_impl)
    real_pool, PE.PagePool = PE.PagePool, WatchedPool
    try:
        res, secs, counts = run_counted(kerns, lambda: eng.rollout(
            params, request, torch.Generator().manual_seed(seed + 3)))
    finally:
        PE.PagePool = real_pool
    check_answers(res, budgets, cfg.vocab_size)
    pool = WatchedPool.made[-1]
    out["paged"] = {"seconds": secs, "generated_tokens_per_s": tokens / secs,
                    "decode_rounds": len(rounds), "decode_steps": sum(rounds), **split,
                    "pages": pool.num_pages, "peak_pages_in_use": pool.peak,
                    "free_pages_at_end": pool.free_pages, "launches": counts,
                    "prefill_attention": "plain (as the JAX engine)"}
    for k, c in counts.items():
        total[k] += c
    want = {**dict.fromkeys(kerns, 0), "paged_attention": L * sum(rounds)}
    if counts != want or pool.free_pages != pool.num_pages - 1:
        raise AssertionError(f"paged engine: launches {counts}, expected {want}; "
                             f"{pool.free_pages} of {pool.num_pages - 1} pages free at the end")
    emit(out)
    return total


def small_engine_checks(kerns, seed) -> dict:
    """Whole greedy runs at small size, kernels against the plain paths from
    the same params, at the configurations of the JAX package's on-chip
    gates and with their bars: check_megakernel_generate (agreement > 0.9,
    against the plain megakernel path and against the per-layer int8 path),
    check_mega_engine (hybrid engine: lengths equal, agreement > 0.9, both
    layouts seen), check_paged_kernel (K10 error < 0.01) and the paged
    engine against the dense continuous engine on its plain decode
    attention (_engine_parity: token match > 0.995, logprob diff < 0.02)."""
    from rlinf_tpu_torch.data.io_struct import RolloutRequest
    from rlinf_tpu_torch.models.llm import model as M
    from rlinf_tpu_torch.models.llm.config import LLMConfig
    from rlinf_tpu_torch.models.llm.quant import quantize_params
    from rlinf_tpu_torch.models.llm.sampler import SamplingParams, generate
    from rlinf_tpu_torch.ops.cuda import decode_megakernel as MK
    from rlinf_tpu_torch.ops.cuda import paged_attention as PA
    from rlinf_tpu_torch.rollout.continuous_engine import ContinuousBatchingEngine
    from rlinf_tpu_torch.rollout.paged_engine import PagedContinuousEngine

    out = {}
    sites = _engine_sites()
    cfg = LLMConfig(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
                    num_kv_heads=2, head_dim=64, intermediate_size=512, max_seq_len=256)

    # check_megakernel_generate
    params = M.init_params(cfg, seed, device="cuda")
    qparams = quantize_params(params)
    mega = MK.pack_decode_weights(qparams, cfg, chunk_width=256)
    r = np.random.default_rng(seed + 5)
    ids, mask = r.integers(0, cfg.vocab_size, (8, 64)), np.ones((8, 64), bool)
    sp = SamplingParams(max_new_tokens=16, greedy=True, eos_token_id=-1)

    def gen(m):
        return generate(params, cfg, torch.Generator(), ids, mask, sp, attn_impl="pallas",
                        decode_params=qparams, decode_attn_impl="pallas", kv_quant="int8",
                        mega=m, sampler_impl="xla", device="cuda")

    fast, _, counts = run_counted(kerns, lambda: gen(mega))
    per_layer = gen(None)
    with kernels_replaced(plain_only, sites):
        plain = gen(mega)
    agree = lambda a, b: (a.response_ids == b.response_ids).float().mean().item()
    out["megakernel_generate"] = {
        "vs_plain_megakernel_path": agree(fast, plain), "vs_per_layer_q8_kernels": agree(fast, per_layer),
        "launches": {k: c for k, c in counts.items() if c}}
    if not (agree(fast, plain) > 0.9 and agree(fast, per_layer) > 0.9
            and counts["decode_megakernel"] == 15 and counts["decode_attention_q8"] == 0):
        raise AssertionError(f"small megakernel generate check failed: {out}")

    # check_mega_engine
    params = M.init_params(cfg, seed + 3, device="cuda")
    sp = SamplingParams(max_new_tokens=32, greedy=True, eos_token_id=-1, pad_token_id=0)
    r = np.random.default_rng(11)
    budgets = [4, 8, 8, 16] * 4
    request = RolloutRequest(
        prompt_ids=[list(map(int, r.integers(2, 500, int(r.integers(4, 24))))) for _ in range(16)],
        max_new_tokens=budgets)

    def engine_run(use_mega):
        eng = ContinuousBatchingEngine(
            cfg, sp, num_slots=16, max_seq_len=128, prompt_bucket=32, decode_chunk=4,
            weight_quant="int8", kv_quant="int8", decode_attn_impl="pallas", attn_impl="pallas",
            use_mega=use_mega, mega_chunk_width=256, mega_threshold=8, device="cuda")
        seen = watch_engine(eng)
        return eng.rollout(params, request, torch.Generator()), seen

    (hybrid, seen), _, counts = run_counted(kerns, lambda: engine_run("auto"))
    per_layer, _ = engine_run(False)
    with kernels_replaced(plain_only, sites):
        plain, _ = engine_run("auto")

    def engine_agree(a, b):
        if not np.array_equal(a.response_lengths, b.response_lengths):
            raise AssertionError("hybrid engine: response lengths differ")
        return float((a.response_ids == b.response_ids)[a.response_mask].mean())

    out["mega_engine"] = {
        "vs_plain_paths": engine_agree(hybrid, plain),
        "vs_per_layer_q8_engine": engine_agree(hybrid, per_layer),
        "layouts_seen": sorted(set(seen["stacked"])),
        "launches": {k: c for k, c in counts.items() if c}}
    if not (out["mega_engine"]["vs_plain_paths"] > 0.9
            and out["mega_engine"]["vs_per_layer_q8_engine"] > 0.9
            and set(seen["stacked"]) == {False, True} and counts["decode_megakernel"] > 0
            and np.array_equal(hybrid.response_lengths, budgets)):
        raise AssertionError(f"small hybrid engine check failed: {out['mega_engine']}")

    # check_paged_kernel
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, H, Kv, Hd, Pg, n_pages, max_pages = 8, 4, 2, 64, 16, 64, 8
    rn = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    q = rn(B, H, Hd).to(torch.bfloat16)
    kp, vp = ((rn(n_pages, Kv, Pg, Hd) * 0.3).to(torch.bfloat16) for _ in range(2))
    table = torch.randint(0, n_pages, (B, max_pages), generator=g, device="cuda", dtype=torch.int32)
    lengths = ((torch.arange(B, device="cuda") * 13) % (Pg * max_pages - 2) + 1).to(torch.int32)
    err = (PA.paged_attention(q, kp, vp, table, lengths).float()
           - PA.paged_attention_xla(q, kp, vp, table, lengths).float()).abs().max().item()
    out["paged_kernel"] = {"max_err": err}
    if not err < 0.01:
        raise AssertionError(f"small paged kernel check failed: {err}")

    # the paged engine against the dense continuous engine (_engine_parity)
    cfg = LLMConfig(vocab_size=256, hidden_size=256, num_layers=2, num_heads=4,
                    num_kv_heads=2, head_dim=64, intermediate_size=512, max_seq_len=256)
    params = M.init_params(cfg, seed + 5, device="cuda")
    sp = SamplingParams(max_new_tokens=16, temperature=1.0, greedy=True, eos_token_id=-1)
    r = np.random.default_rng(7)
    request = RolloutRequest(prompt_ids=[
        list(map(int, r.integers(2, 255, int(r.integers(4, 30))))) for _ in range(16)])
    kw = dict(num_slots=16, max_seq_len=64, prompt_bucket=32, decode_chunk=8, device="cuda")
    dense = ContinuousBatchingEngine(cfg, sp, weight_quant="none", decode_attn_impl="xla",
                                     **kw).rollout(params, request, torch.Generator())
    paged, _, counts = run_counted(kerns, lambda: PagedContinuousEngine(
        cfg, sp, page_size=16, attn_impl="pallas", **kw).rollout(params, request, torch.Generator()))
    match = float(np.mean((dense.response_ids == paged.response_ids) | ~dense.response_mask))
    lp_diff = float(np.abs(np.where(dense.response_mask, dense.response_logprobs, 0.0)
                           - np.where(paged.response_mask, paged.response_logprobs, 0.0)).max())
    out["paged_vs_dense_engine"] = {"token_match": match, "max_logprob_diff": lp_diff,
                                    "paged_attention_launches": counts["paged_attention"]}
    if not (match > 0.995 and lp_diff < 0.02 and counts["paged_attention"] > 0):
        raise AssertionError(f"paged engine against the dense engine: {out['paged_vs_dense_engine']}")
    return out


# ---------------------------------------------------------------------------
# Phases 6 and 7: the training path
# ---------------------------------------------------------------------------

def _training_sites():
    """(module, attribute, kernel name, plain version) of every kernel
    wrapper that the training path's autograd Functions call."""
    from rlinf_tpu_torch.ops.cuda import flash_attention as FA
    from rlinf_tpu_torch.ops.cuda import linear_ce as LCE

    return [(FA, "flash_attention_fwd", "flash_attention_fwd", FA.flash_attention_fwd_plain),
            (FA, "flash_attention_bwd", "flash_attention_bwd", FA.flash_attention_bwd_plain),
            (LCE, "ce_forward", "linear_ce_fwd", LCE.ce_forward_plain),
            (LCE, "ce_backward", "linear_ce_bwd", LCE.ce_backward_plain)]


TRAIN_KERNELS = ("flash_attention_fwd", "linear_ce_fwd", "linear_ce_bwd",
                 "flash_attention_bwd_dq", "flash_attention_bwd_dkv")


def reward_rule(response_ids, response_mask):
    """The rule rewards of this smoke run: 1.0 where more than half of a
    response's tokens have an even id, else 0.0 (the math verifier and the
    tokenizer come with the runner)."""
    even = ((response_ids % 2 == 0) & response_mask).sum(-1)
    return (even * 2 > response_mask.sum(-1)).astype(np.float32)


def training_path(cfg, params, rollout, kerns, gpu, seed):
    """GRPO on the serving phase's rollout: rule rewards, GRPO advantages
    over 8 groups of 8, build_train_batch, the logprob recompute, then two
    train steps (remat, attn_impl="pallas", 4 microbatches, adamw with
    master weights, entropy bonus 1e-3) through the public entry points."""
    from rlinf_tpu_torch.algorithms import get_advantage_fn
    from rlinf_tpu_torch.config import (
        AlgorithmConfig, RunnerConfig, TrainerConfig, validate_config,
    )
    from rlinf_tpu_torch.data.io_struct import build_train_batch
    from rlinf_tpu_torch.training.learner import (
        PolicyLossConfig, make_logprob_fn, make_policy_train_step,
    )
    from rlinf_tpu_torch.training.train_state import OptimizerConfig, TrainState, make_optimizer

    tcfg = TrainerConfig(
        model=cfg, attn_impl="pallas", remat=True, num_microbatches=4,
        optimizer=OptimizerConfig(name="adamw", lr=1e-6, master_weights=True),
        loss=PolicyLossConfig(entropy_bonus=1e-3),
        algorithm=AlgorithmConfig(adv_type="grpo", group_size=8),
        runner=RunnerConfig(rollout_batch_size=8))
    validate_config(tcfg)
    G = tcfg.algorithm.group_size
    rewards = reward_rule(rollout.response_ids, rollout.response_mask)
    adv, _ = get_advantage_fn(tcfg.algorithm.adv_type)(
        rewards=torch.as_tensor(rewards), loss_mask=torch.as_tensor(rollout.response_mask.T),
        group_size=G)
    batch = build_train_batch(rollout, adv.T.numpy(), pad_id=0, seq_bucket=128)
    B, T = batch.input_ids.shape
    tokens = int(batch.attention_mask.sum())

    tx = make_optimizer(tcfg.optimizer)
    logprob_fn = make_logprob_fn(cfg, chunk_size=tcfg.loss.logprob_chunk_size,
                                 attn_impl=tcfg.attn_impl, device="cuda")
    step_fn = make_policy_train_step(cfg, tcfg.loss, tx, num_microbatches=tcfg.num_microbatches,
                                     remat=tcfg.remat, attn_impl=tcfg.attn_impl, device="cuda")
    watch = {k: params["blocks"][k][0].flatten()[:4096].clone() for k in ("wq", "down")}
    watch["embed"] = params["embed"][:64].clone()
    torch.cuda.reset_peak_memory_stats()
    times, metrics = {}, []

    def run():
        t0 = time.perf_counter()
        lp, _ = logprob_fn(params, batch.to_dict())
        torch.cuda.synchronize()
        times["recompute_s"] = time.perf_counter() - t0
        lp = lp.cpu().numpy()
        times["recompute_vs_rollout_lp"] = {
            "max_abs": float(np.abs(lp - batch.old_logprobs)[batch.loss_mask].max()),
            "mean_abs": float(np.abs(lp - batch.old_logprobs)[batch.loss_mask].mean())}
        batch.old_logprobs = np.where(batch.loss_mask, lp, 0.0).astype(np.float32)
        state = TrainState(0, params, tx.init(params))
        for i in (1, 2):
            t0 = time.perf_counter()
            state, m = step_fn(state, batch.to_dict())
            torch.cuda.synchronize()
            times[f"step{i}_s"] = time.perf_counter() - t0
            metrics.append({k: float(v) for k, v in m.items()})
            if i == 1:
                times["moved_after_step1"] = {
                    k: bool((w != (params["embed"][:64] if k == "embed" else
                                   params["blocks"][k][0].flatten()[:4096])).any())
                    for k, w in watch.items()}
        return state

    state, secs, counts = run_counted(kerns, run)
    out = {"phase": "training", "gpu": gpu, "model": "qwen2_1_5b", "layers": cfg.num_layers,
           "batch": B, "seq_len": T, "train_tokens": tokens, "num_microbatches": 4,
           "rewards_mean": float(rewards.mean()), "seconds": secs, **times,
           "train_tokens_per_s": tokens / times["step2_s"],
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2**30,
           "metrics": metrics, "launches": counts}
    emit(out)
    missing = [k for k in TRAIN_KERNELS if not counts[k]]
    bad = [k for m in metrics for k in ("actor/loss", "actor/grad_norm")
           if not np.isfinite(m[k])]
    if missing:
        raise AssertionError(f"training path did not launch {missing}: {counts}")
    if bad:
        raise AssertionError(f"non-finite training metrics: {bad}")
    if not abs(metrics[0]["actor/approx_kl"]) < 1e-3:
        raise AssertionError(f"step-1 approx_kl {metrics[0]['actor/approx_kl']} >= 1e-3")
    if not all(times["moved_after_step1"].values()):
        raise AssertionError(f"params did not move in step 1: {times['moved_after_step1']}")
    return state, batch, step_fn, counts


def profile_train_step(state, batch, step_fn, top: int = 12) -> dict:
    """Device time by kernel over one more train step under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step_fn(state, batch.to_dict())
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_time_total > 0 and e.key != "Command Buffer Full"]
    events.sort(key=lambda e: e.device_time_total, reverse=True)
    busy = sum(e.device_time_total for e in events) / 1e3
    return {"phase": "train_profile", "wall_ms_under_profiler": wall_ms, "device_busy_ms": busy,
            "by_kernel_ms": {e.key[:60]: e.device_time_total / 1e3 for e in events[:top]},
            "by_kernel_calls": {e.key[:60]: e.count for e in events[:top]}}


def whole_step_check(kerns, seed) -> dict:
    """One make_policy_train_step at the configuration of the JAX package's
    check_q8_generate (2 layers, D=256, V=512, bf16), kernels against the
    plain path from the same params and batch. Bar: loss and grad norm
    within 1e-2 relative; over all parameters together, the master-weight
    update within 5e-2 of its norm and the bf16 params within 1e-2 of
    theirs. Adam's eps is 1e-3 here: its first step is g / (|g| + eps), and
    with eps = 1e-8 a gradient that is rounding noise on both paths (the k
    bias's is exactly zero in exact arithmetic) moves by +-lr either way."""
    from rlinf_tpu_torch.models.llm import model as M
    from rlinf_tpu_torch.models.llm.config import LLMConfig
    from rlinf_tpu_torch.training.learner import PolicyLossConfig, make_policy_train_step
    from rlinf_tpu_torch.training.train_state import (
        OptimizerConfig, TrainState, make_optimizer, tree_leaves,
    )

    cfg = LLMConfig(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
                    num_kv_heads=2, head_dim=64, intermediate_size=512, max_seq_len=256)
    r = np.random.default_rng(seed + 7)
    B, T = 8, 128
    lens = r.integers(T // 2, T + 1, B)
    attn = np.arange(T)[None, :] < lens[:, None]
    loss_mask = attn & (np.arange(T)[None, :] >= 32)
    batch = {"input_ids": r.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
             "target_ids": r.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
             "attention_mask": attn, "loss_mask": loss_mask,
             "old_logprobs": np.where(loss_mask, -np.log(cfg.vocab_size), 0).astype(np.float32),
             "advantages": (r.normal(size=(B, T)) * loss_mask).astype(np.float32)}
    runs = {}
    for mode in ("kernels", "plain"):
        params = M.init_params(cfg, seed, device="cuda")
        p0 = [p.float().clone() for p in tree_leaves(params)]
        tx = make_optimizer(OptimizerConfig(lr=1e-4, eps=1e-3, master_weights=True))
        step = make_policy_train_step(cfg, PolicyLossConfig(entropy_bonus=1e-3), tx,
                                      num_microbatches=2, remat=True, attn_impl="pallas",
                                      device="cuda")
        with (kernels_replaced(plain_only, _training_sites()) if mode == "plain"
              else contextlib.nullcontext()):
            (state, m), _, counts = run_counted(
                kerns, lambda: step(TrainState(0, params, tx.init(params)), batch))
        ran = [k for k in TRAIN_KERNELS if counts[k]]
        if ran != (list(TRAIN_KERNELS) if mode == "kernels" else []):
            raise AssertionError(f"whole-step check, {mode} run launched {counts}")
        runs[mode] = (state, m, p0)
    (ks, km, p0), (ps, pm, _) = runs["kernels"], runs["plain"]
    rel = lambda a, b: abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
    flat = lambda ts: torch.cat([t.float().flatten() for t in ts])
    km_, pm_ = (flat(tree_leaves(x)) for x in (ks.opt_state["master"], ps.opt_state["master"]))
    z = flat(p0)
    upd = (torch.linalg.vector_norm(km_ - pm_) / torch.linalg.vector_norm(pm_ - z)).item()
    kp, pp = flat(tree_leaves(ks.params)), flat(tree_leaves(ps.params))
    par = (torch.linalg.vector_norm(kp - pp) / torch.linalg.vector_norm(pp)).item()
    out = {"loss_rel": rel(km["actor/loss"], pm["actor/loss"]),
           "grad_norm_rel": rel(km["actor/grad_norm"], pm["actor/grad_norm"]),
           "master_update_rel": upd, "params_rel": par,
           "loss": float(km["actor/loss"]), "grad_norm": float(km["actor/grad_norm"])}
    if not (out["loss_rel"] < 1e-2 and out["grad_norm_rel"] < 1e-2 and upd < 5e-2
            and par < 1e-2):
        raise AssertionError(f"whole-step check failed: {out}")
    return out


def check_output(ids, lps, mask, B, N, V):
    ids, lps, mask = map(torch.as_tensor, (ids, lps, mask))
    if tuple(ids.shape) != (B, N) or tuple(lps.shape) != (B, N) or tuple(mask.shape) != (B, N):
        raise AssertionError(f"output shapes {ids.shape} {lps.shape} {mask.shape}")
    if not torch.isfinite(lps).all() or not (lps <= 0).all():
        raise AssertionError("logprobs must be finite and <= 0")
    if not ((ids >= 0) & (ids < V)).all() or not mask.all():
        raise AssertionError("token ids out of range or rows stopped without an eos")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_start = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the GPU",
              file=sys.stderr)
        return 1
    import rlinf_tpu_torch
    if Path(rlinf_tpu_torch.__file__).resolve().parents[1] != HERE:
        raise RuntimeError("chip_smoke.py must run from the checkout that holds rlinf_tpu_torch")
    from rlinf_tpu_torch.config import RolloutConfig
    from rlinf_tpu_torch.data.io_struct import RolloutRequest
    from rlinf_tpu_torch.models.llm import model as M
    from rlinf_tpu_torch.models.llm.config import LLMConfig
    from rlinf_tpu_torch.models.llm.quant import QTensor, quantize_params
    from rlinf_tpu_torch.models.llm.sampler import SamplingParams, generate
    from rlinf_tpu_torch.ops.cuda import build, kernels
    from rlinf_tpu_torch.rollout import build_rollout_engine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    name = torch.cuda.get_device_name(0)
    peak_name, peaks = card_peaks(name)
    emit({"phase": "device", "gpu": gpu, "torch": torch.__version__,
          "cuda": torch.version.cuda, "peaks_from": peak_name})

    # 1. build
    emit({"phase": "build", "seconds": build()})

    cfg = LLMConfig.qwen2_1_5b()
    B, N, bucket = 64, 256, 64
    rng = np.random.default_rng(args.seed)
    prompt_lens = rng.integers(128, 513, B)
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, n))) for n in prompt_lens]
    P = -(-int(prompt_lens.max()) // bucket) * bucket

    # 2. kernels
    with torch.inference_mode():
        results = check_kernels(cfg, B, P, N, prompt_lens, peaks, args.seed)
    emit({"phase": "kernels", "gpu": gpu, "results": results})
    torch.cuda.empty_cache()

    # 3. main path
    kerns = kernels()
    t0 = time.perf_counter()
    params = M.init_params(cfg, args.seed, device="cuda")
    init_s = time.perf_counter() - t0
    sp = SamplingParams(max_new_tokens=N, temperature=1.0, eos_token_id=-1)
    trainer_cfg = types.SimpleNamespace(
        model=cfg, sampling=sp, attn_impl="pallas",
        rollout=RolloutConfig(engine="static", weight_quant="int8", prompt_bucket=bucket),
        data=types.SimpleNamespace(max_prompt_len=512),
        algorithm=types.SimpleNamespace(recompute_logprobs=None),
    )
    engine = build_rollout_engine(trainer_cfg, device="cuda")
    request = RolloutRequest(prompt_ids=prompts)
    L = cfg.num_layers
    runs = {}

    res, secs, counts = run_counted(
        kerns, lambda: engine.rollout(params, request, torch.Generator().manual_seed(args.seed)))
    check_output(res.response_ids, res.response_logprobs, res.response_mask, B, N, cfg.vocab_size)
    want = {**dict.fromkeys(kerns, 0), "flash_attention_fwd": L,
            "decode_attention_bf16": L * (N - 1), "fused_lmhead_sample": N}
    if counts != want:
        raise AssertionError(f"rollout launch counts {counts}, expected {want}")
    runs["rollout_bf16_kv"] = (secs, counts)

    ids, mask = request.left_padded(sp.pad_token_id, bucket=bucket)
    with torch.inference_mode():
        qparams = quantize_params(params)
        out, secs, counts = run_counted(kerns, lambda: generate(
            params, cfg, torch.Generator().manual_seed(args.seed + 1), ids, mask, sp,
            attn_impl="pallas", decode_params=qparams, decode_attn_impl="pallas",
            kv_quant="int8", device="cuda"))
    check_output(out.response_ids.cpu(), out.response_logprobs.cpu(), out.response_mask.cpu(),
                 B, N, cfg.vocab_size)
    want = {**dict.fromkeys(kerns, 0), "flash_attention_fwd": L,
            "decode_attention_q8": L * (N - 1), "fused_lmhead_sample": N}
    if counts != want:
        raise AssertionError(f"generate(kv_quant='int8') launch counts {counts}, expected {want}")
    runs["generate_int8_kv"] = (secs, counts)
    launches = {k: sum(c[k] for _, c in runs.values()) for k in kerns}

    # the parts of a run, timed alone with CUDA events
    with torch.inference_mode():
        ids_t = torch.as_tensor(ids, device="cuda")
        mask_t = torch.as_tensor(mask, device="cuda")
        prefill_ms = cuda_ms(lambda: M.prefill(params, cfg, ids_t, mask_t, P + N,
                                               attn_impl="pallas"), 2, warmup=1)
        quantize_ms = cuda_ms(lambda: quantize_params(params), 2, warmup=1)
        qleaves = [w for w in qparams["blocks"].values() if isinstance(w, QTensor)]
        upcast_ms = cuda_ms(lambda: [w.q.to(torch.bfloat16) for w in qleaves], 5)
    main = {"phase": "main_path", "gpu": gpu, "model": "qwen2_1_5b", "layers": L,
            "batch": B, "prompt_bucket": P, "new_tokens": N,
            "prompt_len_min": int(prompt_lens.min()), "prompt_len_max": int(prompt_lens.max()),
            "init_params_s": init_s, "prefill_ms": prefill_ms, "quantize_params_ms": quantize_ms,
            "int8_weight_upcast_ms_per_step": upcast_ms}
    for run, (secs, counts) in runs.items():
        decode_total = secs * 1e3 - prefill_ms - (quantize_ms if run == "rollout_bf16_kv" else 0)
        main[run] = {"seconds": secs, "generated_tokens_per_s": B * N / secs,
                     "decode_ms_per_step": decode_total / (N - 1), "launches": counts}
    emit(main)
    del engine, out
    torch.cuda.empty_cache()

    # 4. greedy check. Gate: every kernel call of a 16-token greedy run
    # against its plain version on the same inputs (shadow mode). Reported:
    # free-running agreement of whole runs, where bf16 rounding differences
    # grow through the 28 random-weight layers (PERF.md, Findings).
    greedy = SamplingParams(max_new_tokens=16, greedy=True)
    check = {"phase": "greedy_check", "new_tokens": 16}
    with torch.inference_mode():
        for kv in ("none", "int8"):
            def run(impl="pallas"):
                return generate(params, cfg, torch.Generator(), ids, mask, greedy,
                                attn_impl=impl, decode_params=qparams, decode_attn_impl=impl,
                                kv_quant=kv, sampler_impl=None if impl == "pallas" else "xla",
                                device="cuda")
            stats = {}
            with kernels_replaced(shadowed(stats)):
                fast = run()
            with kernels_replaced(plain_only):
                plain, _, counts = run_counted(kerns, run)
            if any(counts.values()):
                raise AssertionError(f"plain run launched kernels: {counts}")
            xla = run("xla")

            def agree(a, b):
                return (a.response_ids == b.response_ids).float().mean().item()

            sampler = stats["fused_lmhead_sample"]
            attn = [v["max_abs_err"] for k, v in stats.items() if k != "fused_lmhead_sample"]
            check[f"kv_{kv}"] = {
                "shadow": stats,
                "free_running_agree": {"kernels_vs_plain": agree(fast, plain),
                                       "plain_vs_xla_path": agree(plain, xla)},
            }
            if not (sampler["token_agree"] > 0.95 and sampler["max_abs_err"] < 0.15
                    and max(attn) < 2e-2 and len(stats) == 3):
                emit(check)
                raise AssertionError(f"greedy kernel-vs-plain check failed (kv {kv}): {stats}")
        check["free_running_small"] = free_running_check(kerns, args.seed)
    emit(check)

    # where a decode step's time goes: generate with 9 new tokens minus
    # generate with 1 (prefill and the first sample) leaves 8 decode steps
    with torch.inference_mode():
        windows = {n: profile_window(lambda: generate(
            params, cfg, torch.Generator(), ids, mask, SamplingParams(max_new_tokens=n),
            attn_impl="pallas", decode_params=qparams, decode_attn_impl="pallas",
            kv_quant="int8", device="cuda")) for n in (1, 9)}
    steps = {k: (windows[9][k] - windows[1][k]) / 8 for k in ("wall_ms", "device_busy_ms")}
    emit({"phase": "profile", "what": "generate(kv_quant='int8'), 1 and 9 new tokens",
          "decode_step_wall_ms": steps["wall_ms"],
          "decode_step_device_busy_ms": steps["device_busy_ms"],
          "decode_step_device_idle_share": 1 - steps["device_busy_ms"] / steps["wall_ms"],
          "windows": windows})

    del qleaves
    torch.cuda.empty_cache()

    # 8. K10 and K9 against their plain versions at the new paths' shapes
    with torch.inference_mode():
        new_results, mega = check_new_kernels(cfg, qparams, peaks, args.seed)
    emit({"phase": "engine_kernels", "gpu": gpu, "results": new_results})
    torch.cuda.empty_cache()

    # 9. generate(mega=): phase 3's prompts, the whole decode step in one launch
    with torch.inference_mode():
        def mega_generate(sampling, seed=args.seed + 1):
            return generate(params, cfg, torch.Generator().manual_seed(seed), ids, mask, sampling,
                            attn_impl="pallas", decode_params=qparams, kv_quant="int8", mega=mega,
                            device="cuda")
        out, secs, counts = run_counted(kerns, lambda: mega_generate(sp))
        check_output(out.response_ids.cpu(), out.response_logprobs.cpu(), out.response_mask.cpu(),
                     B, N, cfg.vocab_size)
        want = {**dict.fromkeys(kerns, 0), "flash_attention_fwd": L, "decode_megakernel": N - 1,
                "fused_lmhead_sample": N}
        if counts != want:
            raise AssertionError(f"generate(mega=) launch counts {counts}, expected {want}")
        for k, c in counts.items():
            launches[k] += c
        windows = {n: profile_window(lambda: mega_generate(SamplingParams(max_new_tokens=n)))
                   for n in (1, 9)}
    mega_step = {k: (windows[9][k] - windows[1][k]) / 8 for k in ("wall_ms", "device_busy_ms")}
    emit({"phase": "megakernel_generate", "gpu": gpu, "model": "qwen2_1_5b", "layers": L,
          "batch": B, "new_tokens": N, "cache_len": -(-(P + N) // 128) * 128, "seconds": secs,
          "generated_tokens_per_s": B * N / secs,
          "decode_ms_per_step": (secs * 1e3 - prefill_ms) / (N - 1),
          "per_layer_int8_kv": main["generate_int8_kv"], "launches": counts,
          "decode_step_wall_ms": mega_step["wall_ms"],
          "decode_step_device_busy_ms": mega_step["device_busy_ms"],
          "decode_step_device_idle_share": 1 - mega_step["device_busy_ms"] / mega_step["wall_ms"],
          "by_kernel_ms_9_tokens": windows[9]["by_kernel_ms"]})
    del out

    # 10. shadow mode for K9 and K10 at full size: every kernel call of a
    # 16-token greedy run against its plain version on the same inputs
    from rlinf_tpu_torch.rollout.paged_engine import PagedContinuousEngine
    shadow = {"phase": "engine_shadow", "new_tokens": 16}
    with torch.inference_mode():
        stats = {}
        with kernels_replaced(shadowed(stats), _engine_sites()):
            mega_generate(greedy, 0)
            PagedContinuousEngine(cfg, greedy, num_slots=B, max_seq_len=P + 16, prompt_bucket=bucket,
                                  decode_chunk=15, page_size=16, attn_impl="pallas", device="cuda"
                                  ).rollout(params, request, torch.Generator())
    shadow["shadow"] = stats
    emit(shadow)
    if not (stats["decode_megakernel"]["calls"] == 15
            and stats["decode_megakernel"]["max_rel_err"] < 5e-2
            and stats["paged_attention"]["calls"] == L * 15
            and stats["paged_attention"]["max_abs_err"] < 1e-2):
        raise AssertionError(f"K9/K10 shadow check failed: {stats}")
    del qparams, mega
    torch.cuda.empty_cache()

    # 11. the continuous engine (per-layer and hybrid) and the paged engine
    engine_counts = engine_phases(cfg, params, kerns, gpu, args.seed)
    for k, c in engine_counts.items():
        launches[k] += c
    torch.cuda.empty_cache()

    # 12. whole greedy runs at small size, kernels against plain paths
    with torch.inference_mode():
        emit({"phase": "engine_small_checks", **small_engine_checks(kerns, args.seed)})

    # 5. the training kernels against their plain versions, at one row
    # chunk and one microbatch of the training batch
    from rlinf_tpu_torch.data.io_struct import build_train_batch

    train_mask = build_train_batch(res, np.zeros(res.response_ids.shape, np.float32),
                                   pad_id=0).attention_mask[:16]
    results += check_training_kernels(cfg, train_mask, peaks, args.seed)
    emit({"phase": "training_kernels", "gpu": gpu, "results": results[4:]})
    torch.cuda.empty_cache()

    # 6. the training path on the rollout, then one more step under the profiler
    state, batch, step_fn, train_counts = training_path(cfg, params, res, kerns, gpu, args.seed)
    emit(profile_train_step(state, batch, step_fn))
    del state
    torch.cuda.empty_cache()
    for k, c in train_counts.items():
        launches[k] += c

    # 7. a whole train step, kernels against plain, at a small configuration
    emit({"phase": "whole_step_check", **whole_step_check(kerns, args.seed)})

    results += new_results
    for r in results:
        r["launches"] = launches[r["name"]]
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(gpu, flush=True)
    emit({"kernels": results})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
