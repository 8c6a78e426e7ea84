#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rlinf_tpu_torch``) on one GPU:
the rollout serving path and the GRPO training path.

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


# ---------------------------------------------------------------------------
# Phase 5: the training kernels against their plain versions
# ---------------------------------------------------------------------------

def rel_err(a, b) -> float:
    """max |a - b| over max |b|."""
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


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
            out, ref = kernel(*args, **kwargs), plain(*args, **kwargs)
            st = stats.setdefault(name, {"calls": 0, "max_abs_err": 0.0})
            st["calls"] += 1
            if name == "fused_lmhead_sample":
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

    del qparams, qleaves
    torch.cuda.empty_cache()

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

    for r in results:
        r["launches"] = launches[r["name"]]
    print(gpu, flush=True)
    emit({"kernels": results})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
