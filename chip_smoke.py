#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rlinf_tpu_torch``) on one GPU:
the rollout serving paths (static, megakernel, continuous and paged
engines) and the GRPO training path.

    python3 chip_smoke.py [--seed 0]

Phases, each printing one JSON line:

1. build: compile every kernel of ``rlinf_tpu_torch/csrc`` with nvcc
   (sm_90a), all sources at once, and report the seconds; then ptxas's
   registers and spills and the SASS tensor-core counts of K1, K2, K3, K5,
   K9 and K10, held to their designs (no spill; K5 and K9 on wgmma, K2 and
   K3 on mma.sync).
2. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the shapes of the main path (Qwen2-1.5B, 64 prompts of up
   to 512 tokens, 256 new tokens): error against a stated tolerance, the
   kernel's, the plain version's and one library call's time (CUDA events;
   K2's, K3's and their library call's also from a CUDA-graph replay, their
   ``ms``), and the least time the card could take (bytes or operations at
   the card's published peak). K2 and K3 also at ragged intervals (empty
   rows, rows over split boundaries, Hd=64 with G=7, G=8 at an odd cache
   length; K2 also G=16, its largest, at both head dims). K4
   runs on the head packed once, at B=64 and at B=8, sampled and greedy
   (the difference is what the draws cost).
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
   of the training path (4096 rows, tied [V, D] embedding and the untied
   [D, V] weight, non-zero entropy gradient; K6's two passes read apart
   from a profiler trace; K5 also at a ragged shape: 100 rows, D=100,
   V=1001, T=1.3) and K7/K8 (flash-attention backward) at one microbatch
   of the training batch (16 right-padded rows, T=768; K7 forms delta
   itself), each against its plain version
   with a stated tolerance and timed beside its bound, its plain version
   and a library call; the whole flash_attention_bwd call beside the
   library call; K7/K8 also at ragged shapes (T=700 left-padded at Hd=64,
   Sq=100, a row with no valid key). Then K4 and K6 against their plain
   versions at ragged shapes (K6 also at n=100, D=100, V=1001), and
   causal_attention forward + backward through the kernels and the plain
   path at T = 512-2048 (12,288 tokens each).
6. training path: GRPO on phase 3's rollout (64 rows as 8 groups of 8,
   a stated reward rule on the token ids), ``build_train_batch`` (T=768),
   ``make_logprob_fn`` (recompute), then four ``make_policy_train_step``
   calls at full width and depth (remat, attn_impl="pallas", 4
   microbatches, adamw with master weights, entropy bonus 1e-3): the step
   time is the median of steps 2-4, and each step's seconds stand beside
   the allocator's device allocations and the garbage collector's pauses
   in it. Gates: K1 and K5 launched by the recompute, every training
   kernel launched by the steps, finite loss and grad norm, step-1
   |approx_kl| < 1e-3, params moved. One more step runs under the
   profiler: device time by kernel, with K5's, K6's passes' and K7's and
   K8's time a step read from the whole trace.
7. whole-step check: one train step at check_q8_generate's configuration,
   kernels against the plain path from the same params.

Between phases 4 and 5, the megakernel, continuous and paged paths:

8. engine kernels: K10 (paged attention; 64 rows, 48 pages of 16 tokens a
   row, ragged lengths with a 0) and K9 (the whole-step decode megakernel
   on Qwen2-1.5B packed weights and a random int8 cache: a small shape
   first, then B=64, S=768 with one write slot and with per-row slots, B=8
   and B=96; then at Qwen2-7B's widths, 2 layers, B=64, S=768), each
   against its plain version with stated limits, timed beside its bound,
   K9 also by phase; K10 beside scaled_dot_product_attention, K9 beside the
   device-busy time of one per-layer int8-KV decode step.
9. megakernel generate: ``generate(kv_quant="int8", mega=...)`` on phase
   3's prompts, with the lm head packed once; launch gate K9 = 255, K3 = 0,
   K1 = 28, K4 = 256; the idle share of a decode step.
10. engine shadow: a 16-token greedy ``generate(mega=)`` and a 16-token
   paged-engine run at full size with every K9 / K10 call checked against
   its plain version on the same inputs; then a 16-token greedy
   ``generate(kv_quant="int8", mega=)`` at Qwen2-7B's widths (4 layers)
   with every K9 call checked the same way.
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
import gc
import json
import re
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


def graph_ms(fn, reps: int = 20, iters: int = 10) -> float:
    """Device time of one call with the host's launch overhead out of the
    way: ``reps`` calls captured in one CUDA graph (after three warm-up
    calls), replayed ``iters`` times between CUDA events. For calls whose
    device time is shorter than their host-side dispatch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def bound(nbytes: float, flops: float, peaks):
    bw, fl = peaks
    t_bytes, t_ops = nbytes / bw * 1e3, flops / fl * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# The kernels whose compiler report the build phase prints, by source: the
# __global__ names of csrc/flash_attention_fwd.cu (K1),
# csrc/paged_attention.cu (K10: the split kernel and the merge),
# csrc/linear_ce.cu (K5 and K6's product kernel, PASS 2 being K5's, and
# K5's combine), csrc/decode_attention.cu (K3's and K2's split kernels and
# their merge) and csrc/decode_megakernel.cu (K9).
REPORTED_KERNELS = {"flash_attention_fwd.cu": ("flash_fwd_kernel",),
                    "paged_attention.cu": ("paged_split_kernel", "paged_merge_kernel"),
                    "linear_ce.cu": ("ce_gemm_kernel", "ce_fwd_combine_kernel"),
                    "decode_attention.cu": ("decode_q8_split_kernel", "decode_bf16_split_kernel",
                                            "decode_merge_kernel"),
                    "decode_megakernel.cu": ("mega_kernel",)}


def _kernel_key(mangled: str, names) -> str:
    """'name<args>' (or 'name') of the reported kernel a mangled symbol is,
    its int and bool template arguments kept, else ''."""
    for name in names:
        m = re.search(rf"\d+{name}(I(?:L[ib]\d+E)+E)?", mangled)
        if m:
            args = re.findall(r"L[ib](\d+)E", m.group(1) or "")
            return f"{name}<{', '.join(args)}>" if args else name
    return ""


def ptxas_report(log: str, names) -> dict:
    """{kernel: registers, spill bytes, stack, and ptxas's performance
    notes} of the named kernels, from an ``nvcc -Xptxas -v`` log."""
    out, key = {}, ""
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            key = _kernel_key(m.group(1), names)
            if key:
                out.setdefault(key, {"notes": []})
            continue
        if not key:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[key].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[key]["registers"] = int(m.group(1))
        if re.search(r"C7\d\d\d|Performance Loss|serialized", line):
            out[key]["notes"].append(line.strip())
    return out


def sass_counts(sass: str, names) -> dict:
    """{kernel: count of each tensor-core instruction and of the wgmma
    waits} of the named kernels, from ``cuobjdump -sass`` output: one
    WARPGROUP.DEPBAR for every HGMMA means ptxas serialised the wgmma."""
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        key = _kernel_key(part.split("\n", 1)[0], names)
        if key:
            out[key] = {op: part.count(op) for op in
                        ("HGMMA", "WARPGROUP.DEPBAR", "HMMA", "MOVM", "UBLKCP", "UTMALDG")}
    return out


def kernel_reports() -> dict:
    """ptxas's registers and spills and the SASS instruction counts of the
    REPORTED_KERNELS, from the libraries just built (check_reports holds
    them to their designs)."""
    import shutil

    from rlinf_tpu_torch.ops.cuda import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for src, names in REPORTED_KERNELS.items():
        sass = subprocess.run([tool, "-sass", str(_build._library_path(src))], capture_output=True,
                              text=True, check=True, timeout=120).stdout
        out[src] = {"ptxas": ptxas_report(_build.build_log(src), names),
                    "sass": sass_counts(sass, names)}
    return out


def check_reports(reports: dict) -> None:
    """Raise unless no reported kernel spills, K5's product kernel (PASS 2
    of ce_gemm_kernel) runs on wgmma (HGMMA, no HMMA) with fewer wgmma waits
    than products, K9's products run on wgmma (HGMMA; its attention on
    mma.sync) and K2's and K3's split kernels run on mma.sync (HMMA)."""
    bad = [k for rep in reports.values() for k, r in rep["ptxas"].items()
           if r.get("spill_stores") or r.get("spill_loads")]
    sass = {k: v for rep in reports.values() for k, v in rep["sass"].items()}
    k5 = {k: v for k, v in sass.items() if k.startswith("ce_gemm_kernel<2")}
    k3 = {k: v for k, v in sass.items() if k.startswith("decode_q8_split_kernel")}
    k2 = {k: v for k, v in sass.items() if k.startswith("decode_bf16_split_kernel")}
    k9 = {k: v for k, v in sass.items() if k.startswith("mega_kernel")}
    bad += [k for k, v in k5.items()
            if not (v["HGMMA"] > 0 and v["HMMA"] == 0 and v["WARPGROUP.DEPBAR"] < v["HGMMA"])]
    bad += [k for k, v in {**k3, **k2}.items() if not v["HMMA"] > 0]
    bad += [k for k, v in k9.items() if not v["HGMMA"] > 0]
    if bad or len(k5) != 2 or len(k3) != 2 or len(k2) != 2 or len(k9) != 2:
        raise AssertionError(f"kernel reports: {bad} (K5 {sorted(k5)}, K3 {sorted(k3)}, "
                             f"K2 {sorted(k2)}, K9 {sorted(k9)})")


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

def k1_figures(rot, pos, valid, peaks) -> dict:
    """K1 on the first of ``rot``'s (q, k, v) sets against its plain
    version (o and lse max-abs error < 2e-2, else raise), its time over the
    rotated sets, the plain version's and scaled_dot_product_attention's
    (CUDA events), and its bound: the bytes of q, k, v, the masks, o and lse,
    or 4 Hd operations per unmasked (query, key) pair and head."""
    from rlinf_tpu_torch.ops.cuda import flash_attention as FA

    q, k, v = rot.sets[0]
    B, T, H, Hd = q.shape
    G = H // k.shape[2]
    valid_u8 = valid.to(torch.uint8)
    scale = Hd**-0.5
    o, lse = FA.flash_attention_fwd(q, k, v, pos, pos, valid_u8, scale)
    o_ref, lse_ref = FA.flash_attention_fwd_plain(q, k, v, pos, pos, valid_u8, scale)
    torch.cuda.synchronize()
    err = (o.float() - o_ref.float()).abs().max().item()
    lse_err = (lse - lse_ref).abs().max().item()
    del o_ref, lse_ref
    if not err < 2e-2 or not lse_err < 2e-2:
        raise AssertionError(f"K1 disagrees with its plain version at {tuple(q.shape)}: "
                             f"{err} (lse {lse_err})")
    ms = cuda_ms(lambda: FA.flash_attention_fwd(*rot.next(), pos, pos, valid_u8, scale), 20,
                 warmup=5)
    plain_ms = cuda_ms(lambda: FA.flash_attention_fwd_plain(q, k, v, pos, pos, valid_u8, scale), 3)
    mask4 = ((pos[:, None, :] <= pos[:, :, None]) & valid[:, None, :])[:, None]
    qt, kt, vt = (q.transpose(1, 2), k.repeat_interleave(G, 2).transpose(1, 2),
                  v.repeat_interleave(G, 2).transpose(1, 2))
    lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask4), 10, warmup=3)
    pairs = int(mask4.sum().item())
    b_ms, b_by = bound(nbytes(q, k, v, pos, pos, valid_u8, o, lse), 4.0 * Hd * H * pairs, peaks)
    return dict(max_abs_err=err, lse_max_abs_err=lse_err, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, unmasked_pairs=pairs)


def check_kernels(cfg, B, P, N, prompt_lens, peaks, seed):
    from rlinf_tpu_torch.models.llm.quant import quantize_tensor
    from rlinf_tpu_torch.ops.cuda import decode_attention as DA
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
    rot = Rotation(lambda: (randn(B, P, H, Hd), randn(B, P, Kv, Hd), randn(B, P, Kv, Hd)), 3)
    k1 = k1_figures(rot, pos, valid, peaks)
    results.append(dict(
        name="flash_attention_fwd", route="cuda",
        source="rlinf_tpu_torch/csrc/flash_attention_fwd.cu",
        replaces="rlinf_tpu/ops/pallas/flash_attention.py:166",
        shapes=f"prefill: q[{B},{P},{H},{Hd}] k/v[{B},{P},{Kv},{Hd}] bf16, left-padded",
        **k1, tolerance=2e-2, library="scaled_dot_product_attention",
        ragged=flash_fwd_ragged(randn)))
    del rot

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
    k2_rel = head_rel_err(out, ref)
    if not (err < 2e-2 and k2_rel < K3_TOL_REL):
        raise AssertionError(f"K2 disagrees with its plain version: {err}, relative {k2_rel}")
    call = lambda: DA.decode_attention_packed(*rot.next(), starts, lengths, num_kv=Kv)
    ms = graph_ms(call)
    eager_ms = cuda_ms(call, 50, warmup=5)
    plain_ms = cuda_ms(lambda: DA.decode_attention_packed_xla(
        qd, kc, vc, starts, lengths, num_kv=Kv), 10)
    library = sdpa_decode(qd, kc, vc)
    lib_ms = graph_ms(library)
    lib_eager_ms = cuda_ms(library, 20)
    b_ms, b_by = bound(nbytes(qd, starts, lengths, out) + 2 * slots * KD * 2,
                       4.0 * Hd * H * slots, peaks)
    results.append(dict(
        name="decode_attention_bf16", route="cuda",
        source="rlinf_tpu_torch/csrc/decode_attention.cu",
        replaces="rlinf_tpu/ops/pallas/decode_attention.py:200",
        shapes=f"q[{B},{H},{Hd}] cache[{B},{S_max},{KD}] bf16, {slots} valid slots",
        max_abs_err=err, tolerance=2e-2, rel_err=k2_rel, tolerance_rel=K3_TOL_REL, ms=ms,
        eager_ms=eager_ms, plain_ms=plain_ms, library_ms=lib_ms, library_eager_ms=lib_eager_ms,
        library="scaled_dot_product_attention",
        timing="ms, library_ms: device time of one call, replayed from a CUDA graph (the split "
               "kernel and the merge); eager_ms, library_eager_ms: CUDA events around calls "
               "made one after another, the host's dispatch included",
        split_plan=DA.split_plan(B * Kv, -(-S_max // DA.KEY_BLOCK),
                                 torch.cuda.get_device_properties(0).multi_processor_count),
        bound_ms=b_ms, bound_by=b_by, ragged=decode_ragged(randn, RAGGED_BF16, q8=False)))
    del rot

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
    k3_rel = head_rel_err(out, ref)
    if not (err < 2e-2 and k3_rel < K3_TOL_REL):
        raise AssertionError(f"K3 disagrees with its plain version: {err}, relative {k3_rel}")
    call = lambda: DA.decode_attention_packed_q8(*rot.next(), starts, lengths, num_kv=Kv)
    ms = graph_ms(call)
    eager_ms = cuda_ms(call, 50, warmup=5)
    plain_ms = cuda_ms(lambda: DA.decode_attention_packed_q8_xla(
        qd, kq, vq, ks, vs, starts, lengths, num_kv=Kv), 10)
    kdq = (kq.float() * ks[..., None]).bfloat16()
    vdq = (vq.float() * vs[..., None]).bfloat16()
    library = sdpa_decode(qd, kdq, vdq)
    lib_ms = graph_ms(library)
    lib_eager_ms = cuda_ms(library, 20)
    b_ms, b_by = bound(nbytes(qd, starts, lengths, out) + 2 * slots * (KD + 4),
                       4.0 * Hd * H * slots, peaks)
    results.append(dict(
        name="decode_attention_q8", route="cuda",
        source="rlinf_tpu_torch/csrc/decode_attention.cu",
        replaces="rlinf_tpu/ops/pallas/decode_attention.py:418",
        shapes=f"q[{B},{H},{Hd}] cache[{B},{S_max},{KD}] int8 + scales, {slots} valid slots",
        max_abs_err=err, tolerance=2e-2, rel_err=k3_rel, tolerance_rel=K3_TOL_REL, ms=ms,
        eager_ms=eager_ms, plain_ms=plain_ms, library_ms=lib_ms, library_eager_ms=lib_eager_ms,
        library="scaled_dot_product_attention on dequantized bf16",
        timing="ms, library_ms: device time of one call, replayed from a CUDA graph (the split "
               "kernel and the merge); eager_ms, library_eager_ms: CUDA events around calls "
               "made one after another, the host's dispatch included",
        split_plan=DA.split_plan(B * Kv, -(-S_max // DA.KEY_BLOCK),
                                 torch.cuda.get_device_properties(0).multi_processor_count),
        bound_ms=b_ms, bound_by=b_by, ragged=decode_ragged(randn, RAGGED_Q8, q8=True)))
    del rot, kdq, vdq

    # --- K4: fused int8 lm-head sampler at [B, D] x [D, V], on the head
    # packed once (as the serving paths hold it), at B and at 8 rows -------
    lm = quantize_tensor(randn(D, V, scale=0.02, dtype=torch.float32))
    lm_q, lm_s = lm.q, lm.scale
    head = SK.pack_lm_head(lm_q, lm_s)
    lm_bf16 = (lm_q.float() * lm_s).bfloat16()
    k4 = {}
    for rows in (B, 8):
        hidden = randn(rows, D)
        tok, lp = SK.fused_lmhead_sample_packed(hidden, head, 3, greedy=True)
        tok_r, lp_r = SK.fused_lmhead_sample_plain(hidden, lm_q, lm_s, 3, greedy=True)
        tok_s, lp_s = SK.fused_lmhead_sample_packed(hidden, head, 11, temperature=0.9)
        tok_sr, _ = SK.fused_lmhead_sample_plain(hidden, lm_q, lm_s, 11, temperature=0.9)
        z = (hidden.float() @ lm_q.float()) * lm_s.reshape(1, V) / 0.9
        lp_given = torch.log_softmax(z, -1).gather(1, tok_s.long()[:, None])[:, 0]
        torch.cuda.synchronize()
        greedy_agree = (tok == tok_r).float().mean().item()
        err = (lp - lp_r).abs().max().item()
        sampled_lp_err = (lp_s - lp_given).abs().max().item()
        ms = cuda_ms(lambda: SK.fused_lmhead_sample_packed(hidden, head, 5, temperature=1.0), 20)
        # the same product and stream without the draws
        greedy_ms = cuda_ms(lambda: SK.fused_lmhead_sample_packed(hidden, head, 5, greedy=True), 20)
        plain_ms = cuda_ms(lambda: SK.fused_lmhead_sample_plain(
            hidden, lm_q, lm_s, 5, temperature=1.0), 3)

        def library():
            logits = torch.matmul(hidden, lm_bf16).float()
            return torch.log_softmax(logits, -1), logits.argmax(-1)

        lib_ms = cuda_ms(library, 10)
        b_ms, b_by = bound(nbytes(hidden, head.w, head.scale, tok, lp), 2.0 * rows * D * V, peaks)
        k4[rows] = dict(
            shapes=f"hidden[{rows},{D}] bf16, lm head [{D},{V}] int8 packed",
            max_abs_err=err, tolerance=5e-3, greedy_token_agreement=greedy_agree,
            sampled_token_agreement=(tok_s == tok_sr).float().mean().item(),
            sampled_logprob_err=sampled_lp_err, ms=ms, greedy_ms=greedy_ms, plain_ms=plain_ms,
            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        if greedy_agree != 1.0 or not err < 5e-3 or not sampled_lp_err < 5e-3:
            raise AssertionError(
                f"K4 disagrees with its plain version at B={rows}: greedy agreement "
                f"{greedy_agree}, lp err {err}, sampled lp err {sampled_lp_err}")
    results.append(dict(
        name="fused_lmhead_sample", route="cuda", source="rlinf_tpu_torch/csrc/sampler.cu",
        replaces="rlinf_tpu/ops/pallas/sampler_kernel.py:167", **k4[B],
        library="matmul(bf16) + log_softmax + argmax", at_batch_8=k4[8]))
    return results


# (B, S, H, Kv, Hd, starts, lengths) of K3's ragged cases: Qwen2-1.5B's
# heads with an empty row (start == length), a row whose start > length, a
# row of one slot and a row with start > 0 that runs over split boundaries
# (runs of 4 blocks here); Qwen2-0.5B's (Hd=64, G=7) with empty rows and
# rows ending past S; G=8 at an odd S, a partial last block past it, and
# an empty row. K2 takes the same cases and G=16, its largest, at both
# head dims.
RAGGED_Q8 = (
    (8, 300, 12, 2, 128, [0, 5, 37, 17, 299, 120, 64, 250], [300, 5, 250, 3, 300, 121, 300, 251]),
    (8, 300, 14, 2, 64, [0, 3, 200, 16, 31, 0, 250, 7], [300, 290, 201, 16, 400, 0, 299, 170]),
    (5, 77, 16, 2, 128, [0, 1, 60, 2, 30], [77, 76, 77, 3, 30]))
RAGGED_BF16 = RAGGED_Q8 + (
    (6, 211, 32, 2, 128, [0, 9, 100, 40, 210, 3], [211, 9, 211, 41, 300, 150]),
    (6, 133, 32, 2, 64, [0, 17, 5, 0, 64, 70], [133, 17, 120, 1, 129, 133]))

# K3's bar beside the max-abs 2e-2, per (row, query head): max-abs error
# over max |plain| of that head's output < 1e-2 (``head_rel_err``). The
# output is bf16, whose step is at most 2^-8 (3.9e-3) of the head's largest
# output, and two correct results differ by about one step; one stale slot
# in a row of ~450 moves its outputs by ~1e-3 absolute, ~1e-2 of their
# largest at the main shape. Per head, so that a short row's large outputs
# do not set the bar of a long row.
K3_TOL_REL = 1e-2


def decode_ragged(randn, cases, q8: bool) -> dict:
    """K3 (``q8``) or K2 against its plain version at ``cases``, at the main
    check's bars (max-abs error < 2e-2, relative error < K3_TOL_REL); a row
    with an empty interval must give exactly 0."""
    from rlinf_tpu_torch.ops.cuda import decode_attention as DA

    out = {}
    for B, S, H, Kv, Hd, st, ln in cases:
        starts = torch.as_tensor(st, dtype=torch.int32, device="cuda")
        lengths = torch.as_tensor(ln, dtype=torch.int32, device="cuda")
        k, v, q = randn(B, S, Kv * Hd, scale=0.5), randn(B, S, Kv * Hd, scale=0.5), randn(B, H, Hd)
        if q8:
            kq, ks = DA.quantize_kv_token(k)
            vq, vs = DA.quantize_kv_token(v)
            got = DA.decode_attention_packed_q8(q, kq, vq, ks, vs, starts, lengths, num_kv=Kv)
            ref = DA.decode_attention_packed_q8_xla(q, kq, vq, ks, vs, starts, lengths, num_kv=Kv)
        else:
            got = DA.decode_attention_packed(q, k, v, starts, lengths, num_kv=Kv)
            ref = DA.decode_attention_packed_xla(q, k, v, starts, lengths, num_kv=Kv)
        torch.cuda.synchronize()
        empty = [b for b in range(B) if min(ln[b], S) <= max(st[b], 0)]
        key = f"B={B} S={S} H={H} Kv={Kv} Hd={Hd}"
        out[key] = {"max_abs_err": (got.float() - ref.float()).abs().max().item(),
                    "rel_err": head_rel_err(got, ref), "empty_rows": empty,
                    "empty_rows_zero": all(bool((got[b] == 0).all().item()) for b in empty)}
        if not (out[key]["max_abs_err"] < 2e-2 and out[key]["rel_err"] < K3_TOL_REL
                and empty and out[key]["empty_rows_zero"]):
            raise AssertionError(f"{'K3' if q8 else 'K2'} at {key}: {out[key]}")
    return out


def rel_err(a, b) -> float:
    """max |a - b| over max |b|."""
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def head_rel_err(got, ref) -> float:
    """Decode attention [B, H, Hd]: the largest, over (row, head), of the
    max-abs error over max |ref| of that head's output; heads whose ref is
    all 0 (empty rows, held to exactly 0 apart) are left out."""
    got, ref = got.float(), ref.float()
    scale = ref.abs().amax(-1)
    keep = scale > 0
    err = (got - ref).abs().amax(-1)
    return (err[keep] / scale[keep]).max().item() if bool(keep.any()) else 0.0


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


def mega_phase_us(MK, plan, mw, cache, args) -> dict:
    """K9's time by phase from the device's timer as CTA 0 sees it (the
    mean over layers of each phase up to its grid barrier), the prologue
    and the whole launch, in microseconds."""
    clock = torch.zeros((plan.L * len(MK.PHASES) + 2,), dtype=torch.int64, device="cuda")
    MK.decode_step_mega(plan, mw, args[0], *cache, *args[1:], phase_clock=clock)
    edges = clock.cpu().numpy()
    spans = np.diff(edges[1:]).reshape(plan.L, len(MK.PHASES)) / 1e3
    out = {name: float(spans[:, i].mean()) for i, name in enumerate(MK.PHASES)}
    out["prologue"] = float(edges[1] - edges[0]) / 1e3
    out["whole_launch"] = float(edges[-1] - edges[0]) / 1e3
    return out


def mega_bound(plan, mw, B, valid_slots, peaks):
    """K9's bound: every weight byte and the valid int8 cache read once, the
    embedded and final rows and the written slots moved once; 2 flops a
    weight byte a row and 4 Hd flops a query head and slot."""
    KVD, L = plan.KVD, plan.L
    moved = (nbytes(mw.stream, mw.scales, mw.norms, mw.bias) + 2 * B * plan.D * 2
             + L * valid_slots * (2 * KVD + 8) + L * B * (2 * KVD + 8))
    return bound(moved, 2.0 * B * plan.layer_bytes * L
                 + 4.0 * plan.Hd * plan.H * (valid_slots + B) * L, peaks)


MEGA_BARS = {"hidden_rel": 5e-2, "k_rel": 3e-2, "v_rel": 3e-2}


def mega_bad(cases: dict) -> list:
    """The K9 cases that miss a bar of MEGA_BARS, are not finite or touched
    a slot other than the written one."""
    return [k for k, v in cases.items()
            if not (all(v[m] < bar for m, bar in MEGA_BARS.items())
                    and v["finite"] and v["other_slots_untouched"])]


def mega_qwen2_7b(MK, g, peaks, seed) -> dict:
    """K9 at Qwen2-7B's widths (D=3584, F=18944, H=28, Kv=4, Hd=128; 2 of
    its 28 layers, random weights from the seed) against its plain version
    at the Qwen2-1.5B case's bars: B=64, S=768 with one write slot and with
    per-row slots; timed beside its bound, with its time by phase."""
    import dataclasses

    from rlinf_tpu_torch.models.llm import model as M
    from rlinf_tpu_torch.models.llm.config import LLMConfig
    from rlinf_tpu_torch.models.llm.quant import quantize_params

    cfg = dataclasses.replace(LLMConfig.qwen2_7b(), num_layers=2)
    qp = quantize_params(M.init_params(cfg, seed + 7, device="cuda"))
    plan, mw = MK.pack_decode_weights(qp, cfg, chunk_width=cfg.hidden_size)
    dev = g.device
    B, S, slot = 64, 768, 640
    plens = torch.randint(128, 513, (B,), generator=g, device=dev, dtype=torch.int32)
    starts = (512 - plens).to(torch.int32)
    cases = {}
    cases["uniform"], cache, args = mega_case(MK, plan, mw, cfg, qp, B, S, slot,
                                              (plens + 128).to(torch.int32), starts, g)
    ms = cuda_ms(lambda: MK.decode_step_mega(plan, mw, args[0], *cache, *args[1:]), 5)
    plain_ms = cuda_ms(lambda: MK.decode_step_mega_plain(plan, mw, args[0], *cache, *args[1:]),
                       1, warmup=1)
    phase_us = mega_phase_us(MK, plan, mw, cache, args)
    del cache
    wps = torch.randint(8, S - 1, (B,), generator=g, device=dev, dtype=torch.int32)
    wps[0], wps[1] = 0, S - 1
    zeros = torch.zeros((B,), dtype=torch.int32, device=dev)
    cases["ragged"], cache, _ = mega_case(MK, plan, mw, cfg, qp, B, S, wps, wps, zeros, g)
    del cache
    b_ms, b_by = mega_bound(plan, mw, B, int((slot - starts).sum().item()), peaks)
    return dict(shapes=f"x0[{B},{plan.D}] bf16, {plan.L} layers of int8 weights "
                       f"({plan.layer_bytes} B a layer), cache[{plan.L},{B},{S},{plan.KVD}] int8",
                schedule=MK.mega_schedule(plan, B, S, torch.cuda.get_device_properties(0)
                                          .multi_processor_count)._asdict(),
                cases=cases, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                phase_us_mean_over_layers=phase_us)


def paged_case(g, B, H, Kv, Hd, Pg, max_pages, peaks, timed=True) -> dict:
    """K10 against its plain version (max-abs error < 1e-2, the row of
    length 0 exactly 0, else raise) on a random pool and page table of B
    rows whose lengths are random but for rows of 0, 1 and max_pages * Pg
    tokens; with ``timed``, its time beside its plain version, SDPA on the
    pages gathered beforehand, and its bound (the valid pages' bytes, or 4
    Hd operations per valid token and head)."""
    from rlinf_tpu_torch.ops.cuda import paged_attention as PA

    dev = torch.device("cuda")
    G = H // Kv
    num_pages = 1 + B * max_pages
    lengths = torch.randint(2, max_pages * Pg, (B,), generator=g, device=dev, dtype=torch.int32)
    lengths[3 % B], lengths[5 % B], lengths[6 % B] = 0, max_pages * Pg, 1
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

    rot = Rotation(pools, 3 if timed else 1)
    kp, vp = rot.sets[0]
    q = torch.randn((B, H, Hd), generator=g, device=dev).to(torch.bfloat16)
    out = PA.paged_attention(q, kp, vp, table, lengths)
    ref = PA.paged_attention_xla(q, kp, vp, table, lengths)
    torch.cuda.synchronize()
    tokens = int(lengths.sum().item())
    r = {"shapes": f"q[{B},{H},{Hd}] pages[{num_pages},{Kv},{Pg},{Hd}] bf16 table[{B},{max_pages}], "
                   f"{tokens} valid tokens, rows of 0, 1 and {max_pages * Pg} tokens",
         "max_abs_err": (out.float() - ref.float()).abs().max().item(),
         "empty_row_max_abs": out[3 % B].float().abs().max().item(),
         "split_plan": PA.split_plan(B * Kv, max_pages, torch.cuda.get_device_properties(0)
                                     .multi_processor_count)}
    if not r["max_abs_err"] < 1e-2 or r["empty_row_max_abs"] != 0.0:
        raise AssertionError(f"K10 disagrees with its plain version at {r['shapes']}: {r}")
    if not timed:
        return r
    call = lambda: PA.paged_attention(q, *rot.next(), table, lengths)
    r["ms"] = graph_ms(call)
    r["eager_ms"] = cuda_ms(call, 50, warmup=5)
    r["plain_ms"] = cuda_ms(lambda: PA.paged_attention_xla(q, kp, vp, table, lengths), 10)
    S = max_pages * Pg
    dense = lambda p: p[table.long()].permute(0, 2, 1, 3, 4).reshape(B, Kv, S, Hd)
    kd = dense(kp).repeat_interleave(G, 1)
    vd = dense(vp).repeat_interleave(G, 1)
    smask = (torch.arange(S, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    library = lambda: torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None, :], kd, vd, attn_mask=smask)
    r["library_ms"] = graph_ms(library)
    r["library_eager_ms"] = cuda_ms(library, 20)
    r["bound_ms"], r["bound_by"] = bound(
        nbytes(q, out, lengths) + int(used.sum().item()) * 4 + 2 * tokens * Kv * Hd * 2,
        4.0 * Hd * H * tokens, peaks)
    return r


def check_new_kernels(cfg, qparams, peaks, seed):
    """K10 at the paged engine's shapes (64 rows, 48 pages of 16 tokens a
    row, ragged lengths with rows of 0, 1 and all tokens) and at 8 rows,
    then at other geometries (Hd=64 with G=7, G=16, pages of 32 and of 8
    tokens); and K9 on Qwen2-1.5B packed weights and a random int8 cache:
    first at a small shape (a grid that does not fit deadlocks rather than
    errs), then B=64, S=768 with one write slot and with ragged per-row
    slots, and at B=8 and B=96 (two row blocks of the kernel); then at
    Qwen2-7B's widths (``mega_qwen2_7b``)."""
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
    main = paged_case(g, 64, H, Kv, Hd, 16, 48, peaks)
    b8 = paged_case(g, 8, H, Kv, Hd, 16, 48, peaks)
    geometries = {}
    for B, Hq, Kvq, Hdq, Pg, pages in ((16, 14, 2, 64, 16, 20), (16, 32, 2, 128, 16, 20),
                                       (16, H, Kv, Hd, 32, 24), (16, 14, 2, 64, 8, 40)):
        r = paged_case(g, B, Hq, Kvq, Hdq, Pg, pages, peaks, timed=False)
        geometries[r.pop("shapes")] = r
    results.append(dict(
        name="paged_attention", route="cuda", source="rlinf_tpu_torch/csrc/paged_attention.cu",
        replaces="rlinf_tpu/ops/pallas/paged_attention.py:152", **main, tolerance=1e-2,
        library="scaled_dot_product_attention on pages gathered beforehand",
        timing="ms, library_ms: device time of one call, replayed from a CUDA graph (the split "
               "kernel and the merge); eager_ms, library_eager_ms: CUDA events around calls "
               "made one after another, the host's dispatch included",
        at_batch_8=b8, geometries=geometries))

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
    phase_us = mega_phase_us(MK, plan, mw, cache, args)
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
    w96 = torch.randint(8, S - 1, (96,), generator=g, device=dev, dtype=torch.int32)
    k9["ragged_b96"], cache, _ = mega_case(MK, plan, mw, cfg, qparams, 96, S, w96, w96,
                                           torch.zeros(96, dtype=torch.int32, device=dev), g)
    del cache

    KVD, L = plan.KVD, plan.L
    b_ms, b_by = mega_bound(plan, mw, B, valid_slots, peaks)
    worst = {k: max(v[k] for v in k9.values()) for k in ("hidden_rel", "k_rel", "v_rel")}
    k9_7b = mega_qwen2_7b(MK, g, peaks, seed)
    results.append(dict(
        name="decode_megakernel", route="cuda", source="rlinf_tpu_torch/csrc/decode_megakernel.cu",
        replaces="rlinf_tpu/ops/pallas/decode_megakernel.py:598",
        shapes=f"x0[{B},{plan.D}] bf16, {L} layers of int8 weights ({plan.layer_bytes} B a layer), "
               f"cache[{L},{B},{S},{KVD}] int8 + scales, {valid_slots} valid slots a layer",
        max_abs_err=max(v["hidden_abs"] for v in k9.values()), rel_err=worst, cases=k9,
        tolerance_rel=MEGA_BARS, schedule=MK.mega_schedule(
            plan, B, S, torch.cuda.get_device_properties(0).multi_processor_count)._asdict(),
        ms=ms, ragged_ms=ragged_ms, b8_ms=b8_ms, plain_ms=plain_ms, library_ms=None,
        per_layer_step_device_busy_ms=per_layer_busy, phase_us_mean_over_layers=phase_us,
        comparison="no one PyTorch call computes a whole step; per_layer_step_device_busy_ms is "
                   "the device-busy time of one decode_step_packed_q8 step (K3 and eager "
                   "PyTorch, 28 layers) at the same shape",
        bound_ms=b_ms, bound_by=b_by, qwen2_7b=k9_7b))
    bad = mega_bad(k9) + [f"qwen2_7b {k}" for k in mega_bad(k9_7b["cases"])]
    if bad:
        raise AssertionError(f"K9 disagrees with its plain version in {bad}: {k9}, {k9_7b}")
    return results[::-1], (plan, mw)      # K9, then K10


# ---------------------------------------------------------------------------
# Phase 5: the training kernels against their plain versions
# ---------------------------------------------------------------------------


def check_training_kernels(cfg, attention_mask, peaks, seed):
    """K5/K6 at one row chunk of the training path (4096 rows, the tied
    [V, D] embedding) and K1, K7/K8 at one microbatch (the training batch's
    first 16 rows, right-padded, T=768) -> (K5-K8's results, K1's figures
    at the microbatch)."""
    from rlinf_tpu_torch.ops.cuda import flash_attention as FA
    from rlinf_tpu_torch.ops.cuda import linear_ce as LCE

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 20)
    H, Kv, Hd, D, V = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_, cfg.hidden_size, cfg.vocab_size
    G = H // Kv
    results = []

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    # --- K5: fused linear-CE forward, the tied [V, D] layout of the training
    # path and the untied [D, V] one ------------------------------------------
    n = 4096
    h, w = randn(n, D), randn(V, D, scale=0.02)
    tgt = torch.randint(0, V, (n,), generator=g, device=dev, dtype=torch.int32)
    k5 = {}
    for layout in ("vd", "dv"):
        wl_ = w if layout == "vd" else w.t().contiguous()
        got = LCE.ce_forward(h, wl_, tgt, 1.0, layout)
        ref = LCE.ce_forward_plain(h, wl_, tgt, 1.0, layout)
        torch.cuda.synchronize()
        errs = [(a - b).abs().max().item() for a, b in zip(got, ref)]
        del ref
        k5[layout] = dict(max_abs_err=max(errs), lp_ent_lse_err=errs,
                          ms=cuda_ms(lambda: LCE.ce_forward(h, wl_, tgt, 1.0, layout), 3, warmup=1))
        if not max(errs) < 2e-3:
            raise AssertionError(f"K5 ({layout}) disagrees with its plain version: {errs}")
        if layout == "vd":
            lp, ent, lse = got
        del wl_, got
        torch.cuda.empty_cache()
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
        **k5["vd"], tolerance=2e-3, plain_ms=plain_ms, library_ms=lib_ms,
        library="matmul(bf16) + log_softmax + gather/entropy", bound_ms=b_ms, bound_by=b_by,
        untied_dv=k5["dv"], ragged=k5_ragged(g)))

    # --- K6: fused linear-CE backward (non-zero entropy gradient), the tied
    # [V, D] layout of the training path and the untied [D, V] one; the
    # passes read apart from a profiler trace --------------------------------
    g_lp, g_ent = randn(n, dtype=torch.float32), randn(n, scale=0.1, dtype=torch.float32)
    mu = lse - ent
    lpv, entv = library()
    loss = (lpv * g_lp + entv * g_ent).sum()
    lib_ms = cuda_ms(lambda: torch.autograd.grad(loss, (hl,), retain_graph=True), 3, warmup=1)
    del lpv, entv, loss, hl, wl
    torch.cuda.empty_cache()
    k6 = {}
    for layout in ("vd", "dv"):
        wl_ = w if layout == "vd" else w.t().contiguous()
        args = (h, wl_, tgt, lse, mu, g_lp, g_ent, 1.0, layout)
        dz, dh = LCE.ce_backward(*args)
        dz_r, dh_r = LCE.ce_backward_plain(*args)
        dw = LCE.weight_grad(h, dz, layout, V, w.dtype)
        dw_r = LCE.weight_grad(h, dz_r, layout, V, w.dtype)
        torch.cuda.synchronize()
        errs = {"dz": rel_err(dz, dz_r), "dh": rel_err(dh, dh_r), "dw": rel_err(dw, dw_r)}
        dh_abs = (dh.float() - dh_r.float()).abs().max().item()
        del dz_r, dh_r, dw, dw_r
        torch.cuda.empty_cache()
        ms = cuda_ms(lambda: LCE.ce_backward(*args), 3, warmup=1)
        plain_ms = cuda_ms(lambda: LCE.ce_backward_plain(*args), 2, warmup=1)
        traced_ms, traced_n = device_ms_by_kernel(lambda: LCE.ce_backward(*args), K6_TRACED_CALLS)
        by_pass = k6_passes(traced_ms, 2.0 * n * D * V)
        by_pass["launches_traced"] = {p: sum(c for key, c in traced_n.items() if name in key)
                                      for p, name in K6_PASSES}
        b_ms, b_by = bound(nbytes(h, wl_, tgt, lse, mu, g_lp, g_ent, dz, dh), 4.0 * n * D * V, peaks)
        k6[layout] = dict(max_abs_err=dh_abs, rel_err=errs, tolerance_rel=1e-2, ms=ms,
                          plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, **by_pass)
        if not max(errs.values()) < 1e-2:
            raise AssertionError(f"K6 ({layout}) disagrees with its plain version: {errs}")
        del wl_, args, dz, dh
        torch.cuda.empty_cache()
    results.append(dict(
        name="linear_ce_bwd", route="cuda", source="rlinf_tpu_torch/csrc/linear_ce.cu",
        replaces="rlinf_tpu/ops/pallas/linear_ce.py:283",
        shapes=f"as K5, dz[{n},{LCE._v_pad(V)}] bf16 out", **k6["vd"], library_ms=lib_ms,
        library="autograd backward of the K5 library call, d/dh", untied_dv=k6["dv"]))
    del h, w, tgt, lp, ent, lse, mu
    torch.cuda.empty_cache()

    # --- K7 / K8: flash-attention backward at one microbatch ----------------
    valid = torch.as_tensor(attention_mask, device=dev)
    B, T = valid.shape
    pos = (valid.to(torch.int32).cumsum(-1) - 1).clamp_min(0).to(torch.int32)
    # K1 at the microbatch: the forward of the train step
    k1_train = k1_figures(Rotation(lambda: (randn(B, T, H, Hd), randn(B, T, Kv, Hd),
                                            randn(B, T, Kv, Hd)), 2), pos, valid, peaks)
    k1_train["shapes"] = f"train microbatch: q[{B},{T},{H},{Hd}] k/v[{B},{T},{Kv},{Hd}], right-padded"
    args = flash_bwd_inputs(randn, pos, valid, H, Kv, Hd)
    q, k, v, _, _, valid_u8, o, lse, do, scale = args
    (dq, dk, dv), errs, abs_errs = flash_bwd_errors(args)
    delta = torch.empty((B, H, T), dtype=torch.float32, device=dev)
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), pos.data_ptr(),
              valid_u8.data_ptr())

    def dims():
        return (B, T, T, H, Kv, Hd, float(scale), torch.cuda.current_stream().cuda_stream)

    def k7():
        FA.KERNEL_DQ(0, *common, o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                     dq.data_ptr(), *dims())

    def k8():
        FA.KERNEL_DKV(0, *common, do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                      dv.data_ptr(), *dims())

    k7()
    torch.cuda.synchronize()
    delta_err = rel_err(delta, FA._delta(o, do))
    # right after the multi-GB plain version, a few calls read high: each
    # timer warms up on ten calls first
    ms_dq, ms_dkv = cuda_ms(k7, 50, warmup=10), cuda_ms(k8, 50, warmup=10)
    # the whole call (K7 with its delta, then K8) beside the library's one
    # call in the same run: the comparison that counts
    whole_ms = cuda_ms(lambda: FA.flash_attention_bwd(*args), 50, warmup=10)
    plain_ms = cuda_ms(lambda: FA.flash_attention_bwd_plain(*args), 2, warmup=1)
    mask = (pos[:, None, :] <= pos[:, :, None]) & valid[:, None, :]
    ql = q.transpose(1, 2).detach().requires_grad_(True)
    kl_ = k.detach().requires_grad_(True)
    vl = v.detach().requires_grad_(True)
    ol = torch.nn.functional.scaled_dot_product_attention(
        ql, kl_.repeat_interleave(G, 2).transpose(1, 2), vl.repeat_interleave(G, 2).transpose(1, 2),
        attn_mask=mask[:, None])
    do_t = do.transpose(1, 2)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(ol, (ql, kl_, vl), do_t, retain_graph=True), 50,
                     warmup=10)
    del ql, kl_, vl, ol, do_t
    ragged = flash_bwd_ragged(randn)
    pairs = int(mask.sum().item())
    common_fields = dict(
        source="rlinf_tpu_torch/csrc/flash_attention_bwd.cu",
        shapes=f"q/do[{B},{T},{H},{Hd}] k/v[{B},{T},{Kv},{Hd}] bf16, right-padded rows",
        max_abs_err=max(abs_errs.values()), rel_err=errs, tolerance_rel=2e-2,
        plain_ms=plain_ms, plain="dq, dk and dv together (delta included)", library_ms=lib_ms,
        library="autograd backward of scaled_dot_product_attention (dq, dk, dv)",
        whole_call_ms=whole_ms, whole_call_over_library=whole_ms / lib_ms)
    # the bound counts 3 (K7) and 4 (K8) products on the unmasked pairs
    for name, site, ins, outs, products, ms_k, extra in (
            ("flash_attention_bwd_dq", 311, nbytes(q, k, v, o, do, pos, pos, valid_u8, lse),
             nbytes(dq, delta), 3, ms_dq, {"delta_rel_err": delta_err, "ragged": ragged}),
            ("flash_attention_bwd_dkv", 342, nbytes(q, k, v, do, pos, pos, valid_u8, lse, delta),
             nbytes(dk, dv), 4, ms_dkv, {})):
        b_ms, b_by = bound(ins + outs, 2.0 * products * Hd * H * pairs, peaks)
        results.append(dict(name=name, route="cuda",
                            replaces=f"rlinf_tpu/ops/pallas/flash_attention.py:{site}",
                            ms=ms_k, bound_ms=b_ms, bound_by=b_by, **common_fields, **extra))
    if not (max(errs.values()) < 2e-2 and delta_err < 1e-4):
        raise AssertionError(f"K7/K8 disagree with their plain version: {errs}, delta {delta_err}")
    return results, k1_train


def flash_bwd_inputs(randn, pos, valid, H, Kv, Hd):
    """(q, k, v, pos, pos, valid, o, lse, do, scale) of one flash-attention
    backward: random bf16 inputs, o and lse from K1."""
    from rlinf_tpu_torch.ops.cuda import flash_attention as FA

    B, T = valid.shape
    q, k, v, do = randn(B, T, H, Hd), randn(B, T, Kv, Hd), randn(B, T, Kv, Hd), randn(B, T, H, Hd)
    valid_u8 = valid.to(torch.uint8)
    scale = Hd**-0.5
    o, lse = FA.flash_attention_fwd(q, k, v, pos, pos, valid_u8, scale)
    return q, k, v, pos, pos, valid_u8, o, lse, do, scale


def flash_bwd_errors(args):
    """K7 + K8 against their plain version on the same inputs -> (their
    (dq, dk, dv), relative errors, absolute errors)."""
    from rlinf_tpu_torch.ops.cuda import flash_attention as FA

    got = FA.flash_attention_bwd(*args)
    want = FA.flash_attention_bwd_plain(*args)
    torch.cuda.synchronize()
    names = ("dq", "dk", "dv")
    return (got, {nm: rel_err(a, b) for nm, a, b in zip(names, got, want)},
            {nm: (a.float() - b.float()).abs().max().item() for nm, a, b in zip(names, got, want)})


# (B, T, H, Kv, Hd, left-padded) where the attention tiles leave ragged
# edges: T=700 left-padded at Hd=64 with Qwen2-0.5B's heads, and Sq=Sk=100
# right-padded at Hd=128; row 1 of each has no valid key.
RAGGED_ATTENTION = ((4, 700, 14, 2, 64, True), (3, 100, 12, 2, 128, False))


def ragged_rows(B, T, left):
    """(valid [B, T] bool, positions [B, T] int32) of one ragged case."""
    lens = torch.linspace(T // 3, T, B, device="cuda").round().long().flip(0)
    ar = torch.arange(T, device="cuda")[None]
    valid = ar >= (T - lens)[:, None] if left else ar < lens[:, None]
    pos = (valid.to(torch.int32).cumsum(-1) - 1).clamp_min(0).to(torch.int32)
    valid[1] = False
    return valid, pos


def flash_fwd_ragged(randn) -> dict:
    """K1 against its plain version at RAGGED_ATTENTION, at the main
    check's bar (o and lse max-abs error < 2e-2); the row with no valid key
    must give exactly 0."""
    from rlinf_tpu_torch.ops.cuda import flash_attention as FA

    out = {}
    for B, T, H, Kv, Hd, left in RAGGED_ATTENTION:
        valid, pos = ragged_rows(B, T, left)
        vu8 = valid.to(torch.uint8)
        q, k, v = randn(B, T, H, Hd), randn(B, T, Kv, Hd), randn(B, T, Kv, Hd)
        o, lse = FA.flash_attention_fwd(q, k, v, pos, pos, vu8, Hd**-0.5)
        o_r, lse_r = FA.flash_attention_fwd_plain(q, k, v, pos, pos, vu8, Hd**-0.5)
        torch.cuda.synchronize()
        key = f"{'left' if left else 'right'}-padded B={B} T={T} H={H} Kv={Kv} Hd={Hd}"
        out[key] = {"max_abs_err": (o.float() - o_r.float()).abs().max().item(),
                    "lse_max_abs_err": (lse - lse_r).abs().max().item(),
                    "masked_row_zero": bool((o[1] == 0).all().item())}
        r = out[key]
        if not (r["max_abs_err"] < 2e-2 and r["lse_max_abs_err"] < 2e-2 and r["masked_row_zero"]):
            raise AssertionError(f"K1 at {key}: {r}")
    return out


def flash_bwd_ragged(randn) -> dict:
    """K7 + K8 against their plain version at RAGGED_ATTENTION, at the main
    check's bar (relative error < 2e-2 on dq, dk, dv); the gradients of the
    row with no valid key must be exactly zero."""
    out = {}
    for B, T, H, Kv, Hd, left in RAGGED_ATTENTION:
        valid, pos = ragged_rows(B, T, left)
        args = flash_bwd_inputs(randn, pos, valid, H, Kv, Hd)
        got, errs, _ = flash_bwd_errors(args)
        key = f"{'left' if left else 'right'}-padded B={B} T={T} H={H} Kv={Kv} Hd={Hd}"
        out[key] = {"rel_err": errs,
                    "masked_row_zero": all(bool((t[1] == 0).all().item()) for t in got)}
        if not (max(errs.values()) < 2e-2 and out[key]["masked_row_zero"]):
            raise AssertionError(f"K7/K8 at {key}: {out[key]}")
    return out


def attn_impl_crossover(cfg, seed) -> dict:
    """causal_attention forward + backward through the kernels
    (impl="pallas": K1, K7, K8) and through the plain path (impl="xla") on
    one Qwen2-1.5B layer's q, k, v at a fixed 12,288 tokens, for T = 128,
    256, 512, 768, 1024 and 2048 (B = 12,288 / T, no padding). Each time is
    the mean of 50 calls after 10 warm-up calls. It records the plain
    path's time over the kernels' at each T, the pairs of neighbouring T
    between which the faster path changes (none where one path wins
    throughout), and the least T from which the kernels win at every
    longer T: what resolve_attn_impl's threshold (config.py) is set from."""
    from rlinf_tpu_torch.config import ATTN_KERNELS_FROM_T
    from rlinf_tpu_torch.ops.attention import causal_attention

    g = torch.Generator(device="cuda").manual_seed(seed + 30)
    H, Kv, Hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    out = {}
    for T in (128, 256, 512, 768, 1024, 2048):
        B = 12288 // T
        q, k, v, do = (torch.randn(shape, generator=g, device="cuda").bfloat16()
                       for shape in ((B, T, H, Hd), (B, T, Kv, Hd), (B, T, Kv, Hd), (B, T, H, Hd)))
        row = {"batch": B}
        for impl in ("pallas", "xla"):
            def step():
                qq, kk, vv = (x.detach().requires_grad_(True) for x in (q, k, v))
                torch.autograd.backward(causal_attention(qq, kk, vv, impl=impl), do)
            row[f"{impl}_ms"] = cuda_ms(step, 50, warmup=10)
        row["xla_over_pallas"] = row["xla_ms"] / row["pallas_ms"]
        out[f"T={T}"] = row
        del q, k, v, do
        torch.cuda.empty_cache()
    wins = [(int(key[2:]), r["xla_over_pallas"] > 1) for key, r in out.items()]
    out["kernels_win_at_T"] = [T for T, won in wins if won]
    out["crossover_between_T"] = [[t0, t1] for (t0, w0), (t1, w1) in zip(wins, wins[1:])
                                  if w0 != w1]
    losing = [T for T, won in wins if not won]
    later = [T for T, _ in wins if not losing or T > max(losing)]
    out["kernels_win_from_T"] = later[0] if later else None
    out["resolve_attn_impl_threshold"] = ATTN_KERNELS_FROM_T
    return out


def ragged_shapes(seed) -> dict:
    """K4 and K6 against their plain versions where the shapes leave ragged
    edges: K4 at B = 100 (a full and a partial row block) and at D = 200,
    V = 1000 (the packed head padded in depth and vocabulary); K6 at 320
    rows (two and a half 128-row tiles), D = 200, V = 1000, and at D = 100,
    V = 1001 (depth zero-padded to 104, the untied weight's rows to 1008),
    both layouts. Bars as at the main shapes: K4 greedy tokens equal and
    logprob error < 5e-3, K6 relative error < 1e-2 and the pad columns of
    dz zero."""
    from rlinf_tpu_torch.models.llm.quant import quantize_tensor
    from rlinf_tpu_torch.ops.cuda import sampler_kernel as SK

    g = torch.Generator(device="cuda").manual_seed(seed + 42)
    out = {}
    for B, D, V in ((100, 1536, 151936), (8, 200, 1000), (100, 200, 1000)):
        lm = quantize_tensor(torch.randn((D, V), generator=g, device="cuda") * 0.05)
        head = SK.pack_lm_head(lm.q, lm.scale)
        hidden = torch.randn((B, D), generator=g, device="cuda").bfloat16()
        tok, lp = SK.fused_lmhead_sample_packed(hidden, head, 3, greedy=True)
        ref_tok, ref_lp = SK.fused_lmhead_sample_plain(hidden, lm.q, lm.scale, 3, greedy=True)
        tok_s, _ = SK.fused_lmhead_sample_packed(hidden, head, 9, temperature=0.7)
        ref_s, _ = SK.fused_lmhead_sample_plain(hidden, lm.q, lm.scale, 9, temperature=0.7)
        r = {"greedy_agree": (tok == ref_tok).float().mean().item(),
             "lp_err": (lp - ref_lp).abs().max().item(),
             "sampled_agree": (tok_s == ref_s).float().mean().item()}
        out[f"K4 B={B} D={D} V={V}"] = r
        if r["greedy_agree"] != 1.0 or not r["lp_err"] < 5e-3:
            raise AssertionError(f"K4 at B={B}, D={D}, V={V}: {r}")
    for n, D, V in ((320, 200, 1000), (100, 100, 1001)):
        out.update(k6_ragged(g, n, D, V))
    return out


def k5_ragged(g, n=100, D=100, V=1001, T=1.3) -> dict:
    """K5 against its plain version where every tile is ragged: n rows (a
    partial 128-row tile, as fused_linear_ce passes them), depth D
    (zero-padded to a multiple of 8 by the wrapper), V columns (a partial
    last tile, where the last row's target lies), at temperature T, both
    layouts; max-abs error < 2e-3 on lp, ent and lse."""
    from rlinf_tpu_torch.ops.cuda import linear_ce as LCE

    h = torch.randn((n, D), generator=g, device="cuda").bfloat16()
    tgt = torch.randint(0, V, (n,), generator=g, device="cuda", dtype=torch.int32)
    tgt[n - 1] = V - 1
    w_vd = (torch.randn((V, D), generator=g, device="cuda") * 0.1).bfloat16()
    out = {}
    for layout in ("vd", "dv"):
        w = w_vd if layout == "vd" else w_vd.t().contiguous()
        got = LCE.ce_forward(h, w, tgt, 1.0 / T, layout)
        ref = LCE.ce_forward_plain(h, w, tgt, 1.0 / T, layout)
        torch.cuda.synchronize()
        errs = [(a - b).abs().max().item() for a, b in zip(got, ref)]
        key = f"K5 {layout} n={n} D={D} V={V} T={T}"
        out[key] = {"lp_ent_lse_err": errs}
        if not max(errs) < 2e-3:
            raise AssertionError(f"K5 at {key}: {errs}")
    return out


def k6_ragged(g, n, D, V) -> dict:
    """K6 against its plain version at n rows, depth D and vocabulary V, in
    both layouts: relative error < 1e-2 on dz and dh, pad columns of dz 0."""
    from rlinf_tpu_torch.ops.cuda import linear_ce as LCE

    out = {}
    h = torch.randn((n, D), generator=g, device="cuda").bfloat16()
    tgt = torch.randint(0, V, (n,), generator=g, device="cuda", dtype=torch.int32)
    g_lp = torch.randn((n,), generator=g, device="cuda")
    g_ent = torch.randn((n,), generator=g, device="cuda")
    w_vd = (torch.randn((V, D), generator=g, device="cuda") * 0.1).bfloat16()
    for layout in ("vd", "dv"):
        w = w_vd if layout == "vd" else w_vd.t().contiguous()
        _, ent, lse = LCE.ce_forward_plain(h, w, tgt, 1.3, layout)
        args = (h, w, tgt, lse, lse - ent, g_lp, g_ent, 1.3, layout)
        dz, dh = LCE.ce_backward(*args)
        dz_r, dh_r = LCE.ce_backward_plain(*args)
        torch.cuda.synchronize()
        r = {"dz": rel_err(dz, dz_r), "dh": rel_err(dh, dh_r),
             "dz_pad_zero": bool((dz[:, V:] == 0).all().item())}
        out[f"K6 {layout} n={n} D={D} V={V}"] = r
        if not (r["dz"] < 1e-2 and r["dh"] < 1e-2 and r["dz_pad_zero"]):
            raise AssertionError(f"K6 ({layout}) at n={n}, D={D}, V={V}: {r}")
    return out


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
            (S, "fused_lmhead_sample_packed", "fused_lmhead_sample",
             SK.fused_lmhead_sample_packed_plain)]


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


def idle_between(fn, name: str) -> dict:
    """The device's busy time and idle share over the span of a
    torch.profiler trace of one call of ``fn`` from the start of the first
    kernel whose name holds ``name`` to the end of the last: the kernels of
    that span (one stream) summed, against the span's length. A record lost
    at the start of the session falls before the span."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [(e.time_range.start, e.time_range.end, name in e.name) for e in prof.events()
               if e.device_type == DeviceType.CUDA and e.name != "Command Buffer Full"]
    marks = [(t0, t1) for t0, t1, hit in kernels if hit]
    if not marks:
        return {"launches_traced": 0, "idle_share": "not measured: no launch of " + name}
    lo, hi = min(t0 for t0, _ in marks), max(t1 for _, t1 in marks)
    busy = sum(min(t1, hi) - max(t0, lo) for t0, t1, _ in kernels if t1 > lo and t0 < hi)
    return {"launches_traced": len(marks), "span_ms": (hi - lo) / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1 - busy / (hi - lo)}


def device_ms_by_kernel(fn, calls: int):
    """({kernel: mean device ms of one launch}, {kernel: launches recorded})
    of the GPU kernels that ``fn`` launches, from a torch.profiler trace of
    ``calls`` calls after one untraced call. Each mean is over the launches
    the trace recorded, not the calls made: in a process that has already
    run profiler sessions, a new session can lose the first device records
    it should hold (every record of a session of two K6 calls), so the
    window holds several calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_time_total > 0 and e.key != "Command Buffer Full"]
    return ({e.key: e.device_time_total / 1e3 / e.count for e in events},
            {e.key: e.count for e in events})


# K7's and K8's kernels by the names the trace gives them
# (csrc/flash_attention_bwd.cu)
FLASH_BWD_KERNELS = (("dq", "flash_bwd_dq_kernel"), ("dkv", "flash_bwd_dkv_kernel"))


def flash_bwd_step(events) -> dict:
    """K7's and K8's device ms and launches in a trace's events (the
    profiler's key_averages), summed over the whole trace. Raises where the
    trace holds no time for one of them."""
    out = {}
    for p, name in FLASH_BWD_KERNELS:
        mine = [e for e in events if name in e.key]
        out[f"{p}_ms"] = sum(e.device_time_total for e in mine) / 1e3
        out[f"{p}_launches_traced"] = sum(e.count for e in mine)
        if not out[f"{p}_ms"] > 0:
            raise AssertionError(f"the trace holds no time for {name}: {[e.key for e in events]}")
    return out


# K6 calls in the trace that reads its passes apart (launches_traced tells
# how many of each pass's K6_TRACED_CALLS launches the trace kept)
K6_TRACED_CALLS = 8
# K6's kernels by the names the trace gives them (csrc/linear_ce.cu; K5 is
# the same template's PASS 2)
K6_PASSES = (("pass_a", "ce_gemm_kernel<0"), ("pass_b", "ce_gemm_kernel<1"),
             ("merge", "dh_merge_kernel"))
# K5's kernels by the names the trace gives them
K5_KERNELS = ("ce_gemm_kernel<2", "ce_fwd_combine_kernel")


def k6_passes(by_kernel: dict, flop: float = 0.0) -> dict:
    """K6's pass A (dz), pass B (dh partials) and slice merge from a trace's
    time by kernel, and where ``flop`` is given the TFLOP/s of a pass that
    does that many operations. Raises where the trace holds no time for a
    pass."""
    out = {f"{p}_ms": sum(ms for key, ms in by_kernel.items() if name in key)
           for p, name in K6_PASSES}
    if not (out["pass_a_ms"] > 0 and out["pass_b_ms"] > 0):
        raise AssertionError(f"the trace holds no time for K6's passes: {sorted(by_kernel)}")
    if flop:
        for p in ("pass_a", "pass_b"):
            out[f"{p}_tflops"] = flop / out[f"{p}_ms"] / 1e9
    return out


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
    from rlinf_tpu_torch.data.io_struct import RolloutRequest
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
    # the device's idle share while it decodes: the first 64 requests with
    # budgets of 33 tokens (the prefill's and two rounds of 16 steps), traced
    short = RolloutRequest(prompt_ids=request.prompt_ids[:64], max_new_tokens=[33] * 64)
    out["paged"]["decode_trace"] = idle_between(
        lambda: eng.rollout(params, short, torch.Generator()), "paged_split_kernel")
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


# the kernels the logprob recompute (a forward pass) launches
RECOMPUTE_KERNELS = ("flash_attention_fwd", "linear_ce_fwd")
TRAIN_KERNELS = ("flash_attention_fwd", "linear_ce_fwd", "linear_ce_bwd",
                 "flash_attention_bwd_dq", "flash_attention_bwd_dkv")


def reward_rule(response_ids, response_mask):
    """The rule rewards of this smoke run: 1.0 where more than half of a
    response's tokens have an even id, else 0.0 (the math verifier and the
    tokenizer come with the runner)."""
    even = ((response_ids % 2 == 0) & response_mask).sum(-1)
    return (even * 2 > response_mask.sum(-1)).astype(np.float32)


TRAIN_STEPS = 4


class StepWatch:
    """What the host did in one train step besides dispatch: the caching
    allocator's device allocations and retries, and the garbage collector's
    pauses."""

    def __init__(self):
        self.gc_s, self._t = 0.0, None
        gc.callbacks.append(self._on_gc)

    def _on_gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.gc_s += time.perf_counter() - self._t
            self._t = None

    def step(self, fn):
        """Run ``fn`` to completion -> (its result, the step's record)."""
        before = torch.cuda.memory_stats()
        self.gc_s = 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        after = torch.cuda.memory_stats()
        return out, {"seconds": secs, "gc_pause_s": self.gc_s, **{
            k: after.get(k, 0) - before.get(k, 0)
            for k in ("num_device_alloc", "num_device_free", "num_alloc_retries")}}

    def close(self):
        gc.callbacks.remove(self._on_gc)


def training_path(cfg, params, rollout, kerns, gpu, seed):
    """GRPO on the serving phase's rollout: rule rewards, GRPO advantages
    over 8 groups of 8, build_train_batch, the logprob recompute, then
    TRAIN_STEPS train steps (remat, attn_impl="pallas", 4 microbatches,
    adamw with master weights, entropy bonus 1e-3) through the public entry
    points. The steps after the first give the step time: their median."""
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
    times, metrics, steps = {}, [], []
    watch_host = StepWatch()

    def run():
        t0 = time.perf_counter()
        lp, _ = logprob_fn(params, batch.to_dict())
        torch.cuda.synchronize()
        times["recompute_s"] = time.perf_counter() - t0
        times["recompute_launches"] = {name: kern.launches for name, kern in kerns.items()}
        lp = lp.cpu().numpy()
        times["recompute_vs_rollout_lp"] = {
            "max_abs": float(np.abs(lp - batch.old_logprobs)[batch.loss_mask].max()),
            "mean_abs": float(np.abs(lp - batch.old_logprobs)[batch.loss_mask].mean())}
        batch.old_logprobs = np.where(batch.loss_mask, lp, 0.0).astype(np.float32)
        state = TrainState(0, params, tx.init(params))
        for i in range(1, TRAIN_STEPS + 1):
            (state, m), rec = watch_host.step(lambda: step_fn(state, batch.to_dict()))
            steps.append(rec)
            metrics.append({k: float(v) for k, v in m.items()})
            if i == 1:
                times["moved_after_step1"] = {
                    k: bool((w != (params["embed"][:64] if k == "embed" else
                                   params["blocks"][k][0].flatten()[:4096])).any())
                    for k, w in watch.items()}
        return state

    state, secs, counts = run_counted(kerns, run)
    watch_host.close()
    later = sorted(r["seconds"] for r in steps[1:])
    step_s = later[len(later) // 2]
    out = {"phase": "training", "gpu": gpu, "model": "qwen2_1_5b", "layers": cfg.num_layers,
           "batch": B, "seq_len": T, "train_tokens": tokens, "num_microbatches": 4,
           "rewards_mean": float(rewards.mean()), "seconds": secs, **times,
           "steps": steps, "step_s_median": step_s, "step_s_min": later[0],
           "train_tokens_per_s": tokens / step_s,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2**30,
           "metrics": metrics, "launches": counts}
    emit(out)
    recompute = times["recompute_launches"]
    missing = [k for k in TRAIN_KERNELS if not counts[k] - recompute[k]]
    missing += [f"recompute: {k}" for k in RECOMPUTE_KERNELS if not recompute[k]]
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
    """Device time by kernel over one more train step under torch.profiler:
    the ``top`` kernels, every kernel of the port, K6's passes (the mean of
    one launch, and the launches the trace holds) and K7's and K8's time a
    step and launches, all read from the whole trace."""
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
    port = [e for e in events if "(anonymous namespace)::" in e.key]
    k6 = k6_passes({e.key: e.device_time_total / 1e3 / e.count for e in events})
    k6["launches_traced"] = {p: sum(e.count for e in events if name in e.key)
                             for p, name in K6_PASSES}
    k5 = [e for e in events if any(name in e.key for name in K5_KERNELS)]
    k5_step = {"ms": sum(e.device_time_total for e in k5) / 1e3,
               "launches_traced": {e.key[:60]: e.count for e in k5}}
    return {"phase": "train_profile", "wall_ms_under_profiler": wall_ms, "device_busy_ms": busy,
            "by_kernel_ms": {e.key[:60]: e.device_time_total / 1e3 for e in events[:top]},
            "by_kernel_calls": {e.key[:60]: e.count for e in events[:top]},
            "port_kernels_ms": {e.key[:60]: e.device_time_total / 1e3 for e in port},
            "port_kernels_calls": {e.key[:60]: e.count for e in port},
            "k5_step": k5_step, "k6_step_ms": k6, "k7_k8_step": flash_bwd_step(events)}


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


def mega_generate_qwen2_7b(seed) -> dict:
    """A 16-token greedy ``generate(kv_quant="int8", mega=)`` at Qwen2-7B's
    widths, 4 of its 28 layers (random weights from the seed), 16 prompts of
    32-128 tokens, with every K9 call shadowed by its plain version on the
    same inputs (relative error < 5e-2, phase 10's bar): K9 once a step."""
    import dataclasses

    from rlinf_tpu_torch.models.llm import model as M
    from rlinf_tpu_torch.models.llm.config import LLMConfig
    from rlinf_tpu_torch.models.llm.quant import quantize_params
    from rlinf_tpu_torch.models.llm.sampler import SamplingParams, generate
    from rlinf_tpu_torch.ops.cuda import decode_megakernel as MK

    cfg = dataclasses.replace(LLMConfig.qwen2_7b(), num_layers=4)
    params = M.init_params(cfg, seed + 9, device="cuda")
    qparams = quantize_params(params)
    mega = MK.pack_decode_weights(qparams, cfg, chunk_width=cfg.hidden_size)
    B, P, N = 16, 128, 16
    r = np.random.default_rng(seed + 9)
    plen = r.integers(32, P + 1, B)
    mask = np.arange(P)[None, :] >= (P - plen)[:, None]
    ids = np.where(mask, r.integers(0, cfg.vocab_size, (B, P)), 0)
    sp = SamplingParams(max_new_tokens=N, greedy=True, eos_token_id=-1)
    stats = {}
    t0 = time.perf_counter()
    with kernels_replaced(shadowed(stats), _engine_sites()):
        out = generate(params, cfg, torch.Generator(), ids, mask, sp, attn_impl="pallas",
                       decode_params=qparams, kv_quant="int8", mega=mega, device="cuda")
    secs = time.perf_counter() - t0
    check_output(out.response_ids.cpu(), out.response_logprobs.cpu(), out.response_mask.cpu(),
                 B, N, cfg.vocab_size)
    k9 = stats.get("decode_megakernel", {})
    if not (k9.get("calls") == N - 1 and k9["max_rel_err"] < 5e-2):
        raise AssertionError(f"K9 shadow check at Qwen2-7B's widths failed: {stats}")
    return {"model": "qwen2_7b widths, 4 layers", "batch": B, "new_tokens": N,
            "seconds_shadowed": secs, "shadow": stats}


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
    from rlinf_tpu_torch.models.llm.sampler import (
        SamplingParams, generate, with_packed_lm_head,
    )
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
    reports = kernel_reports()
    emit({"phase": "kernel_reports", **reports})
    check_reports(reports)

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

    # 9. generate(mega=): phase 3's prompts, the whole decode step in one launch,
    # on decode weights whose lm head is packed once (as the engines make them)
    with torch.inference_mode():
        mqparams = with_packed_lm_head(qparams)

        def mega_generate(sampling, seed=args.seed + 1):
            return generate(params, cfg, torch.Generator().manual_seed(seed), ids, mask, sampling,
                            attn_impl="pallas", decode_params=mqparams, kv_quant="int8",
                            mega=mega, device="cuda")
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
    del qparams, mqparams, mega
    torch.cuda.empty_cache()

    # 10b. generate(mega=) at Qwen2-7B's widths, every K9 call shadowed
    with torch.inference_mode():
        emit({"phase": "engine_shadow_qwen2_7b", **mega_generate_qwen2_7b(args.seed)})
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
    train_results, k1_train = check_training_kernels(cfg, train_mask, peaks, args.seed)
    results[0]["train_microbatch"] = k1_train
    results += train_results
    emit({"phase": "training_kernels", "gpu": gpu, "k1_train_microbatch": k1_train,
          "results": train_results})
    torch.cuda.empty_cache()

    # 5b. K4 and K6 against their plain versions at ragged shapes
    with torch.inference_mode():
        emit({"phase": "ragged_shapes", **ragged_shapes(args.seed)})
    torch.cuda.empty_cache()

    # 5c. where the kernels overtake the plain attention path
    emit({"phase": "attn_impl_threshold", "gpu": gpu, **attn_impl_crossover(cfg, args.seed)})
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
