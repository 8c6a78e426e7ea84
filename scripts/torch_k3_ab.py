#!/usr/bin/env python3
"""K3 (int8-cache decode attention) of ``rlinf_tpu_torch`` against an
earlier version of it, in one process on one GPU: the host cost of one
call, and the two serving paths that launch K3.

    python3 scripts/torch_k3_ab.py --old DIR [--seed 0] [--rounds 1]

DIR holds the earlier ``decode_attention.cu`` with the headers it
includes; its C entry ``decode_attention_q8`` takes (device, q, k_cache,
v_cache, k_scale, v_scale, starts, lengths, out, B, H, Kv, S, Hd, scale,
stream), as the one-CTA-per-(row, kv head) K3 did. It is compiled with the
port's nvcc flags into ``build/k3_ab/`` and bound with ctypes, and a copy
of that version's wrapper calls it. Every measurement runs in turns old,
new, new, old (``--rounds`` times), each phase printing one JSON line:

1. dispatch: CUDA events around 2000 eager calls made one after another
   (the host's dispatch included) and a CUDA-graph replay (device time
   alone), at B=1, S=16, where the device's part is a few microseconds,
   and at the decode shape B=64, S=768 (Qwen2-1.5B's heads). At B=1 also
   the host clock's time a call of the wrapper's parts: its argument
   checks, the allocation of its buffers, and the C entry alone (the
   launches) on arguments made beforehand.
2. generate: ``generate(kv_quant="int8")`` on ``chip_smoke.py``'s main
   path (Qwen2-1.5B at full width and depth, random weights from --seed,
   64 prompts of 128-512 tokens, 256 new tokens), with K3 swapped at its
   call site: generated tokens per second on the host clock.
3. continuous: the continuous-batching engine with int8 weights and KV on
   ``chip_smoke.py``'s long-tail mix (128 requests, 18,317 tokens).

Each engine runs once with the new K3 before its turns, as a warm-up. The
launches of both versions are counted in every turn: a turn that launched
the other version's kernel, or none, fails the run.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def build_old(src_dir: Path) -> subprocess.Popen:
    out = ROOT / "build" / "k3_ab"
    out.mkdir(parents=True, exist_ok=True)
    from rlinf_tpu_torch.ops.cuda import _build
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / "decode_attention_old.so"),
         str(src_dir / "decode_attention.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def old_wrapper(lib_path: Path):
    """The earlier version's wrapper of K3: its checks, one output, one call."""
    from rlinf_tpu_torch.ops.cuda import decode_attention as DA
    from rlinf_tpu_torch.ops.cuda._build import check_cuda_tensor, stream_handle

    I, P, F = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
    fn = ctypes.CDLL(str(lib_path)).decode_attention_q8
    fn.argtypes = [I, P, P, P, P, P, P, P, P, I, I, I, I, I, F, P]
    fn.restype = ctypes.c_int

    def call(q, k_cache, v_cache, k_scale, v_scale, starts, lengths, *, num_kv, scale=None):
        B, H, Hd, S = DA._check_common(q, k_cache, v_cache, starts, lengths, num_kv, torch.int8)
        check_cuda_tensor("k_scale", k_scale, torch.float32, (B, S))
        check_cuda_tensor("v_scale", v_scale, torch.float32, (B, S))
        out = torch.empty_like(q)
        err = fn(q.device.index, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 k_scale.data_ptr(), v_scale.data_ptr(), starts.data_ptr(), lengths.data_ptr(),
                 out.data_ptr(), B, H, num_kv, S, Hd,
                 float(Hd**-0.5 if scale is None else scale), stream_handle())
        if err != 0:
            raise RuntimeError(f"earlier decode_attention_q8 failed: CUDA error {err}")
        call.launches += 1
        return out

    call.launches = 0
    call.fn = fn
    return call


def turns(rounds: int):
    return ["old", "new", "new", "old"] * rounds


def dispatch(old, rounds: int) -> dict:
    from rlinf_tpu_torch.ops.cuda import decode_attention as DA

    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"phase": "dispatch"}
    for B, S in ((1, 16), (64, 768)):
        q = torch.randn((B, 12, 128), generator=g, device="cuda").bfloat16()
        kq, ks = DA.quantize_kv_token(torch.randn((B, S, 256), generator=g, device="cuda"))
        vq, vs = DA.quantize_kv_token(torch.randn((B, S, 256), generator=g, device="cuda"))
        st = torch.zeros((B,), dtype=torch.int32, device="cuda")
        ln = torch.full((B,), S, dtype=torch.int32, device="cuda")
        args = (q, kq, vq, ks, vs, st, ln)
        fns = {"new": lambda: DA.decode_attention_packed_q8(*args, num_kv=2),
               "old": lambda: old(*args, num_kv=2)}
        ref = DA.decode_attention_packed_q8_xla(*args, num_kv=2)
        errs = {k: (f().float() - ref.float()).abs().max().item() for k, f in fns.items()}
        r = {"max_abs_err": errs, "eager_us": {"old": [], "new": []},
             "graph_us": {"old": [], "new": []}}
        for who in turns(rounds):
            r["eager_us"][who].append(cs.cuda_ms(fns[who], 2000, warmup=50) * 1e3)
            r["graph_us"][who].append(cs.graph_ms(fns[who]) * 1e3)
        if B == 1:
            r["host_us_per_call"] = host_parts(old, args)
        if not max(errs.values()) < 2e-2:
            raise AssertionError(f"K3 at B={B}, S={S} disagrees with its plain version: {errs}")
        out[f"B={B} S={S}"] = r
    return out


def host_us(fn, iters: int = 2000) -> float:
    """Host clock's microseconds a call over ``iters`` calls made one after
    another (the device's work, if any, waited for at the end)."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e6


def host_parts(old, args) -> dict:
    """The new wrapper's parts, and the old one's entry, at one input."""
    from rlinf_tpu_torch.ops.cuda import decode_attention as DA
    from rlinf_tpu_torch.ops.cuda._build import check_cuda_tensor, sm_count, stream_handle

    q, kq, vq, ks, vs, st, ln = args
    B, H, Hd = q.shape
    S, Kv = kq.shape[1], 2
    dev = q.device.index
    bps, splits = DA.split_plan(B * Kv, -(-S // DA.KEY_BLOCK), sm_count(dev))
    part = torch.empty((B * H * splits * (Hd + 2),), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    ptrs = [t.data_ptr() for t in (q, kq, vq, ks, vs, st, ln)]
    scale = float(Hd**-0.5)

    def checks():
        DA._check_common(q, kq, vq, st, ln, Kv, torch.int8)
        check_cuda_tensor("k_scale", ks, torch.float32, (B, S))
        check_cuda_tensor("v_scale", vs, torch.float32, (B, S))

    def alloc():
        DA.split_plan(B * Kv, -(-S // DA.KEY_BLOCK), sm_count(dev))
        torch.empty((B * H * splits * (Hd + 2),), dtype=torch.float32, device=q.device)
        torch.empty_like(q)

    def entry_new():
        DA.KERNEL_Q8(dev, *ptrs, part.data_ptr(), out.data_ptr(), B, H, Kv, S, Hd, bps, splits,
                     scale, stream_handle())

    def entry_old():
        old.fn(dev, *ptrs, out.data_ptr(), B, H, Kv, S, Hd, scale, stream_handle())

    parts = {"wrapper_old": lambda: old(*args, num_kv=Kv),
             "wrapper_new": lambda: DA.decode_attention_packed_q8(*args, num_kv=Kv),
             "checks": checks, "alloc_new": alloc, "entry_old": entry_old,
             "entry_new": entry_new, "stream_handle": stream_handle}
    return {name: host_us(fn) for name, fn in parts.items()}


def swapped(old, who: str):
    """Both call sites of K3 (the serving path's) on the version ``who``."""
    return cs.kernels_replaced(
        lambda name, kernel, plain: old if (who == "old" and name == "decode_attention_q8")
        else kernel)


def timed_turns(old, rounds: int, run) -> dict:
    from rlinf_tpu_torch.ops.cuda import decode_attention as DA

    run()  # warm-up with the new K3
    res = {"old": [], "new": []}
    for who in turns(rounds):
        old.launches = DA.KERNEL_Q8.launches = 0
        with swapped(old, who):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tokens = run()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        mine, other = ((old.launches, DA.KERNEL_Q8.launches) if who == "old"
                       else (DA.KERNEL_Q8.launches, old.launches))
        if not mine or other:
            raise AssertionError(f"turn {who}: K3 launches {mine}, the other version's {other}")
        res[who].append(tokens / secs)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k3_ab: no CUDA device", file=sys.stderr)
        return 1

    from rlinf_tpu_torch.config import RolloutConfig
    from rlinf_tpu_torch.data.io_struct import RolloutRequest
    from rlinf_tpu_torch.models.llm import model as M
    from rlinf_tpu_torch.models.llm.config import LLMConfig
    from rlinf_tpu_torch.models.llm.quant import quantize_params
    from rlinf_tpu_torch.models.llm.sampler import SamplingParams, generate
    from rlinf_tpu_torch.ops.cuda import build
    from rlinf_tpu_torch.rollout import build_rollout_engine

    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = cs.gpu_line()
    t0 = time.perf_counter()
    proc = build_old(args.old)
    build()
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc of the earlier K3 failed:\n{log}")
    cs.emit({"phase": "build", "gpu": gpu, "seconds": time.perf_counter() - t0})
    old = old_wrapper(ROOT / "build" / "k3_ab" / "decode_attention_old.so")

    cs.emit({"gpu": gpu, **dispatch(old, args.rounds)})

    cfg = LLMConfig.qwen2_1_5b()
    B, N, bucket = 64, 256, 64
    rng = np.random.default_rng(args.seed)
    prompt_lens = rng.integers(128, 513, B)
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, n))) for n in prompt_lens]
    params = M.init_params(cfg, args.seed, device="cuda")
    sp = SamplingParams(max_new_tokens=N, temperature=1.0, eos_token_id=-1)
    ids, mask = RolloutRequest(prompt_ids=prompts).left_padded(sp.pad_token_id, bucket=bucket)
    with torch.inference_mode():
        qparams = quantize_params(params)

        def gen():
            out = generate(params, cfg, torch.Generator().manual_seed(args.seed + 1), ids, mask,
                           sp, attn_impl="pallas", decode_params=qparams,
                           decode_attn_impl="pallas", kv_quant="int8", device="cuda")
            cs.check_output(out.response_ids.cpu(), out.response_logprobs.cpu(),
                            out.response_mask.cpu(), B, N, cfg.vocab_size)
            return B * N

        cs.emit({"phase": "generate", "gpu": gpu, "what": "generate(kv_quant='int8'), "
                 f"{B} prompts x {N} new tokens", "tokens_per_s": timed_turns(old, args.rounds, gen)})
    del qparams

    request, budgets = cs.long_tail_mix(cfg, args.seed)
    trainer_cfg = types.SimpleNamespace(
        model=cfg, sampling=sp, attn_impl="pallas",
        rollout=RolloutConfig(num_slots=64, decode_chunk=16, prompt_bucket=64, engine="auto",
                              weight_quant="int8", kv_quant="int8"),
        data=types.SimpleNamespace(max_prompt_len=512),
        algorithm=types.SimpleNamespace(recompute_logprobs=None))
    eng = build_rollout_engine(trainer_cfg, device="cuda")

    def roll():
        res = eng.rollout(params, request, torch.Generator().manual_seed(args.seed + 2))
        cs.check_answers(res, budgets, cfg.vocab_size)
        return int(sum(budgets))

    cs.emit({"phase": "continuous", "gpu": gpu, "what": f"{type(eng).__name__}, "
             f"{len(budgets)} requests, {int(sum(budgets))} tokens",
             "tokens_per_s": timed_turns(old, args.rounds, roll)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
