#!/usr/bin/env python3
"""The bf16 kernels that share code with this tree's new head dims and
dtypes, against an earlier version of their sources, in one process on one
GPU: K1 at the prefill shape, K7 and K8 at B=16, T=768 (ragged rows), K4
at B=64, K5 and K6 at a 4096-row chunk of the tied head and K9 at B=64,
S=768 (Qwen2-1.5B's widths), each timed in turns old, new, new, old.

    python3 scripts/torch_parent_ab.py --old DIR [--seed 0] [--rounds 2]

DIR holds the earlier ``flash_attention_fwd.cu``, ``flash_attention_bwd.cu``,
``sampler.cu``, ``linear_ce.cu`` and ``decode_megakernel.cu`` with the
headers they include (e.g. ``rlinf_tpu_torch/csrc`` of ``git archive`` of an
earlier commit). Their C entries take this tree's arguments less the
element-type code (K1, K4, K7, K8) and K5/K6's split scratch, or the same
(K9). They are compiled with the port's nvcc flags into
``build/parent_ab/``, and each turn swaps the wrappers' bound entries
(``CudaKernel._fn``), so both versions run behind the same wrapper. One
JSON line: the card, and for each kernel its turns: the version, the time
(ms, CUDA events over 20 calls after warm-up) and the output's largest
difference from a call of this tree's version made before the turns (K4's
sampled logprobs).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

# source, index of the dtype code in the new entry's arguments (None: the
# entry did not change), indices of the other new arguments (K5/K6's split
# scratch, unused at bf16)
ENTRIES = {
    "flash_attention_fwd": ("flash_attention_fwd.cu", 15, ()),
    "flash_attention_bwd_dq": ("flash_attention_bwd.cu", 18, ()),
    "flash_attention_bwd_dkv": ("flash_attention_bwd.cu", 18, ()),
    "fused_lmhead_sample": ("sampler.cu", 18, ()),
    "linear_ce_fwd": ("linear_ce.cu", 15, (8, 9)),
    "linear_ce_bwd": ("linear_ce.cu", 19, (11, 12)),
    "decode_megakernel": ("decode_megakernel.cu", None, ()),
}


def build_old(src: Path, out: Path) -> dict:
    from rlinf_tpu_torch.ops.cuda import _build

    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in sorted({src for src, _, _ in ENTRIES.values()}):
        lib = out / name.replace(".cu", "_old.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src / name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def old_entries(libs) -> dict:
    """kernel name -> a callable with the new entry's arguments that calls
    the old entry (the dtype code dropped, after checking it is bf16's)."""
    from rlinf_tpu_torch.ops.cuda import kernels

    out = {}
    for name, kern in kernels().items():
        if name not in ENTRIES:
            continue
        src, at, extra = ENTRIES[name]
        fn = getattr(libs[src], kern.symbol)
        drop = set(extra) | ({at} if at is not None else set())
        fn.argtypes = [t for i, t in enumerate(kern.argtypes) if i not in drop]
        fn.restype = ctypes.c_int

        def call(*args, fn=fn, at=at, drop=drop):
            if at is not None and args[at] != 0:
                raise ValueError("the earlier entries take bf16 only")
            return fn(*(x for i, x in enumerate(args) if i not in drop))

        out[name] = call
    return out


def cases(seed: int) -> dict:
    """kernel name -> (a call through the port's wrapper, its output)."""
    from rlinf_tpu_torch.models.llm import model as M
    from rlinf_tpu_torch.models.llm.config import LLMConfig
    from rlinf_tpu_torch.models.llm.quant import quantize_params
    from rlinf_tpu_torch.ops.cuda import decode_megakernel as MK
    from rlinf_tpu_torch.ops.cuda import flash_attention as FA
    from rlinf_tpu_torch.ops.cuda import sampler_kernel as SK

    cfg = LLMConfig.qwen2_1_5b()
    H, Kv, Hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    g = torch.Generator(device="cuda").manual_seed(seed)
    randn = lambda *s: (torch.randn(s, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
    valid, pos = cs.ragged_rows(64, 512, left=True)
    vu8 = valid.to(torch.uint8)
    q, k, v = randn(64, 512, H, Hd), randn(64, 512, Kv, Hd), randn(64, 512, Kv, Hd)
    out = {"flash_attention_fwd": lambda: FA.flash_attention_fwd(q, k, v, pos, pos, vu8, Hd**-0.5)[0]}
    tv, tpos = cs.ragged_rows(16, 768, left=False)
    args = cs.flash_bwd_inputs(randn, tpos, tv, H, Kv, Hd)
    grads = tuple(torch.empty_like(t) for t in (args[0], args[1], args[2]))
    delta = torch.empty((16, H, 768), dtype=torch.float32, device="cuda")
    k7, k8 = cs.flash_bwd_launches(args, delta, grads)
    out["flash_attention_bwd_dq"] = lambda: (k7(), grads[0])[1]
    out["flash_attention_bwd_dkv"] = lambda: (k8(), grads[1])[1]
    from rlinf_tpu_torch.ops.cuda import linear_ce as LCE

    n, V, D = 4096, cfg.vocab_size, cfg.hidden_size
    h = randn(n, D)
    w = (torch.randn((V, D), generator=g, device="cuda") * D**-0.5).to(torch.bfloat16)
    tgt = torch.randint(0, V, (n,), generator=g, device="cuda", dtype=torch.int32)
    g_lp = torch.randn((n,), generator=g, device="cuda")
    g_ent = torch.randn((n,), generator=g, device="cuda") * 1e-3
    _, ent, lse = LCE.ce_forward(h, w, tgt, 1.0, "vd")
    out["linear_ce_fwd"] = lambda: LCE.ce_forward(h, w, tgt, 1.0, "vd")[2]
    out["linear_ce_bwd"] = lambda: LCE.ce_backward(h, w, tgt, lse, lse - ent, g_lp, g_ent, 1.0,
                                                   "vd")[1]
    params = M.init_params(cfg, seed, device="cuda")
    qparams = quantize_params(params)
    head = SK.pack_lm_head(qparams["lm_head"].q, qparams["lm_head"].scale)
    hid = randn(64, cfg.hidden_size)
    out["fused_lmhead_sample"] = lambda: SK.fused_lmhead_sample_packed(hid, head, 7)[1]
    plan, mw = MK.pack_decode_weights(qparams, cfg)
    wp = torch.randint(512, 767, (64,), generator=g, device="cuda", dtype=torch.int32)
    starts = torch.zeros((64,), dtype=torch.int32, device="cuda")
    _, cache, margs = cs.mega_case(MK, plan, mw, cfg, qparams, 64, 768, wp, wp.clone(), starts, g)
    out["decode_megakernel"] = lambda: MK.decode_step_mega(plan, mw, margs[0], *cache, *margs[1:])[0]
    del params
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, type=Path)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=2)
    a = ap.parse_args()
    from rlinf_tpu_torch.ops.cuda import build, kernels

    build()
    old = old_entries(build_old(a.old, ROOT / "build" / "parent_ab"))
    kerns = kernels()
    for kern in kerns.values():
        kern._bind()
    new = {name: kerns[name]._fn for name in ENTRIES}
    runs = cases(a.seed)
    result = {"gpu": cs.gpu_line(), "old": str(a.old), "turns": {}}
    with torch.inference_mode():
        ref = {name: fn().clone() for name, fn in runs.items()}
        for name, fn in runs.items():
            times = []
            for side in ("old", "new", "new", "old") * a.rounds:
                kerns[name]._fn = old[name] if side == "old" else new[name]
                got = fn()
                torch.cuda.synchronize()
                diff = (got.float() - ref[name].float()).abs().max().item()
                times.append((side, cs.cuda_ms(fn, 20, warmup=3), diff))
            kerns[name]._fn = new[name]
            result["turns"][name] = times
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
