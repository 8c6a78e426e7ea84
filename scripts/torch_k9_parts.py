#!/usr/bin/env python3
"""K9 (the whole-step decode megakernel) and K2 of ``rlinf_tpu_torch`` on
one GPU, quickly: the compiler's report, each against its plain version,
and K9's time by phase. A few minutes where ``chip_smoke.py`` takes five.

    python3 scripts/torch_k9_parts.py [--seed 0]

1. build: ``csrc/decode_attention.cu`` and ``csrc/decode_megakernel.cu``
   with the port's nvcc flags; ptxas's registers and spills of every
   function, and the SASS counts of HGMMA / wgmma waits / HMMA / MOVM.
2. K2 at ``chip_smoke.py``'s ragged cases and at B=64, S=768 (Qwen2-1.5B's
   heads), its device time by CUDA-graph replay.
3. K9 at a small geometry, then at 2-layer cuts of Qwen2-1.5B and of
   Qwen2-7B (random weights from --seed): B=64, S=768 with one write slot,
   with per-row slots, B=8 and B=96 (two row blocks), each against the plain version
   (``chip_smoke.mega_case``), and at B=64 its time (CUDA events) and its
   time by phase (the kernel's ``phase_clock``).

Each phase prints one JSON line. It fails if a kernel disagrees with its
plain version at ``chip_smoke.py``'s bars or spills.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from rlinf_tpu_torch.ops.cuda import _build  # noqa: E402

SOURCES = ("decode_attention.cu", "decode_megakernel.cu")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from rlinf_tpu_torch.models.llm import model as M
    from rlinf_tpu_torch.models.llm.config import LLMConfig
    from rlinf_tpu_torch.models.llm.quant import quantize_params
    from rlinf_tpu_torch.ops.cuda import decode_attention as DA
    from rlinf_tpu_torch.ops.cuda import decode_megakernel as MK

    print(cs.gpu_line(), flush=True)
    seconds = _build.build(list(SOURCES))
    report = {}
    for src in SOURCES:
        names = cs.REPORTED_KERNELS[src]
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        sass = subprocess.run([tool, "-sass", str(_build._library_path(src))],
                              capture_output=True, text=True, check=True).stdout
        report[src] = {"ptxas": cs.ptxas_report(_build.build_log(src), names),
                       "sass": cs.sass_counts(sass, names)}
    print(json.dumps({"phase": "build", "seconds": seconds, "reports": report}), flush=True)
    spills = [k for rep in report.values() for k, r in rep["ptxas"].items()
              if r.get("spill_stores") or r.get("spill_loads")]

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    B, S, H, Kv, Hd = 64, 768, 12, 2, 128
    starts = torch.randint(0, 384, (B,), generator=g, device=dev, dtype=torch.int32)
    lengths = torch.full((B,), 641, dtype=torch.int32, device=dev)
    q, k, v = randn(B, H, Hd), randn(B, S, Kv * Hd, scale=0.5), randn(B, S, Kv * Hd, scale=0.5)
    got = DA.decode_attention_packed(q, k, v, starts, lengths, num_kv=Kv)
    ref = DA.decode_attention_packed_xla(q, k, v, starts, lengths, num_kv=Kv)
    torch.cuda.synchronize()
    k2 = {"max_abs_err": (got.float() - ref.float()).abs().max().item(),
          "rel_err": cs.head_rel_err(got, ref),
          "ms": cs.graph_ms(lambda: DA.decode_attention_packed(q, k, v, starts, lengths, num_kv=Kv)),
          "ragged": cs.decode_ragged(randn, cs.RAGGED_BF16, q8=False)}
    print(json.dumps({"phase": "K2", **k2}), flush=True)

    small = LLMConfig(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
                      head_dim=64, intermediate_size=512, max_seq_len=256)
    sq = quantize_params(M.init_params(small, args.seed, device="cuda"))
    splan, smw = MK.pack_decode_weights(sq, small)
    wp = torch.randint(5, 127, (8,), generator=g, device=dev, dtype=torch.int32)
    cases = {"small": cs.mega_case(MK, splan, smw, small, sq, 8, 128, wp, wp,
                                   torch.zeros(8, dtype=torch.int32, device=dev), g)[0]}
    for name, base in (("qwen2_1_5b", LLMConfig.qwen2_1_5b()), ("qwen2_7b", LLMConfig.qwen2_7b())):
        cfg = dataclasses.replace(base, num_layers=2)
        qp = quantize_params(M.init_params(cfg, args.seed, device="cuda"))
        plan, mw = MK.pack_decode_weights(qp, cfg, chunk_width=max(2048, cfg.hidden_size))
        plens = torch.randint(128, 513, (B,), generator=g, device=dev, dtype=torch.int32)
        first = (512 - plens).to(torch.int32)
        cases[name], cache, cargs = cs.mega_case(MK, plan, mw, cfg, qp, B, S, 640,
                                                 (plens + 128).to(torch.int32), first, g)
        ms = cs.cuda_ms(lambda: MK.decode_step_mega(plan, mw, cargs[0], *cache, *cargs[1:]), 5)
        print(json.dumps({"phase": f"K9 {name}", "layers": plan.L, "ms": ms,
                          "schedule": MK.mega_schedule(plan, B, S, sms)._asdict(),
                          "phase_us": cs.mega_phase_us(MK, plan, mw, cache, cargs),
                          **cases[name]}), flush=True)
        del cache
        wps = torch.randint(8, S - 1, (B,), generator=g, device=dev, dtype=torch.int32)
        wps[0], wps[1] = 0, S - 1
        zeros = torch.zeros((B,), dtype=torch.int32, device=dev)
        cases[f"{name} ragged"] = cs.mega_case(MK, plan, mw, cfg, qp, B, S, wps, wps, zeros, g)[0]
        cases[f"{name} B=8"] = cs.mega_case(MK, plan, mw, cfg, qp, 8, S, wps[:8], wps[:8],
                                            zeros[:8], g)[0]
        w96 = torch.randint(8, S - 1, (96,), generator=g, device=dev, dtype=torch.int32)
        cases[f"{name} B=96"] = cs.mega_case(MK, plan, mw, cfg, qp, 96, S, w96, w96,
                                             torch.zeros(96, dtype=torch.int32, device=dev), g)[0]
        del qp, mw
    print(json.dumps({"phase": "K9 cases", **cases}), flush=True)
    bad = cs.mega_bad(cases)
    if not (k2["max_abs_err"] < 2e-2 and k2["rel_err"] < cs.K3_TOL_REL) or bad or spills:
        raise AssertionError(f"K2 {k2['max_abs_err']} {k2['rel_err']}; K9 {bad}; spills {spills}")
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
