"""Checkpoint converter CLI: Hugging Face checkpoints <-> the port's
checkpoint directories.

Port of ``rlinf_tpu/toolkits/ckpt_convert.py``. Two directions:

  import:  HF checkpoint dir (config.json + safetensors / pytorch_model.bin)
           -> a params-only checkpoint at --out (``global_step_0``), in the
           port's ``CheckpointManager`` layout (torch.save files, not orbax),
           which ``CheckpointManager.restore`` reads with a params template.
  export:  a params-only checkpoint dir -> ``model.safetensors`` (f32), as
           the JAX CLI writes it, consumable by transformers.

The files are read and written by ``models/llm/hf_files.py`` (no
transformers or safetensors package). Tensors are made on ``--device``.

Usage:
  python -m rlinf_tpu_torch.toolkits.ckpt_convert import --hf /path/Qwen2.5-0.5B \\
      --out ckpts/qwen [--device cpu]
  python -m rlinf_tpu_torch.toolkits.ckpt_convert export --ckpt ckpts/qwen \\
      --config config.yaml --out hf_out/ [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os


def do_import(args) -> int:
    from rlinf_tpu_torch.models.llm.hf_import import load_hf_pretrained
    from rlinf_tpu_torch.training.train_state import tree_leaves
    from rlinf_tpu_torch.utils.checkpoint import CheckpointManager

    cfg, params = load_hf_pretrained(args.hf, dtype=args.dtype, device=args.device)
    CheckpointManager(args.out).save(0, params, extra={
        "source": args.hf, "model_config": dataclasses.asdict(cfg)})
    n = sum(x.numel() for x in tree_leaves(params))
    print(json.dumps({"imported": args.hf, "out": args.out, "params": int(n)}))
    return 0


def do_export(args) -> int:
    from rlinf_tpu_torch.config import load_config
    from rlinf_tpu_torch.models.llm.hf_files import write_safetensors
    from rlinf_tpu_torch.models.llm.hf_import import params_to_hf_state_dict
    from rlinf_tpu_torch.models.llm.model import init_params
    from rlinf_tpu_torch.utils.checkpoint import CheckpointManager

    cfg = load_config(args.config)
    template = init_params(cfg.model, 0, device=args.device)
    mgr = CheckpointManager(args.ckpt)
    step = mgr.latest_step()
    if step is None:
        print(f"no checkpoint under {args.ckpt}")
        return 1
    try:
        params, _, _ = mgr.restore(template, step=step)
    except ValueError as e:
        raise SystemExit(
            "checkpoint is not a params-only checkpoint of this config (a full train "
            f"state is not supported by this CLI): {e}") from e
    sd = params_to_hf_state_dict(params, cfg.model)
    os.makedirs(args.out, exist_ok=True)
    write_safetensors(os.path.join(args.out, "model.safetensors"), sd, {"format": "pt"})
    print(json.dumps({"exported_step": step, "out": args.out, "tensors": len(sd)}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    im = sub.add_parser("import", help="HF dir -> params-only checkpoint")
    im.add_argument("--hf", required=True)
    im.add_argument("--out", required=True)
    im.add_argument("--dtype", default="bfloat16")
    im.add_argument("--device", default="cuda")
    ex = sub.add_parser("export", help="params-only checkpoint -> HF safetensors")
    ex.add_argument("--ckpt", required=True)
    ex.add_argument("--config", required=True)
    ex.add_argument("--out", required=True)
    ex.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return do_import(args) if args.cmd == "import" else do_export(args)


if __name__ == "__main__":
    raise SystemExit(main())
