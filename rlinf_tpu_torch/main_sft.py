"""Supervised fine-tuning entry point of the port.

The port's ``examples/sft/main_sft.py``: load the config, read a jsonl of
prompt/answer rows (``answer`` or ``response``), build ``SFTRunner``, run.
Positional overrides ``a.b=c`` follow ``--config``. ``--model-path`` names a
local Hugging Face checkpoint directory, whose config, tokenizer and weights
the port reads itself (``main_grpo.load_model``); without it the tokenizer
is the byte tokenizer and the weights are random from ``runner.seed``. The
run is on the card unless ``--device cpu`` is given.

Usage:
  python -m rlinf_tpu_torch.main_sft --config examples/reasoning/config/grpo_demo_tiny.yaml \\
      --data-path data.jsonl --device cpu runner.max_steps=2 runner.log_dir=/tmp/sft
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Supervised fine-tuning on the port")
    parser.add_argument("--config", required=True)
    parser.add_argument("--model-path", default=None,
                        help="local HF checkpoint dir (Qwen2/Qwen3/Llama family)")
    parser.add_argument("--data-path", required=True,
                        help="jsonl with prompt + answer/response fields")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the run (cuda, or cpu for the plain "
                             "versions of the kernels)")
    parser.add_argument("overrides", nargs="*", default=[])
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, float]]:
    """Run the config's steps; returns each step's metrics."""
    args = parse_args(argv)

    from rlinf_tpu_torch.config import load_config
    from rlinf_tpu_torch.data.datasets import PromptDataset
    from rlinf_tpu_torch.main_grpo import load_model
    from rlinf_tpu_torch.runners import SFTRunner

    cfg = load_config(args.config, args.overrides)
    cfg, tokenizer, init_override = load_model(cfg, args.model_path, args.device)
    dataset = PromptDataset.from_jsonl(args.data_path)
    runner = SFTRunner(cfg, tokenizer, dataset, init_params_override=init_override,
                       device=args.device)
    try:
        return runner.run()
    finally:
        runner.logger.close()


if __name__ == "__main__":
    main()
