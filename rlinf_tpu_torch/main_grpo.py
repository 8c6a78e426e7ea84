"""GRPO/PPO reasoning RL entry point of the port.

The port's ``examples/reasoning/main_grpo.py``: load the config, build the
runner, run. Positional overrides ``a.b=c`` follow ``--config``. Without
``--data-path`` the prompts are the JAX entry point's 512 synthetic
additions with verifiable answers; ``--data-path`` reads a jsonl of
prompt/answer rows. ``--model-path`` names a local Hugging Face checkpoint
directory: its weights (``models/llm/hf_import.py``) and tokenizer
(``HFTokenizer``) are read by the port itself, and its config replaces the
yaml's ``model`` section wholesale, as in the JAX entry point (the yaml's
``model.dtype`` is kept). Without it the tokenizer is the byte tokenizer and
the weights are random from ``runner.seed``. The run is on the card unless
``--device cpu`` is given.

Usage:
  python -m rlinf_tpu_torch.main_grpo --config examples/reasoning/config/grpo_demo_tiny.yaml --device cpu
  python -m rlinf_tpu_torch.main_grpo --config ... optimizer.lr=2e-6 runner.max_steps=200
  python -m rlinf_tpu_torch.main_grpo --config ... --model-path /path/Qwen2.5-0.5B
"""

from __future__ import annotations

import argparse
import dataclasses
import random
from typing import Dict, List, Optional, Sequence


def synthetic_dataset(n: int = 512, seed: int = 0):
    """``n`` prompts "Compute a + b. Final answer: " with a, b in [2, 99],
    drawn as the JAX entry point draws them."""
    from rlinf_tpu_torch.data.datasets import PromptDataset, PromptExample

    rng = random.Random(seed)
    examples = []
    for _ in range(n):
        a, b = rng.randint(2, 99), rng.randint(2, 99)
        examples.append(
            PromptExample(prompt=f"Compute {a} + {b}. Final answer: ", answer=str(a + b))
        )
    return PromptDataset(examples)


def load_model(cfg, model_path: Optional[str], device):
    """(cfg, tokenizer, init_params_override) of a run: with ``model_path``
    the checkpoint's config (in the yaml's dtype), its tokenizer and its
    weights; else the yaml's config, the byte tokenizer and a random init."""
    from rlinf_tpu_torch.data.tokenizers import ByteTokenizer, HFTokenizer

    if not model_path:
        return cfg, ByteTokenizer(), None
    from rlinf_tpu_torch.models.llm.hf_import import load_hf_pretrained

    model_cfg, params = load_hf_pretrained(model_path, dtype=cfg.model.dtype, device=device)
    cfg = dataclasses.replace(cfg, model=model_cfg)
    return cfg, HFTokenizer(model_path), lambda seed: params


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="GRPO/PPO reasoning RL on the port")
    parser.add_argument("--config", required=True)
    parser.add_argument("--model-path", default=None,
                        help="local HF checkpoint dir (Qwen2/Qwen3/Llama family)")
    parser.add_argument("--data-path", default=None,
                        help="jsonl with prompt/answer fields (e.g. GSM8K)")
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
    from rlinf_tpu_torch.runners import ReasoningRunner

    cfg = load_config(args.config, args.overrides)
    cfg, tokenizer, init_override = load_model(cfg, args.model_path, args.device)
    if args.data_path:
        dataset = PromptDataset.from_jsonl(args.data_path, max_examples=cfg.data.max_examples)
    else:
        dataset = synthetic_dataset()
    runner = ReasoningRunner(cfg, tokenizer, dataset, init_params_override=init_override,
                             device=args.device)
    try:
        return runner.run()
    finally:
        runner.logger.close()


if __name__ == "__main__":
    main()
