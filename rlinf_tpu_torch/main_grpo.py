"""GRPO/PPO reasoning RL entry point of the port.

The port's ``examples/reasoning/main_grpo.py``: load the config, build the
runner, run. Positional overrides ``a.b=c`` follow ``--config``. Without
``--data-path`` the prompts are the JAX entry point's 512 synthetic
additions with verifiable answers; ``--data-path`` reads a jsonl of
prompt/answer rows. The tokenizer is the byte tokenizer and the weights are
random from ``runner.seed``: ``--model-path`` (a Hugging Face checkpoint)
waits for the port of ``models/llm/hf_import.py`` (ROADMAP.md §A.4). The run
is on the card unless ``--device cpu`` is given.

Usage:
  python -m rlinf_tpu_torch.main_grpo --config examples/reasoning/config/grpo_demo_tiny.yaml --device cpu
  python -m rlinf_tpu_torch.main_grpo --config ... optimizer.lr=2e-6 runner.max_steps=200
"""

from __future__ import annotations

import argparse
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


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="GRPO/PPO reasoning RL on the port")
    parser.add_argument("--config", required=True)
    parser.add_argument("--model-path", default=None,
                        help="local HF checkpoint dir (not ported yet: ROADMAP.md §A.4)")
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
    from rlinf_tpu_torch.data.tokenizers import ByteTokenizer
    from rlinf_tpu_torch.runners import ReasoningRunner

    if args.model_path:
        raise NotImplementedError(
            "--model-path (Hugging Face checkpoints and tokenizers) comes with the port "
            "of models/llm/hf_import.py (ROADMAP.md §A.4)")
    cfg = load_config(args.config, args.overrides)
    if args.data_path:
        dataset = PromptDataset.from_jsonl(args.data_path, max_examples=cfg.data.max_examples)
    else:
        dataset = synthetic_dataset()
    runner = ReasoningRunner(cfg, ByteTokenizer(), dataset, device=args.device)
    try:
        return runner.run()
    finally:
        runner.logger.close()


if __name__ == "__main__":
    main()
