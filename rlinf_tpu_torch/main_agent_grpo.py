"""Agentic GRPO: multi-turn tool-calling rollouts trained with GRPO.

The port's ``examples/agentic/main_agent_grpo.py``: the same config (the
JAX example's tiny model, 24 new tokens a turn, lr 1e-4, GRPO in groups of
4, 4 prompts a step, 20 steps), dataset (32 "compute i+i" prompts), byte
tokenizer, calculator tool and substring reward. ``--preset`` names an
``LLMConfig`` preset in place of the tiny model (head dim 16, f32, which
the kernels take on the card). Positional overrides ``a.b=c`` follow the
flags, as in ``main_grpo``. The run is on the card unless ``--device cpu``
is given.

Usage:
  python -m rlinf_tpu_torch.main_agent_grpo runner.max_steps=2
  python -m rlinf_tpu_torch.main_agent_grpo --device cpu runner.max_steps=2
  python -m rlinf_tpu_torch.main_agent_grpo --preset qwen2_0_5b runner.max_steps=2
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Agentic GRPO on the port")
    ap.add_argument("--preset", default="tiny",
                    help="LLMConfig preset (tiny = the JAX example's model, vocab 258, "
                         "512 positions)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (cuda, or cpu for the plain "
                         "versions of the kernels)")
    ap.add_argument("overrides", nargs="*", default=[])
    return ap.parse_args(argv)


def trainer_config(preset: str = "tiny", overrides: Sequence[str] = ()):
    """The JAX example's TrainerConfig, with ``preset``'s model, then
    ``overrides``."""
    from rlinf_tpu_torch.config import (
        AlgorithmConfig, RunnerConfig, TrainerConfig, apply_overrides, config_from_dict,
        config_to_dict,
    )
    from rlinf_tpu_torch.models.llm import LLMConfig, SamplingParams
    from rlinf_tpu_torch.serve_openai import model_config
    from rlinf_tpu_torch.training.train_state import OptimizerConfig

    model = (LLMConfig.tiny(vocab_size=258, max_seq_len=512) if preset == "tiny"
             else model_config(preset))
    cfg = TrainerConfig(
        model=model,
        sampling=SamplingParams(max_new_tokens=24, eos_token_id=-1),
        optimizer=OptimizerConfig(lr=1e-4),
        algorithm=AlgorithmConfig(adv_type="grpo", group_size=4),
        runner=RunnerConfig(rollout_batch_size=4, max_steps=20,
                            log_dir="logs/agent_demo"),
    )
    if not overrides:
        return cfg
    data = config_to_dict(cfg)
    apply_overrides(data, overrides)
    return config_from_dict(data)


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, float]]:
    """Run the config's steps; returns each step's metrics."""
    args = parse_args(argv)

    from rlinf_tpu_torch.agents import AgentLoopConfig, CalculatorTool, ToolRegistry
    from rlinf_tpu_torch.data.datasets import PromptDataset, PromptExample
    from rlinf_tpu_torch.data.tokenizers import ByteTokenizer
    from rlinf_tpu_torch.runners.agent_runner import AgentRunner

    cfg = trainer_config(args.preset, args.overrides)
    dataset = PromptDataset(
        [PromptExample(f"compute {i}+{i}: ", str(2 * i)) for i in range(32)])
    runner = AgentRunner(
        cfg, ByteTokenizer(), dataset,
        tools=ToolRegistry([CalculatorTool()]),
        reward_fn=lambda texts, answers: [
            1.0 if a in t else 0.0 for t, a in zip(texts, answers)],
        loop_cfg=AgentLoopConfig(max_turns=2, max_total_len=256),
        device=args.device,
    )
    try:
        return runner.run()
    finally:
        runner.logger.close()


if __name__ == "__main__":
    main()
