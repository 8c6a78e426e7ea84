"""Training loops of the port: the GRPO/PPO reasoning runner."""

from rlinf_tpu_torch.runners.reasoning_runner import ReasoningRunner

__all__ = ["ReasoningRunner"]
