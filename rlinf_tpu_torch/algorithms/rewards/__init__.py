"""Rule-based reward functions (the math verifier; the other reward
modules of ``rlinf_tpu/algorithms/rewards`` are not ported yet)."""

from rlinf_tpu_torch.algorithms.rewards.math_verifier import (
    batch_math_rewards,
    extract_answer,
    grade_answer,
    math_reward,
)

__all__ = ["batch_math_rewards", "extract_answer", "grade_answer", "math_reward"]
