"""Reward functions: the math verifier, the code-execution verifier and the
HTTP judge client (``qa_metrics`` and ``rstar2_score`` of
``rlinf_tpu/algorithms/rewards`` are not ported yet)."""

from rlinf_tpu_torch.algorithms.rewards.api_reward import (
    APIRewardClient,
    default_score_parser,
    frame_to_data_url,
)
from rlinf_tpu_torch.algorithms.rewards.code_verifier import (
    batch_code_rewards,
    code_reward,
    extract_code,
    run_test_case,
)
from rlinf_tpu_torch.algorithms.rewards.math_verifier import (
    batch_math_rewards,
    extract_answer,
    grade_answer,
    math_reward,
)

__all__ = [
    "APIRewardClient", "default_score_parser", "frame_to_data_url",
    "batch_code_rewards", "code_reward", "extract_code", "run_test_case",
    "batch_math_rewards", "extract_answer", "grade_answer", "math_reward",
]
