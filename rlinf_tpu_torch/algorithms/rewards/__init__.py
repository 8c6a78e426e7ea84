"""Reward functions: the math verifier, the code-execution verifier, the
HTTP judge client, the QA metrics (EM, F1, VQA soft accuracy) and the
rStar2 scorer: every module of ``rlinf_tpu/algorithms/rewards``."""

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
from rlinf_tpu_torch.algorithms.rewards.qa_metrics import (
    batch_em_rewards,
    batch_f1_rewards,
    batch_vqa_rewards,
    exact_match,
    extract_final_answer,
    f1_score,
    normalize_qa_answer,
    vqa_reward,
)
from rlinf_tpu_torch.algorithms.rewards.rstar2_score import rstar2_compute_score, rstar2_reward

__all__ = [
    "APIRewardClient", "default_score_parser", "frame_to_data_url",
    "batch_code_rewards", "code_reward", "extract_code", "run_test_case",
    "batch_math_rewards", "extract_answer", "grade_answer", "math_reward",
    "batch_em_rewards", "batch_f1_rewards", "batch_vqa_rewards", "exact_match",
    "extract_final_answer", "f1_score", "normalize_qa_answer", "vqa_reward",
    "rstar2_compute_score", "rstar2_reward",
]
