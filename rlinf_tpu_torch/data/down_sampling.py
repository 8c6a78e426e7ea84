"""GRPO group down-sampling (mask computation, numpy).

The port's own copy of ``rlinf_tpu/data/down_sampling.py``.

Reference analog: rlinf/utils/down_sampling.py down_sample_batch — before
training, per-prompt groups of n samples are filtered:

  * ``reject_equal_reward``: groups whose rewards are all equal carry zero
    GRPO advantage — drop them entirely (saves training compute).
  * ``down_sample_to_n``: shrink each group to n samples, preferring
    low-penalty traces (tool-call error ratio / answer-format penalties) and
    keeping the zero/non-zero reward mix proportional, with configurable
    minimum quotas per side.

Returns a boolean keep-mask; callers apply it to their batch arrays (this
framework's RolloutResult rows are plain numpy, so ``result[mask]`` style
indexing applies directly).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

import numpy as np


def group_uids(total: int, group_size: int) -> np.ndarray:
    return np.arange(total) // max(1, group_size)


def reject_equal_reward_mask(rewards: np.ndarray, group_size: int
                             ) -> np.ndarray:
    """False for every member of a group whose rewards are all (nearly)
    equal — zero GRPO advantage."""
    rewards = np.asarray(rewards, np.float32)
    uids = group_uids(len(rewards), group_size)
    mask = np.ones(len(rewards), bool)
    for uid in np.unique(uids):
        idx = np.nonzero(uids == uid)[0]
        if np.allclose(rewards[idx], rewards[idx[0]]):
            mask[idx] = False
    return mask


def tool_error_ratio(text: str,
                     pattern: str = r"<tool_response>.*?</tool_response>"
                     ) -> float:
    matches = re.findall(pattern, text, re.DOTALL)
    if not matches:
        return 0.5
    return sum("error" in m.lower() for m in matches) / len(matches)


def answer_tag_penalty(
    text: str,
    answer_tags: Optional[Sequence[str]] = None,
    answer_pattern: str = r"<answer>.*?</answer>",
    turn_pattern: str = r"<\|im_start\|>assistant.*?<\|im_end\|>",
) -> float:
    answer_tags = answer_tags or ["<answer>", "</answer>"]
    if any(tag not in text for tag in answer_tags):
        return 1.0
    closed = len(re.findall(answer_pattern, text, re.DOTALL))
    if any(text.count(tag) != closed for tag in answer_tags):
        return 1.0
    num_turns = len(re.findall(turn_pattern, text, re.DOTALL))
    if num_turns == 0:
        return 1.0
    return min((closed - 1) / num_turns, 1.0)


def down_sample_mask(
    rewards: np.ndarray,
    group_size: int,
    cfg: Dict,
    response_texts: Optional[List[str]] = None,
) -> np.ndarray:
    """Combined keep-mask per the reference's policy."""
    rewards = np.asarray(rewards, np.float32)
    n_total = len(rewards)
    uids = group_uids(n_total, group_size)

    mask = (
        reject_equal_reward_mask(rewards, group_size)
        if cfg.get("reject_equal_reward", False)
        else np.ones(n_total, bool)
    )

    n_keep = int(cfg.get("down_sample_to_n", -1))
    if n_keep <= 0:
        return mask

    if response_texts is not None:
        err_w = np.array([tool_error_ratio(t) for t in response_texts])
        fmt_w = np.array([answer_tag_penalty(t) for t in response_texts])
    else:
        err_w = fmt_w = np.zeros(n_total)
    penalty = (
        (err_w if cfg.get("roc_error_ratio", False) else 0.0)
        + (fmt_w if cfg.get("roc_answer_format", False) else 0.0)
    )
    penalty = np.broadcast_to(np.asarray(penalty, np.float64), (n_total,))
    min_zero = int(cfg.get("min_zero_reward_trace_num", 0))
    min_non_zero = int(cfg.get("min_non_zero_reward_trace_num", 0))

    choice = np.zeros(n_total, bool)
    for uid in np.unique(uids):
        idx = np.nonzero(uids == uid)[0]
        if len(idx) < n_keep:
            continue
        if len(idx) == n_keep:
            choice[idx] = True
            continue
        zero = [(i, penalty[i]) for i in idx if rewards[i] <= 0]
        nonzero = sorted(
            [(i, penalty[i]) for i in idx if rewards[i] > 0],
            key=lambda x: x[1],
        )
        z_quota = round(len(zero) * n_keep / len(idx))
        nz_quota = round(len(nonzero) * n_keep / len(idx))
        if z_quota <= min(min_zero, len(zero)):
            z_quota = min(min_zero, len(zero))
            nz_quota = n_keep - z_quota
        if nz_quota <= min(min_non_zero, len(nonzero)):
            nz_quota = min(min_non_zero, len(nonzero))
            z_quota = n_keep - nz_quota
        chosen = [i for i, _ in nonzero[:nz_quota]] + [i for i, _ in zero[:z_quota]]
        if len(chosen) != n_keep:
            ordered = [i for i, _ in sorted(zero + nonzero, key=lambda x: x[1])]
            chosen = ordered[:n_keep]
        choice[np.asarray(chosen, int)] = True
    return mask & choice
