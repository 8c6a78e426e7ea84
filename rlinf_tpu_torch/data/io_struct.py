"""Rollout request/result structs (host-side numpy).

The port's own copy of ``RolloutRequest`` and ``RolloutResult`` from
``rlinf_tpu/data/io_struct.py``: the rollout layout is left-padded prompts
plus right-padded responses.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class RolloutRequest:
    """A batch of prompts headed for generation.

    ``group_size``-fold repetition for GRPO happens here (``repeat``).
    """

    prompt_ids: List[List[int]]              # ragged token lists
    answers: Optional[List[str]] = None      # ground truth for rule rewards
    meta: Optional[List[dict]] = None
    #: per-request decode budget override; None = the engine's max_new_tokens
    max_new_tokens: Optional[List[int]] = None

    def repeat(self, group_size: int) -> "RolloutRequest":
        rep = lambda xs: None if xs is None else [
            x for x in xs for _ in range(group_size)
        ]
        return RolloutRequest(
            prompt_ids=rep(self.prompt_ids),
            answers=rep(self.answers),
            meta=rep(self.meta),
            max_new_tokens=rep(self.max_new_tokens),
        )

    def budget_for(self, i: int, default: int) -> int:
        if self.max_new_tokens is None:
            return default
        return int(self.max_new_tokens[i])

    def left_padded(self, pad_id: int, bucket: int = 64):
        """(prompt_ids [B, P], prompt_mask [B, P]) with P bucketed."""
        B = len(self.prompt_ids)
        max_len = max(len(p) for p in self.prompt_ids)
        P = _round_up(max_len, bucket)
        ids = np.full((B, P), pad_id, np.int32)
        mask = np.zeros((B, P), bool)
        for i, p in enumerate(self.prompt_ids):
            ids[i, P - len(p):] = p
            mask[i, P - len(p):] = True
        return ids, mask


@dataclasses.dataclass
class RolloutResult:
    """Generation output in rollout layout."""

    prompt_ids: np.ndarray          # [B, P] int32 left-padded
    prompt_mask: np.ndarray         # [B, P] bool
    response_ids: np.ndarray        # [B, N] int32 right-padded
    response_mask: np.ndarray       # [B, N] bool
    response_logprobs: np.ndarray   # [B, N] fp32
    rewards: Optional[np.ndarray] = None       # [B] fp32
    answers: Optional[List[str]] = None
    #: param version that produced this rollout (policy-lag bookkeeping)
    version: int = 0

    @property
    def batch_size(self) -> int:
        return self.prompt_ids.shape[0]

    @property
    def prompt_lengths(self) -> np.ndarray:
        return self.prompt_mask.sum(-1).astype(np.int32)

    @property
    def response_lengths(self) -> np.ndarray:
        return self.response_mask.sum(-1).astype(np.int32)

    def response_texts(self, tokenizer) -> List[str]:
        out = []
        for i in range(self.batch_size):
            n = int(self.response_lengths[i])
            out.append(tokenizer.decode(self.response_ids[i, :n].tolist()))
        return out


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
