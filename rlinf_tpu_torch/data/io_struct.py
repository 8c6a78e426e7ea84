"""Rollout request/result and training-batch structs (host-side numpy).

The port's own copy of ``RolloutRequest``, ``RolloutResult``,
``TrainBatch`` and ``build_train_batch`` from
``rlinf_tpu/data/io_struct.py``: the rollout layout is left-padded prompts
plus right-padded responses; the training layout is right-padded
sequences with pre-shifted targets.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

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


@dataclasses.dataclass
class TrainBatch:
    """Right-padded training layout with pre-shifted targets.

    All arrays [B, T] except rewards [B]. ``loss_mask[t]`` is True iff
    ``target_ids[t]`` is a real response token; old_logprobs/advantages are
    aligned with target_ids (fp32).
    """

    input_ids: np.ndarray
    attention_mask: np.ndarray
    target_ids: np.ndarray
    loss_mask: np.ndarray
    old_logprobs: np.ndarray
    advantages: np.ndarray
    ref_logprobs: Optional[np.ndarray] = None

    def to_dict(self) -> Dict[str, np.ndarray]:
        d = {
            "input_ids": self.input_ids,
            "attention_mask": self.attention_mask,
            "target_ids": self.target_ids,
            "loss_mask": self.loss_mask,
            "old_logprobs": self.old_logprobs,
            "advantages": self.advantages,
        }
        if self.ref_logprobs is not None:
            d["ref_logprobs"] = self.ref_logprobs
        return d

    @property
    def num_valid_tokens(self) -> int:
        return int(self.loss_mask.sum())


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def build_train_batch(
    result: RolloutResult,
    token_advantages: np.ndarray,
    *,
    pad_id: int,
    seq_bucket: int = 128,
    max_len: Optional[int] = None,
) -> TrainBatch:
    """Re-layout rollout output into the training layout.

    token_advantages: [B, N] advantages aligned with response tokens (the
    output layout of the GRPO/reinpp estimators transposed to batch-major).
    """
    B = result.batch_size
    plens = result.prompt_lengths
    rlens = result.response_lengths
    total = plens + rlens
    T = _round_up(int(total.max()), seq_bucket)
    if max_len is not None:
        T = min(T, max_len)

    input_ids = np.full((B, T), pad_id, np.int32)
    attention_mask = np.zeros((B, T), bool)
    target_ids = np.full((B, T), pad_id, np.int32)
    loss_mask = np.zeros((B, T), bool)
    old_logprobs = np.zeros((B, T), np.float32)
    advantages = np.zeros((B, T), np.float32)

    P = result.prompt_ids.shape[1]
    for i in range(B):
        p, r = int(plens[i]), int(rlens[i])
        r = min(r, T - p)
        seq = np.concatenate(
            [result.prompt_ids[i, P - p:], result.response_ids[i, :r]]
        )
        input_ids[i, : p + r] = seq
        attention_mask[i, : p + r] = True
        # next-token targets: position t predicts seq[t+1]
        target_ids[i, : p + r - 1] = seq[1:]
        # response token j sits at seq position p+j => predicted at t=p+j-1
        loss_mask[i, p - 1 : p + r - 1] = True
        old_logprobs[i, p - 1 : p + r - 1] = result.response_logprobs[i, :r]
        advantages[i, p - 1 : p + r - 1] = token_advantages[i, :r]

    return TrainBatch(
        input_ids=input_ids,
        attention_mask=attention_mask,
        target_ids=target_ids,
        loss_mask=loss_mask,
        old_logprobs=old_logprobs,
        advantages=advantages,
    )
