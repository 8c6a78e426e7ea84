"""Multi-turn tool-calling rollout loop.

Port of ``rlinf_tpu/agents/agent_loop.py``: generate -> parse toolcall ->
invoke tool -> append observation -> regenerate, assembling token sequences
with PER-TURN LOSS MASKS (model tokens on, tool/env tokens off). Each round
batches all still-active conversations through the rollout engine.

The loop takes one ``torch.Generator`` and hands it to every round's
rollout (the JAX loop splits its key every turn).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from rlinf_tpu_torch.algorithms.toolcall_parsers import get_toolcall_parser
from rlinf_tpu_torch.agents.tools import ToolRegistry
from rlinf_tpu_torch.data.io_struct import RolloutRequest, TrainBatch


@dataclasses.dataclass(frozen=True)
class AgentLoopConfig:
    max_turns: int = 4
    parser: str = "tag"
    max_total_len: int = 2048
    tool_result_template: str = "\n<result>{}</result>\n"


@dataclasses.dataclass
class AgentRollout:
    """One finished conversation."""

    token_ids: List[int]
    loss_mask: List[bool]        # True on model-generated tokens
    logprobs: List[float]        # behavior logprobs (0.0 on env tokens)
    num_turns: int = 0
    num_tool_calls: int = 0
    final_text: str = ""
    prompt_len: int = 0
    # [(start, end)] token span of each MODEL turn: feeds the per-turn
    # grpo_dynamic advantages (turn mode)
    turn_spans: List[tuple] = dataclasses.field(default_factory=list)
    # True where turn k's tool feedback errored: feeds failed-turn loss
    # masking
    turn_errors: List[bool] = dataclasses.field(default_factory=list)


class AgentLoop:
    def __init__(
        self,
        engine,
        tokenizer,
        tools: ToolRegistry,
        cfg: AgentLoopConfig = AgentLoopConfig(),
    ):
        self.engine = engine
        self.tokenizer = tokenizer
        self.tools = tools
        self.cfg = cfg
        self.parse = get_toolcall_parser(cfg.parser)

    def _truncate_at_toolcall(
        self, ids: Sequence[int], lps: Sequence[float]
    ) -> tuple:
        """Find the shortest token prefix whose decoded text contains a
        complete tool call; returns (ids, lps, ToolCall|None)."""
        text = self.tokenizer.decode(list(ids))
        call = self.parse(text)
        if call is None:
            return list(ids), list(lps), None
        # token-accurate cut: grow prefix until the call's span is covered
        for n in range(1, len(ids) + 1):
            prefix = self.tokenizer.decode(list(ids[:n]))
            if len(prefix) >= call.end_pos:
                return list(ids[:n]), list(lps[:n]), call
        return list(ids), list(lps), call

    def run(
        self,
        params,
        prompt_ids: List[List[int]],
        generator: torch.Generator,
    ) -> List[AgentRollout]:
        n = len(prompt_ids)
        rollouts = [
            AgentRollout(
                token_ids=list(p),
                loss_mask=[False] * len(p),
                logprobs=[0.0] * len(p),
                prompt_len=len(p),
            )
            for p in prompt_ids
        ]
        active = list(range(n))

        for turn in range(self.cfg.max_turns):
            if not active:
                break
            request = RolloutRequest(
                prompt_ids=[rollouts[i].token_ids for i in active]
            )
            result = self.engine.rollout(params, request, generator)

            next_active = []
            for row, i in enumerate(active):
                r = rollouts[i]
                rlen = int(result.response_lengths[row])
                ids = result.response_ids[row, :rlen].tolist()
                lps = result.response_logprobs[row, :rlen].tolist()
                ids, lps, call = self._truncate_at_toolcall(ids, lps)

                start = len(r.token_ids)
                r.token_ids.extend(ids)
                r.loss_mask.extend([True] * len(ids))
                r.logprobs.extend(lps)
                r.turn_spans.append((start, len(r.token_ids)))
                r.turn_errors.append(False)
                r.num_turns += 1

                if call is not None and turn < self.cfg.max_turns - 1:
                    r.num_tool_calls += 1
                    tool_out = self.tools.call(call.tool, call.args, session=i)
                    r.turn_errors[-1] = str(tool_out).startswith("error")
                    obs = self.cfg.tool_result_template.format(tool_out)
                    obs_ids = self.tokenizer.encode(obs)
                    room = self.cfg.max_total_len - len(r.token_ids)
                    obs_ids = obs_ids[: max(room, 0)]
                    r.token_ids.extend(obs_ids)
                    r.loss_mask.extend([False] * len(obs_ids))
                    r.logprobs.extend([0.0] * len(obs_ids))
                    if len(r.token_ids) < self.cfg.max_total_len:
                        next_active.append(i)
            active = next_active

        for r in rollouts:
            r.final_text = self.tokenizer.decode(
                r.token_ids[r.prompt_len:]
            )
        return rollouts


def build_turn_level_train_batch(
    rollouts: List[AgentRollout],
    turn_rewards: List[List[float]],
    group_size: int,
    *,
    pad_id: int,
    advantage_mode: str = "turn",
    seq_bucket: int = 128,
) -> TrainBatch:
    """Multi-turn/multi-agent GRPO batch (grpo_dynamic advantages):
    every trajectory contributes per-TURN rewards; grpo_dynamic normalizes
    across the group and each model turn's tokens get its own advantage.

    ``turn_rewards[i][k]`` scores rollout i's k-th model turn. Rollouts are
    grouped consecutively: trajectories [0..group_size) share question 0, etc.
    """
    from rlinf_tpu_torch.algorithms.advantages import compute_grpo_dynamic_advantages

    flat_rewards, idx_to_traj = [], []
    for i, r in enumerate(rollouts):
        assert len(turn_rewards[i]) == len(r.turn_spans), (
            f"rollout {i}: {len(turn_rewards[i])} rewards vs "
            f"{len(r.turn_spans)} turns")
        for rew in turn_rewards[i]:
            flat_rewards.append(float(rew))
            idx_to_traj.append(i)
    turn_adv, _ = compute_grpo_dynamic_advantages(
        torch.tensor(flat_rewards, dtype=torch.float32),
        torch.ones((1, len(flat_rewards)), dtype=torch.float32),
        group_size, idx_to_traj, advantage_mode=advantage_mode)
    turn_adv = turn_adv[0].numpy()   # [num_turns]

    batch = build_agent_train_batch(
        rollouts, np.zeros(len(rollouts), np.float32), pad_id=pad_id,
        seq_bucket=seq_bucket)
    advantages = np.asarray(batch.advantages)
    T = advantages.shape[1]
    turn_idx = 0
    for i, r in enumerate(rollouts):
        for (start, end) in r.turn_spans:
            # target at position t scores token t+1: shift spans left by 1
            lo, hi = max(start - 1, 0), min(end - 1, T)
            advantages[i, lo:hi] = np.where(
                np.asarray(batch.loss_mask[i, lo:hi]),
                turn_adv[turn_idx], advantages[i, lo:hi])
            turn_idx += 1
    return dataclasses.replace(batch, advantages=advantages)


def build_agent_train_batch(
    rollouts: List[AgentRollout],
    sequence_advantages: np.ndarray,
    *,
    pad_id: int,
    seq_bucket: int = 128,
) -> TrainBatch:
    """AgentRollouts -> TrainBatch with per-turn loss masks.

    sequence_advantages: [B] per-conversation advantage (GRPO over final
    rewards), broadcast to every MODEL token (tool/env tokens contribute
    nothing — their loss_mask is False).
    """
    B = len(rollouts)
    T = max(len(r.token_ids) for r in rollouts)
    T = ((T + seq_bucket - 1) // seq_bucket) * seq_bucket

    input_ids = np.full((B, T), pad_id, np.int32)
    attention_mask = np.zeros((B, T), bool)
    target_ids = np.full((B, T), pad_id, np.int32)
    loss_mask = np.zeros((B, T), bool)
    old_logprobs = np.zeros((B, T), np.float32)
    advantages = np.zeros((B, T), np.float32)

    for i, r in enumerate(rollouts):
        seq = np.asarray(r.token_ids, np.int32)[:T]
        gmask = np.asarray(r.loss_mask, bool)[:T]
        lps = np.asarray(r.logprobs, np.float32)[:T]
        nlen = len(seq)
        input_ids[i, :nlen] = seq
        attention_mask[i, :nlen] = True
        target_ids[i, : nlen - 1] = seq[1:]
        # position t predicts token t+1: model-token targets only
        loss_mask[i, : nlen - 1] = gmask[1:]
        old_logprobs[i, : nlen - 1] = lps[1:]
        advantages[i, : nlen - 1] = np.where(
            gmask[1:], sequence_advantages[i], 0.0
        )

    return TrainBatch(
        input_ids=input_ids,
        attention_mask=attention_mask,
        target_ids=target_ids,
        loss_mask=loss_mask,
        old_logprobs=old_logprobs,
        advantages=advantages,
    )
