"""Advantage estimators: GAE, GRPO, Reinforce++, OPD, raw, multi-turn GRPO.

Port of ``rlinf_tpu/algorithms/advantages.py``: same recursions, same eps
constants, ddof=1 standard deviations. ``lax.scan`` becomes a Python loop
over time.

Shape conventions follow the JAX package:
  * time-major trajectories: rewards/values/dones as [T(,+1), B]
  * grouped LLM rewards: [num_prompts * group_size] with loss_mask [L, B]
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rlinf_tpu_torch.algorithms.registry import register_advantage
from rlinf_tpu_torch.algorithms.utils import kl_penalty, masked_mean, safe_normalize


@register_advantage("gae")
def compute_gae_advantages_and_returns(
    rewards: torch.Tensor,
    gamma: float = 1.0,
    gae_lambda: float = 1.0,
    values: Optional[torch.Tensor] = None,
    normalize_advantages: bool = True,
    normalize_returns: bool = False,
    loss_mask: Optional[torch.Tensor] = None,
    dones: Optional[torch.Tensor] = None,
    **kwargs,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generalized Advantage Estimation.

    rewards [T, B]; values [T+1, B] or None (critic-free: gamma=lambda=1,
    the advantage is the reward-to-go); dones [T+1, B], ``dones[t+1]``
    gates the bootstrap at t. Returns (advantages [T, B], returns [T, B]).
    """
    rewards = rewards.float()
    critic_free = values is None
    if critic_free:
        gamma, gae_lambda = 1.0, 1.0
        values_cur = torch.zeros_like(rewards)
    else:
        values = values.float()
        values_next, values_cur = values[1:], values[:-1]
    if dones is None:
        not_done_next = torch.ones_like(rewards)
    else:
        not_done_next = 1.0 - dones[1:].float()

    if critic_free:
        delta = rewards
    else:
        delta = rewards + gamma * values_next * not_done_next - values_cur

    gaes = torch.empty_like(rewards)
    gae = torch.zeros_like(rewards[0])
    for t in range(rewards.shape[0] - 1, -1, -1):
        gae = delta[t] + gamma * gae_lambda * not_done_next[t] * gae
        gaes[t] = gae

    if critic_free:
        returns = gaes
        advantages = returns
    else:
        returns = gaes + values_cur
        advantages = returns - values_cur

    if normalize_advantages:
        advantages = safe_normalize(advantages, loss_mask=loss_mask)
    if normalize_returns:
        returns = safe_normalize(returns, loss_mask=loss_mask)
    return advantages, returns


@register_advantage("grpo")
def compute_grpo_advantages(
    rewards: torch.Tensor,
    loss_mask: torch.Tensor,
    group_size: int,
    **kwargs,
) -> Tuple[torch.Tensor, None]:
    """Group-relative baseline: per-group (r - mean) / (std + 1e-6), std
    with ddof=1. rewards [num_prompts * group_size]; loss_mask [L, B]."""
    rewards = rewards.float().reshape(-1, group_size)
    mean = rewards.mean(dim=-1, keepdim=True)
    var = (rewards - mean).square().sum(dim=-1, keepdim=True) / max(group_size - 1, 1)
    adv = (rewards - mean) / (var.sqrt() + 1e-6)
    return adv.reshape(1, -1) * loss_mask.float(), None


@register_advantage("reinpp")
def compute_reinpp_advantages(
    rewards: torch.Tensor,
    loss_mask: torch.Tensor,
    group_size: int,
    use_reinpp_baseline: bool = False,
    kl_beta: float = 0.0,
    logprob: Optional[torch.Tensor] = None,
    ref_logprob: Optional[torch.Tensor] = None,
    kl_penalty_type: str = "k1",
    **kwargs,
) -> Tuple[torch.Tensor, None]:
    """Reinforce++: terminal reward scattered at the last valid token,
    optional per-token KL shaping, reverse-cumsum returns, masked whitening
    with rsqrt(clamped var)."""
    rewards = rewards.float().reshape(-1)
    if use_reinpp_baseline:
        grouped = rewards.reshape(-1, group_size)
        rewards = (grouped - grouped.mean(dim=1, keepdim=True)).reshape(-1)

    L, B = loss_mask.shape
    mask_f = loss_mask.float()
    eos_idx = L - 1 - torch.argmax(mask_f.flip(0), dim=0)  # first max, as jnp.argmax
    r_matrix = torch.zeros((L, B), dtype=torch.float32, device=rewards.device)
    r_matrix[eos_idx, torch.arange(B, device=rewards.device)] = rewards

    if kl_beta > 0:
        r_matrix = r_matrix - kl_beta * kl_penalty(logprob, ref_logprob, kl_penalty_type)

    ret = r_matrix.flip(0).cumsum(dim=0).flip(0)
    mean = masked_mean(ret, loss_mask)
    var = masked_mean((ret - mean).square(), loss_mask)
    return (ret - mean) * torch.rsqrt(var.clamp_min(1e-8)), None


@register_advantage("opd")
def compute_opd_advantages(
    prev_logprobs: torch.Tensor,
    teacher_logprobs: torch.Tensor,
    loss_mask: Optional[torch.Tensor] = None,
    num_action_chunks: Optional[int] = None,
    **kwargs,
) -> Tuple[torch.Tensor, None]:
    """On-policy distillation: reverse-KL dense reward teacher_lp - student_lp."""
    if num_action_chunks is None:
        raise ValueError("opd advantages need num_action_chunks")
    adv = teacher_logprobs.float() - prev_logprobs.float()
    adv = adv.reshape(*adv.shape[:-1], num_action_chunks, -1)
    if loss_mask is not None:
        adv = adv[: loss_mask.shape[0]]
    return adv, None


@register_advantage("raw")
def compute_raw_advantages(
    rewards: torch.Tensor,
    loss_mask: torch.Tensor,
    normalize_advantages: bool = False,
    **kwargs,
) -> Tuple[torch.Tensor, None]:
    """Broadcast the per-sequence reward to all tokens."""
    rewards = rewards.float().reshape(-1)
    adv = rewards[None, :] * loss_mask.float()
    if normalize_advantages:
        adv = safe_normalize(adv, loss_mask) * loss_mask.float()
    return adv, None


@register_advantage("grpo_dynamic")
def compute_grpo_dynamic_advantages(
    rewards: torch.Tensor,
    loss_mask: torch.Tensor,
    group_size: int,
    idx_to_traj,
    advantage_mode: str = "turn",
    **kwargs,
) -> Tuple[torch.Tensor, None]:
    """Multi-turn/multi-agent GRPO: per-QUESTION normalization where each
    question owns ``group_size`` trajectories of one or more turns.

    rewards [num_turns]; loss_mask [L, num_turns]; idx_to_traj: turn index
    -> global trajectory index (a host-side list).
    """
    rewards = rewards.float().reshape(-1)
    dev = rewards.device
    idx_to_traj = np.asarray(idx_to_traj, np.int64)
    num_traj = int(idx_to_traj.max()) + 1
    if num_traj % group_size:
        raise ValueError(f"{num_traj} trajectories do not split into groups of {group_size}")
    num_questions = num_traj // group_size
    turn_onehot = F.one_hot(torch.as_tensor(idx_to_traj, device=dev), num_traj).float()

    if advantage_mode == "trajectory":
        counts = turn_onehot.sum(dim=0).clamp_min(1.0)
        traj_rewards = (rewards @ turn_onehot) / counts
        grouped = traj_rewards.reshape(num_questions, group_size)
        mean = grouped.mean(dim=-1, keepdim=True)
        var = (grouped - mean).square().sum(dim=-1, keepdim=True) / max(group_size - 1, 1)
        normalized = ((grouped - mean) / (var.sqrt() + 1e-6)).reshape(-1)
        turn_adv = turn_onehot @ normalized
    elif advantage_mode == "turn":
        turn_to_q = torch.as_tensor(idx_to_traj // group_size, device=dev)
        q_onehot = F.one_hot(turn_to_q, num_questions).float()
        n_q = q_onehot.sum(dim=0).clamp_min(1.0)
        mean_q = (rewards @ q_onehot) / n_q
        centered = rewards - q_onehot @ mean_q
        var_q = (centered.square() @ q_onehot) / (n_q - 1.0).clamp_min(1.0)
        turn_adv = centered / (q_onehot @ var_q.sqrt() + 1e-6)
    else:
        raise ValueError(f"invalid advantage_mode {advantage_mode!r}")
    return turn_adv[None, :] * loss_mask.float(), None
