"""Policy and value losses: PPO clip (+dual-clip), decoupled PPO, the
clipped-value critic loss, actor-critic and OPD.

Port of ``rlinf_tpu/algorithms/losses.py`` (``compute_ppo_actor_loss``,
``compute_decoupled_ppo_actor_loss``, ``compute_ppo_critic_loss``,
``compute_opd_actor_loss`` and every registration). Inputs are promoted to
float32; every loss returns ``(loss, metrics)`` with the JAX package's
metric keys. ``jax.lax.stop_gradient`` becomes ``detach``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from rlinf_tpu_torch.algorithms.registry import register_policy_loss
from rlinf_tpu_torch.algorithms.utils import huber_loss, masked_mean, masked_mean_ratio


def _f32(x):
    return None if x is None else x.float()


def _agg(values, mask, loss_mask_ratio, loss_agg_func):
    if loss_mask_ratio is not None:
        return masked_mean_ratio(values, mask, loss_mask_ratio)
    return loss_agg_func(values, mask)


def _check_dual_clip(clip_ratio_c):
    if clip_ratio_c is not None and not clip_ratio_c > 1.0:
        raise ValueError(f"clip_ratio_c must be > 1.0, got {clip_ratio_c}")


def compute_ppo_actor_loss(
    logprobs: torch.Tensor,
    old_logprobs: torch.Tensor,
    clip_ratio_low: float,
    clip_ratio_high: float,
    advantages: torch.Tensor,
    loss_mask: Optional[torch.Tensor] = None,
    clip_ratio_c: Optional[float] = None,
    loss_agg_func: Callable = masked_mean,
    max_episode_steps: Optional[int] = None,
    loss_mask_sum: Optional[torch.Tensor] = None,
    critic_warmup: bool = False,
    clip_log_ratio_min: Optional[float] = None,
    clip_log_ratio_max: Optional[float] = None,
    **kwargs,
) -> Tuple[torch.Tensor, dict]:
    """PPO-clip actor loss with optional dual-clip.

    loss = max(-A*r, -A*clip(r, 1-lo, 1+hi)); dual-clip floors the loss at
    sign(A)*c*A when that is smaller (for strongly negative advantages).
    """
    _check_dual_clip(clip_ratio_c)
    logprobs, old_logprobs, advantages = _f32(logprobs), _f32(old_logprobs), _f32(advantages)
    if loss_mask is None:
        loss_mask = torch.ones_like(logprobs, dtype=torch.bool)
    loss_mask_b = loss_mask.bool()
    mask_f = loss_mask.float()

    loss_mask_ratio = None
    if max_episode_steps is not None and loss_mask_sum is not None:
        loss_mask_ratio = loss_mask_sum.float() / max_episode_steps

    count = mask_f.sum().clamp_min(1.0)
    log_ratio = logprobs - old_logprobs
    if clip_log_ratio_min is not None:
        log_ratio = log_ratio.clamp_min(clip_log_ratio_min)
    if clip_log_ratio_max is not None:
        log_ratio = log_ratio.clamp_max(clip_log_ratio_max)
    ratio = torch.where(loss_mask_b, torch.exp(log_ratio), 0.0)
    approx_kl_terms = torch.where(loss_mask_b, log_ratio.detach(), 0.0)

    clipped_ratio = ratio.clamp(1.0 - clip_ratio_low, 1.0 + clip_ratio_high)
    pg1 = -advantages * ratio
    pg2 = -advantages * clipped_ratio
    policy_loss = torch.maximum(pg1, pg2)
    clip_mask = pg1.detach() < pg2.detach()

    if clip_ratio_c is not None:
        pg3 = torch.sign(advantages) * clip_ratio_c * advantages
        dual_clip_mask = pg3.detach() < policy_loss.detach()
        policy_loss = torch.minimum(policy_loss, pg3)
    else:
        dual_clip_mask = torch.zeros_like(clip_mask)

    metric_loss_abs = _agg(policy_loss.abs(), mask_f, loss_mask_ratio, loss_agg_func)
    loss = _agg(policy_loss, mask_f, loss_mask_ratio, loss_agg_func)

    dual_clip_mask = dual_clip_mask & loss_mask_b
    clip_fraction = (clip_mask & loss_mask_b).sum() / count
    approx_kl = -approx_kl_terms.sum() / count
    dual_clipped_ratio = torch.where(dual_clip_mask, ratio, 0.0)

    if critic_warmup:
        loss = torch.zeros_like(loss)

    metrics = {
        "actor/policy_loss": loss.detach(),
        "actor/policy_loss_abs": metric_loss_abs.detach(),
        "actor/ratio": masked_mean(ratio.detach(), mask_f),
        "actor/ratio_abs": masked_mean((ratio.detach() - 1.0).abs(), mask_f),
        "actor/clipped_ratio": masked_mean(clipped_ratio.detach(), mask_f),
        "actor/dual_cliped_ratio": masked_mean(dual_clipped_ratio.detach(), mask_f),
        "actor/approx_kl": approx_kl,
        "actor/clip_fraction": clip_fraction.float(),
    }
    return loss, metrics


def compute_decoupled_ppo_actor_loss(
    logprobs: torch.Tensor,
    old_logprobs: torch.Tensor,
    clip_ratio_low: float,
    clip_ratio_high: float,
    advantages: torch.Tensor,
    proximal_logprobs: Optional[torch.Tensor] = None,
    versions: Optional[torch.Tensor] = None,
    current_version=None,
    loss_mask: Optional[torch.Tensor] = None,
    clip_ratio_c: Optional[float] = None,
    loss_agg_func: Callable = masked_mean,
    max_episode_steps: Optional[int] = None,
    loss_mask_sum: Optional[torch.Tensor] = None,
    critic_warmup: bool = False,
    behave_weight_threshold: Optional[float] = None,
    **kwargs,
) -> Tuple[torch.Tensor, dict]:
    """Decoupled PPO (behaviour != proximal policy) for off-policy rollouts.
    The proximal anchor is interpolated from the version lag:
    alpha = (v_prox - v_behav) / (v_theta - v_behav)."""
    _check_dual_clip(clip_ratio_c)
    logprobs, old_logprobs, advantages = _f32(logprobs), _f32(old_logprobs), _f32(advantages)
    if loss_mask is None:
        loss_mask = torch.ones_like(logprobs, dtype=torch.bool)
    loss_mask_b = loss_mask.bool()
    mask_f = loss_mask.float()

    loss_mask_ratio = None
    if max_episode_steps is not None and loss_mask_sum is not None:
        loss_mask_ratio = loss_mask_sum.float() / max_episode_steps

    if proximal_logprobs is None:
        if versions is None or current_version is None:
            proximal_logprobs = old_logprobs.detach()
        else:
            v_behav = versions.float()
            v_theta = torch.as_tensor(current_version, dtype=torch.float32,
                                      device=logprobs.device)
            v_prox = v_theta - 1.0
            version_diff = v_theta - v_behav
            version_gap = v_prox - v_behav
            generated = versions >= 0
            alpha = torch.where((version_diff > 0) & generated,
                                version_gap / version_diff, 0.0)
            while alpha.ndim < logprobs.ndim:
                alpha = alpha[..., None]
            alpha = alpha.clamp(0.0, 1.0)
            proximal_logprobs = (old_logprobs + alpha * (logprobs - old_logprobs)).detach()
    proximal_logprobs = _f32(proximal_logprobs)

    count = mask_f.sum().clamp_min(1.0)
    proximal_ratio = torch.where(loss_mask_b, torch.exp(logprobs - proximal_logprobs), 0.0)
    clipped = proximal_ratio.clamp(1.0 - clip_ratio_low, 1.0 + clip_ratio_high)
    pg1 = -advantages * proximal_ratio
    pg2 = -advantages * clipped
    pg = torch.maximum(pg1, pg2)

    if clip_ratio_c is not None:
        pg3 = torch.sign(advantages) * clip_ratio_c * advantages
        dual_clip_mask = pg3.detach() < pg.detach()
        pg = torch.minimum(pg, pg3)
    else:
        dual_clip_mask = torch.zeros_like(pg, dtype=torch.bool)

    behav_weight = torch.exp(proximal_logprobs - old_logprobs)
    if behave_weight_threshold is not None:
        behav_mask = (behav_weight <= behave_weight_threshold) & loss_mask_b
    else:
        behav_mask = loss_mask_b
    behav_count = behav_mask.float().sum().clamp_min(1.0)

    loss = _agg(pg * behav_weight, behav_mask.float(), loss_mask_ratio, loss_agg_func)
    if critic_warmup:
        loss = torch.zeros_like(loss)

    clip_fraction = ((pg1.detach() < pg2.detach()) & loss_mask_b).sum() / count
    dual_clip_fraction = (dual_clip_mask & loss_mask_b).sum() / count
    proximal_approx_kl = -torch.where(loss_mask_b, logprobs - proximal_logprobs, 0.0).sum() / count
    behav_approx_kl = (
        -torch.where(behav_mask, proximal_logprobs - old_logprobs, 0.0).sum() / behav_count)

    metrics = {
        "actor/policy_loss": loss.detach(),
        "actor/proximal_ratio": masked_mean(proximal_ratio.detach(), mask_f),
        "actor/clipped_proximal_ratio": masked_mean(clipped.detach(), mask_f),
        "actor/clip_fraction": clip_fraction.float(),
        "actor/dual_clip_fraction": dual_clip_fraction.float(),
        "actor/behav_clip_fraction": 1.0 - behav_count / count,
        "actor/proximal_approx_kl": proximal_approx_kl.detach(),
        "actor/behav_approx_kl": behav_approx_kl.detach(),
    }
    return loss, metrics


def compute_ppo_critic_loss(
    values: torch.Tensor,
    returns: torch.Tensor,
    prev_values: torch.Tensor,
    value_clip: float,
    huber_delta: float,
    loss_mask: Optional[torch.Tensor] = None,
    max_episode_steps: Optional[int] = None,
    loss_mask_sum: Optional[torch.Tensor] = None,
    **kwargs,
) -> Tuple[torch.Tensor, dict]:
    """Clipped-value huber critic loss, with the clip ratio and the
    explained variance over the mask."""
    values, returns, prev_values = _f32(values), _f32(returns), _f32(prev_values)
    loss_mask_ratio = None
    if max_episode_steps is not None and loss_mask_sum is not None and loss_mask is not None:
        loss_mask_ratio = loss_mask_sum.float() / max_episode_steps
    if loss_mask is None:
        loss_mask = torch.ones_like(values, dtype=torch.bool)
    mask_f = loss_mask.float()

    clipped_values = prev_values + torch.clamp(values - prev_values, -value_clip, value_clip)
    vloss1 = huber_loss(returns - values, huber_delta)
    vloss2 = huber_loss(returns - clipped_values, huber_delta)
    vloss = torch.maximum(vloss1, vloss2)
    loss = _agg(vloss, mask_f, loss_mask_ratio, masked_mean)

    clip_indicator = (clipped_values - prev_values).abs() > value_clip
    clip_ratio = clip_indicator.float().mean()

    ret_mean = masked_mean(returns, mask_f)
    ret_var = masked_mean(torch.square(returns - ret_mean), mask_f)
    err_var = masked_mean(torch.square(returns - values), mask_f)
    explained_var = 1.0 - err_var / torch.clamp(ret_var, min=1e-8)

    metrics = {
        "critic/value_loss": loss.detach(),
        "critic/value_clip_ratio": clip_ratio.detach(),
        "critic/explained_variance": explained_var.detach(),
    }
    return loss, metrics


@register_policy_loss("actor")
def compute_grpo_actor_loss_fn(**kwargs):
    """GRPO uses the PPO-clip actor loss."""
    return compute_ppo_actor_loss(**kwargs)


@register_policy_loss("ppo_actor")
def _ppo_actor(**kwargs):
    return compute_ppo_actor_loss(**kwargs)


@register_policy_loss("decoupled_actor")
def _decoupled_actor(**kwargs):
    return compute_decoupled_ppo_actor_loss(**kwargs)


@register_policy_loss("actor_critic")
def compute_ppo_actor_critic_loss(**kwargs):
    actor_loss, am = compute_ppo_actor_loss(**kwargs)
    critic_loss, cm = compute_ppo_critic_loss(**kwargs)
    return actor_loss + critic_loss, {**am, **cm}


@register_policy_loss("decoupled_actor_critic")
def compute_decoupled_ppo_actor_critic_loss(**kwargs):
    actor_loss, am = compute_decoupled_ppo_actor_loss(**kwargs)
    critic_loss, cm = compute_ppo_critic_loss(**kwargs)
    return actor_loss + critic_loss, {**am, **cm}


@register_policy_loss("opd")
def compute_opd_actor_loss(
    logprobs: torch.Tensor,
    advantages: torch.Tensor,
    loss_mask: torch.Tensor,
    loss_mask_sum: Optional[torch.Tensor] = None,
    max_episode_steps: Optional[int] = None,
    loss_agg_func: Callable = masked_mean,
    **kwargs,
) -> Tuple[torch.Tensor, dict]:
    """OPD distillation: -logprob * detach(reverse-KL reward)."""
    logprobs, advantages = _f32(logprobs), _f32(advantages)
    if loss_mask.dim() == logprobs.dim() - 1:
        loss_mask = loss_mask[..., None]
    loss_mask = torch.broadcast_to(loss_mask, logprobs.shape)
    mask_f = loss_mask.float()

    loss_mask_ratio = None
    if max_episode_steps is not None and loss_mask_sum is not None:
        if loss_mask_sum.dim() == logprobs.dim() - 1:
            loss_mask_sum = loss_mask_sum[..., None]
        loss_mask_sum = torch.broadcast_to(loss_mask_sum, logprobs.shape)
        loss_mask_ratio = loss_mask_sum.float() / max_episode_steps

    opd_rewards = advantages.detach()
    loss = _agg(-logprobs * opd_rewards, mask_f, loss_mask_ratio, loss_agg_func)

    metrics = {
        "actor/policy_loss": loss.detach(),
        "actor/opd_reward": masked_mean(opd_rewards, mask_f),
        "actor/opd_reverse_kl": masked_mean(-opd_rewards, mask_f),
    }
    return loss, metrics
