"""PPO actor-critic update for embodied policies.

Port of ``rlinf_tpu/training/embodied_learner.py`` (reference analog:
EmbodiedFSDPActor.run_training / train_micro_batch,
rlinf/workers/actor/fsdp_actor_worker.py:1492,1599, driving
compute_ppo_actor_critic_loss, losses.py:383). Loss semantics match:
per-action-dim logprobs with clip on the per-dim ratio, huber value clip,
entropy bonus, and the optional SFT (behaviour-cloning) mixing term on demo
rows passed in the same batch. The step differentiates the policy's
``default_forward`` with ``torch.autograd``, then applies the port's optax
arithmetic (``training/train_state.py``); params and optimizer state are
updated in place, where the JAX package donated them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from rlinf_tpu_torch.algorithms.losses import (
    compute_ppo_actor_loss,
    compute_ppo_critic_loss,
)
from rlinf_tpu_torch.models.embodiment.base_policy import Policy
from rlinf_tpu_torch.training.learner import _grads, _to_device, optax_global_norm
from rlinf_tpu_torch.training.train_state import Optimizer, TrainState, apply_updates
from rlinf_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class EmbodiedLossConfig:
    """Mirrors the reference embodied actor YAML block
    (examples/embodiment/config/*: clip ratios, value_clip, huber_delta,
    entropy_bonus)."""

    clip_ratio_low: float = 0.2
    clip_ratio_high: float = 0.2
    clip_ratio_c: Optional[float] = None
    value_clip: float = 0.2
    huber_delta: float = 10.0
    entropy_bonus: float = 0.0
    value_coef: float = 1.0
    #: weight of the optional SFT (behavior-cloning) mixing term computed on
    #: demo batches passed alongside the RL batch (reference
    #: fsdp_actor_worker.py:1416 SFT mixing)
    sft_coef: float = 0.0


def _prefixed(batch: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in batch.items() if k.startswith(prefix)}


def make_embodied_train_step(
    policy: Policy,
    loss_cfg: EmbodiedLossConfig,
    tx: Optimizer,
    device="cuda",
) -> Callable[[TrainState, Dict[str, Any]], Tuple[TrainState, Dict]]:
    """Batch dict (flattened [N, ...], numpy arrays or tensors):
      obs/<key>, actions [N, A], old_logprobs [N, A], advantages [N],
      returns [N], prev_values [N]; with ``sft_coef > 0`` optionally
      sft_obs/<key> and sft_actions.
    The step updates the params and the optimizer state of ``state`` in
    place; the returned state holds the same tensors.
    """
    dev = resolve_device(device)

    def loss_fn(params, batch):
        fwd = policy.default_forward(params, _prefixed(batch, "obs/"), batch["actions"])
        logprobs = fwd["logprobs"]                       # [N, A]
        adv = batch["advantages"][:, None]               # broadcast over dims

        actor_loss, am = compute_ppo_actor_loss(
            logprobs=logprobs,
            old_logprobs=batch["old_logprobs"],
            advantages=adv.expand(logprobs.shape),
            clip_ratio_low=loss_cfg.clip_ratio_low,
            clip_ratio_high=loss_cfg.clip_ratio_high,
            clip_ratio_c=loss_cfg.clip_ratio_c,
        )
        critic_loss, cm = compute_ppo_critic_loss(
            values=fwd["values"],
            returns=batch["returns"],
            prev_values=batch["prev_values"],
            value_clip=loss_cfg.value_clip,
            huber_delta=loss_cfg.huber_delta,
        )
        entropy = fwd["entropy"].mean()
        loss = (
            actor_loss
            + loss_cfg.value_coef * critic_loss
            - loss_cfg.entropy_bonus * entropy
        )
        metrics = {**am, **cm, "actor/entropy": entropy}
        sft_obs = _prefixed(batch, "sft_obs/")
        if loss_cfg.sft_coef > 0 and sft_obs:
            sft_fwd = policy.default_forward(params, sft_obs, batch["sft_actions"])
            sft_nll = -sft_fwd["logprobs"].sum(dim=-1).mean()
            loss = loss + loss_cfg.sft_coef * sft_nll
            metrics["actor/sft_nll"] = sft_nll.detach()
        return loss, metrics

    def train_step(state: TrainState, batch):
        batch = _to_device(batch, dev)
        grads, loss, metrics = _grads(state.params, lambda p: loss_fn(p, batch))
        grad_norm = optax_global_norm(grads)
        updates, new_opt = tx.update(grads, state.opt_state, state.params)
        del grads
        apply_updates(state.params, updates)
        metrics = dict(metrics)
        metrics["actor/loss"] = loss
        metrics["actor/grad_norm"] = grad_norm
        return TrainState(state.step + 1, state.params, new_opt), metrics

    return train_step
