"""SAC update: twin-Q critics, the squashed-Gaussian actor and the learned
temperature, in one step.

Port of ``rlinf_tpu/training/sac_learner.py`` (reference analog:
rlinf/workers/actor/fsdp_sac_policy_worker.py): the critics' TD loss
against Polyak targets, the actor's loss through min-Q with the critics
frozen, an optional learned ``log_alpha`` against a target entropy, one
gradient over the sum of the three losses. Each ``stop_gradient`` of the
JAX step is a ``.detach()`` at the same place. The optimizer updates the
live params in place (the targets take no update of their own); then the
targets move toward the new critics at rate ``tau``, in place.

The step's two draws (the next-state action and the new action) come from
the generator passed to it, or are handed in as ``noise`` (the tests pass
the JAX step's threefry draws), apart from the arithmetic.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from rlinf_tpu_torch.models.embodiment.base_policy import normal_noise
from rlinf_tpu_torch.models.embodiment.sac_policy import MLPSACPolicy
from rlinf_tpu_torch.training.learner import _grads, _to_device, optax_global_norm
from rlinf_tpu_torch.training.train_state import (
    Optimizer,
    TrainState,
    apply_updates,
    tree_map,
)
from rlinf_tpu_torch.utils.device import resolve_device

TARGETS = ("q1_target", "q2_target")


@dataclasses.dataclass(frozen=True)
class SACConfig:
    gamma: float = 0.99
    tau: float = 0.005                  # polyak rate
    learn_alpha: bool = True
    init_alpha: float = 0.2
    target_entropy: float = 0.0         # 0 => -action_dim


def _prefixed(batch, prefix):
    return {k[len(prefix):]: v for k, v in batch.items() if k.startswith(prefix)}


def make_sac_train_step(
    policy: MLPSACPolicy,
    cfg: SACConfig,
    tx: Optimizer,
    device="cuda",
) -> Callable[..., Tuple[TrainState, Dict]]:
    """``train_step(state, batch, generator, noise=None) -> (state,
    metrics)``. Batch: obs/<key> [N, obs], actions [N, A] (squashed),
    rewards [N], next_obs/<key> [N, obs], dones [N]. ``noise``: the two
    [N, A] N(0, 1) draws (next action, new action) in place of
    ``generator``'s. The state's params and optimizer state are updated in
    place."""
    dev = resolve_device(device)
    target_entropy = (
        cfg.target_entropy if cfg.target_entropy != 0.0 else -float(policy.action_dim)
    )

    def loss_fn(params, batch, eps_next, eps_new):
        obs, next_obs = _prefixed(batch, "obs/"), _prefixed(batch, "next_obs/")
        alpha = params["log_alpha"].exp() if cfg.learn_alpha else cfg.init_alpha
        alpha_sg = alpha.detach() if cfg.learn_alpha else alpha

        # --- critic loss -------------------------------------------------
        next_a, next_lp = policy.sample_action(params, None, next_obs, noise=eps_next)
        next_lp_sum = next_lp.sum(dim=-1)
        tq1, tq2 = policy.q_values(params, next_obs, next_a, target=True)
        target_v = torch.minimum(tq1, tq2) - alpha_sg * next_lp_sum
        target_q = (batch["rewards"] + cfg.gamma * (1.0 - batch["dones"]) * target_v).detach()
        q1, q2 = policy.q_values(params, obs, batch["actions"])
        critic_loss = (q1 - target_q).square().mean() + (q2 - target_q).square().mean()

        # --- actor loss (the critics frozen) -----------------------------
        new_a, new_lp = policy.sample_action(params, None, obs, noise=eps_new)
        new_lp_sum = new_lp.sum(dim=-1)
        frozen = {k: tree_map(torch.Tensor.detach, params[k]) for k in ("q1", "q2")}
        aq1, aq2 = policy.q_values({**params, **frozen}, obs, new_a)
        actor_loss = (alpha_sg * new_lp_sum - torch.minimum(aq1, aq2)).mean()

        # --- temperature -------------------------------------------------
        if cfg.learn_alpha:
            alpha_loss = -(params["log_alpha"] * (new_lp_sum + target_entropy).detach()).mean()
        else:
            alpha_loss = torch.zeros((), device=q1.device)

        loss = critic_loss + actor_loss + alpha_loss
        metrics = {
            "sac/critic_loss": critic_loss,
            "sac/actor_loss": actor_loss,
            "sac/alpha_loss": alpha_loss,
            "sac/alpha": torch.as_tensor(alpha_sg, dtype=torch.float32, device=q1.device),
            "sac/q1_mean": q1.mean(),
            "sac/entropy": -new_lp_sum.mean(),
        }
        return loss, metrics

    def train_step(state: TrainState, batch, generator: Optional[torch.Generator],
                   noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        batch = _to_device(batch, dev)
        shape = (batch["actions"].shape[0], policy.action_dim)
        if noise is None:
            noise = tuple(normal_noise(generator, shape, dev) for _ in range(2))
        eps_next, eps_new = (torch.as_tensor(n, dtype=torch.float32, device=dev) for n in noise)
        grads, loss, metrics = _grads(state.params,
                                      lambda p: loss_fn(p, batch, eps_next, eps_new))
        grad_norm = optax_global_norm(grads)
        updates, new_opt = tx.update(grads, state.opt_state, state.params)
        del grads
        # the targets take the Polyak average of their old values only
        live = [k for k in state.params if k not in TARGETS]
        apply_updates({k: state.params[k] for k in live}, {k: updates[k] for k in live})
        with torch.no_grad():
            for name in ("q1", "q2"):
                tree_map(lambda t, o: t.copy_((1.0 - cfg.tau) * t + cfg.tau * o),
                         state.params[f"{name}_target"], state.params[name])
        metrics = dict(metrics)
        metrics["sac/loss"] = loss
        metrics["sac/grad_norm"] = grad_norm
        return TrainState(state.step + 1, state.params, new_opt), metrics

    return train_step
