"""NFT (negative-aware fine-tuning) learner for flow-matching policies.

Port of ``rlinf_tpu/training/nft_learner.py`` (reference analog:
rlinf/workers/actor/fsdp_nft_policy_worker.py), DiffusionNFT-style RL for
flow policies without logprobs:

  * Each update resamples a flow timestep t and a noisy interpolation point
    x_t between noise and the executed action x1, then evaluates the lagged
    rollout model's velocity v_old and the training model's v_theta at x_t.
  * delta_v = v_theta - v_old is norm-clipped (max_drift) and turned into
    positive/negative candidate velocities v+- = v_old +- beta clip(delta_v).
  * Each candidate predicts the clean action; weighted squared errors to the
    executed action give energies e+-; the loss pushes e+ down on
    positive-advantage samples and e- down on negatives: a DPO-style
    softplus on (e+ - e-) or a direct MSE mix.
  * The rollout model is soft-updated toward the training model with a
    (possibly annealed) rate tau.

The state carries (params, opt_state, rollout_params); v_old is the same
velocity function on the lagged tree. The optimizer and
``soft_update_rollout`` write in place. The step's draws (the step indices
and the noise) come from the generator passed to it, or are handed in as
``draws`` (the tests pass the JAX step's threefry draws). Timestep
convention: t=0 noise, t=1 clean.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from rlinf_tpu_torch.models.embodiment.base_policy import normal_noise, to_device
from rlinf_tpu_torch.models.embodiment.flow_policy import FlowMatchingPolicy
from rlinf_tpu_torch.training.learner import _grads, _to_device, optax_global_norm
from rlinf_tpu_torch.training.train_state import Optimizer, apply_updates, tree_map
from rlinf_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class NFTConfig:
    num_steps: int = 8            # flow discretization for timestep resampling
    beta: float = 1.0             # candidate scale (reference nft_beta)
    max_drift: float = 0.5        # delta_v norm clip (reference max_drift)
    loss_form: str = "dpo"        # "dpo" | "mse" (reference nft_loss_form)
    dpo_beta: float = 1.0
    weight_mode: str = "adaptive"  # "constant" | "adaptive" (reference auto/ODE)
    # scalar, or (pos_scale, neg_scale) like the reference's nft_weight_scale
    # list -- downweighting negatives stabilizes low-success-rate batches
    weight_scale: Tuple[float, ...] = (1.0,)
    adv_type: str = "raw"         # "raw": advantages already in [0,1]
    adv_clip_max: float = 1.0     # for non-raw: clip then rescale to [0,1]
    # tau: rollout-model soft-update rate. Scalar, or (start, end, s0, s1)
    # for linear annealing over training steps (reference _get_current_nft_tau).
    tau: Tuple[float, ...] = (1.0,)


class NFTTrainState(NamedTuple):
    step: int
    params: Dict
    opt_state: object
    rollout_params: Dict          # lagged model for v_old (tau<1 off-policy)


def nft_tau_at(cfg: NFTConfig, step: int) -> float:
    """Scalar tau or linear anneal (start, end, s0, s1) -- host-side."""
    if len(cfg.tau) == 1:
        return float(cfg.tau[0])
    start_tau, end_tau, s0, s1 = cfg.tau
    if step <= s0:
        return float(start_tau)
    if step >= s1:
        return float(end_tau)
    ratio = (step - s0) / float(s1 - s0)
    return float(start_tau + (end_tau - start_tau) * ratio)


def _postprocess_advantages(cfg: NFTConfig, adv: torch.Tensor) -> torch.Tensor:
    """Map advantages into [0,1] (reference _postprocess_advantages)."""
    if cfg.adv_type == "raw":
        return adv
    a = adv.clamp(-cfg.adv_clip_max, cfg.adv_clip_max)
    return (a + cfg.adv_clip_max) / (2.0 * cfg.adv_clip_max)


def make_nft_train_step(
    policy: FlowMatchingPolicy,
    cfg: NFTConfig,
    tx: Optimizer,
    device="cuda",
) -> Callable[..., Tuple[NFTTrainState, Dict]]:
    """``train_step(state, batch, generator, draws=None) -> (state,
    metrics)``. Batch: obs/<key> [B, obs], actions [B, A] (executed clean
    actions), advantages [B] (NFT reward/advantage), loss_mask [B].
    ``draws``: (step indices [B] in [0, num_steps), N(0, 1) noise [B, A])
    in place of ``generator``'s. The rollout (v_old) model in the state is
    NOT updated here: call ``soft_update_rollout`` once per training round
    with ``nft_tau_at(cfg, round)``."""
    dev = resolve_device(device)

    def loss_fn(params, rollout_params, batch, step_idx, eps):
        obs = {k[len("obs/"):]: v for k, v in batch.items() if k.startswith("obs/")}
        x1 = batch["actions"].float()
        adv = _postprocess_advantages(cfg, batch["advantages"].float())
        mask = batch["loss_mask"].float()

        t = step_idx.float() / cfg.num_steps   # in [0, 1)
        x_t = (1.0 - t[:, None]) * eps + t[:, None] * x1

        # old velocity under the lagged rollout model (recompute_v path)
        v_old = policy.velocity(rollout_params, x_t, t, obs).detach()
        v_theta = policy.velocity(params, x_t, t, obs)

        # norm-clipped drift and pos/neg candidates; the smoothed norm's
        # grad is 0 (not NaN) at delta_v == 0 (the state after a tau=1 sync)
        delta_v = v_theta - v_old
        delta_norm = torch.sqrt(delta_v.square().sum(dim=-1, keepdim=True) + 1e-12)
        clip_coef = torch.clamp(cfg.max_drift / delta_norm, max=1.0)
        dv = delta_v * clip_coef
        v_pos = v_old + cfg.beta * dv
        v_neg = v_old - cfg.beta * dv

        # clean-action prediction from each candidate: x1 = x_t + v (1 - t)
        rem = (1.0 - t)[:, None]
        pred_pos = x_t + v_pos * rem
        pred_neg = x_t + v_neg * rem

        def energy(pred, scale):
            err = (pred - x1).square()
            if cfg.weight_mode == "adaptive":
                # DiffusionNFT adaptive weight: 1 / mean-abs-error (stop-grad)
                w = (pred - x1).abs().mean(dim=-1, keepdim=True).clamp_min(1e-4).detach()
                err = err / w
            return scale * err.sum(dim=-1)

        e_pos = energy(pred_pos, float(cfg.weight_scale[0]))
        e_neg = energy(pred_neg, float(cfg.weight_scale[-1]))
        delta_e = e_pos - e_neg

        denom = mask.sum().clamp_min(1.0)
        if cfg.loss_form == "dpo":
            logit = (cfg.dpo_beta / 2.0) * (adv * 2.0 - 1.0) * delta_e
            loss = (F.softplus(logit) * mask).sum() / denom
        elif cfg.loss_form == "mse":
            loss = ((adv * e_pos + (1.0 - adv) * e_neg) * mask).sum() / denom
        else:
            raise ValueError(f"Unsupported nft loss_form: {cfg.loss_form}")

        pos_mask = mask * (adv > 0.5)
        neg_mask = mask * (adv < 0.5)
        metrics = {
            "nft/loss": loss,
            "nft/delta_v_norm": delta_norm[..., 0].mean(),
            "nft/clip_frac": (clip_coef < 1.0).float().mean(),
            "nft/e_pos_mean": (e_pos * mask).sum() / denom,
            "nft/e_neg_mean": (e_neg * mask).sum() / denom,
            "nft/e_pos_mean_pos_only": (e_pos * pos_mask).sum() / pos_mask.sum().clamp_min(1.0),
            "nft/e_neg_mean_neg_only": (e_neg * neg_mask).sum() / neg_mask.sum().clamp_min(1.0),
            "nft/delta_e_mean": (delta_e * mask).sum() / denom,
        }
        return loss, metrics

    def train_step(state: NFTTrainState, batch, generator: Optional[torch.Generator],
                   draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        batch = _to_device(batch, dev)
        B = batch["actions"].shape[0]
        if draws is None:
            draws = (to_device(torch.randint(0, cfg.num_steps, (B,), generator=generator), dev),
                     normal_noise(generator, batch["actions"].shape, dev))
        step_idx, eps = (torch.as_tensor(d, device=dev) for d in draws)
        grads, _, metrics = _grads(
            state.params,
            lambda p: loss_fn(p, state.rollout_params, batch, step_idx, eps.float()))
        grad_norm = optax_global_norm(grads)
        updates, new_opt = tx.update(grads, state.opt_state, state.params)
        del grads
        apply_updates(state.params, updates)
        metrics = dict(metrics)
        metrics["nft/grad_norm"] = grad_norm
        return NFTTrainState(state.step + 1, state.params, new_opt, state.rollout_params), metrics

    return train_step


def soft_update_rollout(state: NFTTrainState, tau) -> NFTTrainState:
    """Move the rollout (v_old) model toward params at rate tau, in place:
    call ONCE per training round, before the gradient-step epoch (reference
    soft_update_rollout_model + the v_old precompute). Syncing every
    gradient step would keep delta_v == 0 at evaluation, so the DPO logit
    never saturates and negative samples push the velocity field without
    bound."""
    with torch.no_grad():
        tree_map(lambda p, r: r.copy_(tau * p + (1.0 - tau) * r),
                 state.params, state.rollout_params)
    return state


def init_nft_state(
    policy: FlowMatchingPolicy,
    generator: torch.Generator,
    tx: Optimizer,
    device="cuda",
) -> NFTTrainState:
    params = policy.init(generator, device=resolve_device(device))
    return NFTTrainState(
        step=0,
        params=params,
        opt_state=tx.init(params),
        rollout_params=tree_map(torch.clone, params),
    )
