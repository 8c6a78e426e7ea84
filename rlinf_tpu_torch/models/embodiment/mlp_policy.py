"""Gaussian MLP actor-critic (reference: rlinf/models/embodiment/mlp_policy/
mlp_policy.py: MLP backbone, mean head, state-independent logstd, value head).

Port of ``rlinf_tpu/models/embodiment/mlp_policy.py``, with its distribution
semantics: per-dimension Normal logprob/entropy (not summed: the PPO loss
masks/aggregates over the action dim), tanh-free actions clipped by the
env. Inits draw from an explicit CPU ``torch.Generator`` and move to the
device, so a seed gives the same weights on any device.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

from rlinf_tpu_torch.models.embodiment.base_policy import Policy, PolicyOutput, normal_noise
from rlinf_tpu_torch.utils.device import resolve_device

_LOG_2PI = math.log(2.0 * math.pi)


def _mlp_init(generator: torch.Generator, sizes: Sequence[int],
              scale_last: Optional[float] = 0.01, device="cuda"):
    """Uniform fan-in init; final layer optionally down-scaled (policy heads
    start near-deterministic-zero, the standard PPO init). -> a list of
    {"w": [fan_in, fan_out], "b": [fan_out]} f32 layers."""
    device = resolve_device(device)
    params = []
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        scale = 1.0 / math.sqrt(fan_in)
        if i == len(sizes) - 2 and scale_last is not None:
            scale = scale * scale_last
        w = torch.empty((fan_in, fan_out), device=generator.device).uniform_(
            -1.0, 1.0, generator=generator) * scale
        params.append({"w": w.to(device), "b": torch.zeros((fan_out,), device=device)})
    return params


def _mlp_apply(layers, x, activation=torch.tanh, final_activation=None):
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i < len(layers) - 1:
            x = activation(x)
        elif final_activation is not None:
            x = final_activation(x)
    return x


def gaussian_logprob(mean, logstd, actions):
    """Per-dimension Normal logprob, fp32."""
    std = torch.exp(logstd)
    z = (actions - mean) / std
    return -0.5 * z.square() - logstd - 0.5 * _LOG_2PI


def gaussian_entropy(logstd):
    return logstd + 0.5 * (_LOG_2PI + 1.0)


class MLPGaussianPolicy(Policy):
    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        hidden_sizes: Sequence[int] = (64, 64),
        obs_key: str = "states",
        init_logstd: float = 0.0,
        with_value_head: bool = True,
    ):
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self.hidden_sizes = tuple(hidden_sizes)
        self.obs_key = obs_key
        self.init_logstd = init_logstd
        self.with_value_head = with_value_head

    def init(self, generator: torch.Generator, device="cuda"):
        device = resolve_device(device)
        sizes = (self.obs_dim, *self.hidden_sizes)
        params = {
            "backbone": _mlp_init(generator, sizes, scale_last=None, device=device),
            "actor_mean": _mlp_init(generator, (self.hidden_sizes[-1], self.action_dim),
                                    scale_last=0.01, device=device),
            "actor_logstd": torch.full((self.action_dim,), float(self.init_logstd),
                                       device=device),
        }
        if self.with_value_head:
            params["value"] = _mlp_init(generator, (self.obs_dim, *self.hidden_sizes, 1),
                                        scale_last=1.0, device=device)
        return params

    # ------------------------------------------------------------------
    def _dist(self, params, obs):
        x = obs[self.obs_key].float()
        feat = _mlp_apply(params["backbone"], x)
        mean = _mlp_apply(params["actor_mean"], feat)
        logstd = params["actor_logstd"].expand(mean.shape)
        return mean, logstd

    def value(self, params, obs):
        x = obs[self.obs_key].float()
        return _mlp_apply(params["value"], x)[..., 0]

    def default_forward(self, params, obs, actions) -> Dict[str, torch.Tensor]:
        mean, logstd = self._dist(params, obs)
        out = {
            "logprobs": gaussian_logprob(mean, logstd, actions.float()),
            "entropy": gaussian_entropy(logstd),
        }
        if self.with_value_head:
            out["values"] = self.value(params, obs)
        return out

    def predict_action_batch(
        self, params, generator, obs, *, deterministic: bool = False
    ) -> PolicyOutput:
        """Actions from the Gaussian, the noise drawn from ``generator`` (a
        CPU generator: the draw does not depend on the device)."""
        mean, logstd = self._dist(params, obs)
        if deterministic:
            actions = mean
        else:
            actions = mean + torch.exp(logstd) * normal_noise(generator, mean.shape,
                                                              mean.device)
        logprobs = gaussian_logprob(mean, logstd, actions)
        values = self.value(params, obs) if self.with_value_head else None
        return PolicyOutput(actions=actions, logprobs=logprobs, values=values)
