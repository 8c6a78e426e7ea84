"""Squashed-Gaussian SAC policy with twin Q heads.

Port of ``rlinf_tpu/models/embodiment/sac_policy.py`` (reference analog:
the SAC path of rlinf/models/embodiment, sac_forward / sac_q_forward hooks,
base_policy.py:57-63, driven by rlinf/workers/actor/fsdp_sac_policy_worker.py):
a tanh-squashed Gaussian actor with the log-prob correction, twin Q(s, a)
critics, and target-critic subtrees for Polyak averaging.

The sampling noise is drawn from a CPU ``torch.Generator`` (``normal_noise``)
or handed in as ``noise`` (the tests pass the JAX package's threefry
draws), apart from the arithmetic that uses it.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from rlinf_tpu_torch.models.embodiment.base_policy import Policy, PolicyOutput, normal_noise
from rlinf_tpu_torch.models.embodiment.mlp_policy import _mlp_apply, _mlp_init
from rlinf_tpu_torch.utils.device import resolve_device

_LOG_2PI = math.log(2.0 * math.pi)
LOGSTD_MIN, LOGSTD_MAX = -5.0, 2.0


def _squashed_logprob(pre, mean, logstd):
    """Per-dim logprob of tanh(pre) for pre ~ N(mean, exp(logstd)), with
    log(1 - tanh^2(pre)) computed stably as 2 (log 2 - pre - softplus(-2 pre))."""
    z = (pre - mean) / torch.exp(logstd)
    logprob = -0.5 * z.square() - logstd - 0.5 * _LOG_2PI
    return logprob - 2.0 * (math.log(2.0) - pre - F.softplus(-2.0 * pre))


class MLPSACPolicy(Policy):
    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        hidden_sizes: Sequence[int] = (256, 256),
        obs_key: str = "states",
    ):
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self.hidden_sizes = tuple(hidden_sizes)
        self.obs_key = obs_key

    def init(self, generator: torch.Generator, device="cuda"):
        device = resolve_device(device)
        actor_sizes = (self.obs_dim, *self.hidden_sizes, 2 * self.action_dim)
        q_sizes = (self.obs_dim + self.action_dim, *self.hidden_sizes, 1)
        actor = _mlp_init(generator, actor_sizes, scale_last=0.01, device=device)
        q1 = _mlp_init(generator, q_sizes, scale_last=1.0, device=device)
        q2 = _mlp_init(generator, q_sizes, scale_last=1.0, device=device)
        clone = lambda q: [{k: v.clone() for k, v in layer.items()} for layer in q]
        return {
            "actor": actor,
            "q1": q1,
            "q2": q2,
            # targets start as copies (Polyak-averaged thereafter)
            "q1_target": clone(q1),
            "q2_target": clone(q2),
            "log_alpha": torch.zeros((), dtype=torch.float32, device=device),
        }

    # ------------------------------------------------------------------
    def _dist(self, params, obs):
        x = obs[self.obs_key].float()
        out = _mlp_apply(params["actor"], x, activation=torch.relu)
        mean, logstd = out.chunk(2, dim=-1)
        return mean, logstd.clamp(LOGSTD_MIN, LOGSTD_MAX)

    def sample_action(self, params, generator, obs, *, deterministic: bool = False,
                      noise: Optional[torch.Tensor] = None):
        """-> (tanh-squashed action in [-1, 1], per-dim corrected logprob).
        The N(0, 1) noise comes from ``generator`` unless ``noise`` is given."""
        mean, logstd = self._dist(params, obs)
        if deterministic:
            pre = mean
        else:
            if noise is None:
                noise = normal_noise(generator, mean.shape, mean.device)
            pre = mean + torch.exp(logstd) * noise
        return torch.tanh(pre), _squashed_logprob(pre, mean, logstd)

    def q_values(self, params, obs, actions, *, target: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = torch.cat([obs[self.obs_key].float(), actions.float()], dim=-1)
        k1 = "q1_target" if target else "q1"
        k2 = "q2_target" if target else "q2"
        q1 = _mlp_apply(params[k1], x, activation=torch.relu)[..., 0]
        q2 = _mlp_apply(params[k2], x, activation=torch.relu)[..., 0]
        return q1, q2

    # Policy interface ---------------------------------------------------
    def default_forward(self, params, obs, actions) -> Dict[str, torch.Tensor]:
        """Logprob of given squashed actions (tanh inverted on actions
        clipped to +-(1 - 1e-6)) and the pre-squash Gaussian's entropy."""
        mean, logstd = self._dist(params, obs)
        a = actions.float().clamp(-1 + 1e-6, 1 - 1e-6)
        return {"logprobs": _squashed_logprob(torch.atanh(a), mean, logstd),
                "entropy": logstd + 0.5 * (_LOG_2PI + 1.0)}

    def predict_action_batch(
        self, params, generator, obs, *, deterministic: bool = False
    ) -> PolicyOutput:
        action, logprob = self.sample_action(params, generator, obs,
                                             deterministic=deterministic)
        return PolicyOutput(actions=action, logprobs=logprob, values=None)
