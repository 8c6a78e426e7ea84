"""Flow-matching action policy with flow-SDE sampling for RL.

Port of ``rlinf_tpu/models/embodiment/flow_policy.py`` (reference analog:
the openpi pi0/pi0.5 flow-matching policies and the flow-SDE RL recipe,
rlinf/models/embodiment/openpi + starvla/action_heads/flowmatching.py;
published as piRL, pi_rl.rst:41-89):

  * Imitation/SFT: conditional flow matching -- regress the velocity field
    v(x_t, t | obs) toward (x1 - x0) on linear interpolation paths.
  * RL: sample actions by integrating the learned ODE as an SDE; each
    denoising step is a Gaussian "action" in a denoising MDP, so the chain
    has exact per-step logprobs that PPO can importance-weight.

The velocity network is an MLP over [x_t, t-embedding, obs]. Sampling,
the recompute and the loss are ``flow_utils``'s over [B, A] actions, the
same arithmetic as the JAX policy's own copies of them; the draws come
from a CPU ``torch.Generator`` or are handed in.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import torch

from rlinf_tpu_torch.models.embodiment import flow_utils as fu
from rlinf_tpu_torch.models.embodiment.base_policy import Policy, PolicyOutput
from rlinf_tpu_torch.models.embodiment.mlp_policy import _mlp_apply, _mlp_init
from rlinf_tpu_torch.utils.device import resolve_device


class FlowChain(NamedTuple):
    """The denoising MDP record for RL."""

    actions: torch.Tensor        # [B, A] final action x1
    chain: torch.Tensor          # [B, steps+1, A] x_0..x_1
    logprobs: torch.Tensor       # [B, steps] per-step Gaussian logprob (summed dims)


class FlowMatchingPolicy(Policy):
    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        hidden_sizes: Sequence[int] = (128, 128),
        time_embed_dim: int = 32,
        num_flow_steps: int = 8,
        sde_noise_scale: float = 0.5,
        obs_key: str = "states",
    ):
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self.hidden_sizes = tuple(hidden_sizes)
        self.time_embed_dim = time_embed_dim
        self.num_flow_steps = num_flow_steps
        self.sde_noise_scale = sde_noise_scale
        self.obs_key = obs_key

    def init(self, generator: torch.Generator, device="cuda") -> Dict:
        device = resolve_device(device)
        in_dim = self.action_dim + self.time_embed_dim + self.obs_dim
        return {
            "velocity": _mlp_init(generator, (in_dim, *self.hidden_sizes, self.action_dim),
                                  scale_last=0.01, device=device),
            "value": _mlp_init(generator, (self.obs_dim, *self.hidden_sizes, 1),
                               scale_last=1.0, device=device),
        }

    # ------------------------------------------------------------------
    def velocity(self, params, x_t, t, obs) -> torch.Tensor:
        """v(x_t, t | obs); x_t [B, A], t [B] in [0,1]."""
        inp = torch.cat([x_t.float(), fu.time_embed(t.float(), self.time_embed_dim),
                         obs[self.obs_key].float()], dim=-1)
        return _mlp_apply(params["velocity"], inp, activation=torch.relu)

    def value(self, params, obs):
        return _mlp_apply(params["value"], obs[self.obs_key].float())[..., 0]

    def _fn(self, params, obs):
        return lambda x, t: self.velocity(params, x, t, obs)

    def _shape(self, obs):
        return (obs[self.obs_key].shape[0], self.action_dim)

    # -- imitation -------------------------------------------------------
    def flow_matching_loss(self, params, generator, obs, target_actions, *,
                           x0=None, t=None) -> torch.Tensor:
        """Conditional flow matching: E_t ||v(x_t,t) - (x1 - x0)||^2."""
        return fu.flow_matching_loss(self._fn(params, obs), generator, target_actions,
                                     x0=x0, t=t)

    # -- sampling --------------------------------------------------------
    def sample_ode(self, params, generator, obs, *, steps: Optional[int] = None,
                   x0=None):
        """Deterministic Euler ODE integration (eval-mode action)."""
        return fu.sample_ode(self._fn(params, obs), generator, self._shape(obs),
                             steps=steps or self.num_flow_steps, x0=x0,
                             device=obs[self.obs_key].device)

    def sample_sde(self, params, generator, obs, *, steps: Optional[int] = None,
                   x0=None, eps=None) -> FlowChain:
        """Flow-SDE: x_{k+1} = x_k + dt*v + sigma*sqrt(dt)*eps, each step a
        Gaussian with exact logprob (piRL denoising-MDP construction)."""
        out = fu.sample_sde(self._fn(params, obs), generator, self._shape(obs),
                            steps=steps or self.num_flow_steps,
                            noise_scale=self.sde_noise_scale, x0=x0, eps=eps,
                            device=obs[self.obs_key].device)
        return FlowChain(*out)

    def chain_logprobs(self, params, obs, chain: torch.Tensor) -> torch.Tensor:
        """Per-step logprobs of a stored chain [B, steps+1, A] under CURRENT
        params (the PPO 'new logprob' pass)."""
        return fu.chain_logprobs(self._fn(params, obs), chain,
                                 noise_scale=self.sde_noise_scale)

    # Policy interface ---------------------------------------------------
    def default_forward(self, params, obs, actions) -> Dict[str, torch.Tensor]:
        """actions here is the stored CHAIN flattened [B, (S+1)*A] -- RL over
        the denoising MDP needs the full chain, not just x1."""
        B = actions.shape[0]
        chain = actions.float().reshape(B, -1, self.action_dim)
        lp = self.chain_logprobs(params, obs, chain)
        return {
            "logprobs": lp,
            "entropy": fu.chain_entropy_like(lp, self.action_dim, chain.shape[1] - 1,
                                             self.sde_noise_scale),
            "values": self.value(params, obs),
        }

    def predict_action_batch(
        self, params, generator, obs, *, deterministic: bool = False
    ) -> PolicyOutput:
        values = self.value(params, obs)
        if deterministic:
            actions = self.sample_ode(params, generator, obs)
            return PolicyOutput(actions=actions,
                                logprobs=torch.zeros((actions.shape[0], 1),
                                                     device=actions.device),
                                values=values)
        out = self.sample_sde(params, generator, obs)
        B = out.actions.shape[0]
        # env consumes x1; the chain rides along flattened for training
        return PolicyOutput(actions=out.chain.reshape(B, -1), logprobs=out.logprobs,
                            values=values)

    def env_actions(self, policy_actions: torch.Tensor) -> torch.Tensor:
        """Extract x1 (the env-facing action) from the flattened chain."""
        B = policy_actions.shape[0]
        return policy_actions.reshape(B, -1, self.action_dim)[:, -1, :]
