"""Policy interface for embodied RL.

Port of ``rlinf_tpu/models/embodiment/base_policy.py`` (reference analog:
BasePolicy, rlinf/models/embodiment/base_policy.py:32): ``default_forward``
(logprob/value/entropy for training) and ``predict_action_batch`` (action
sampling for rollout). Policies are stateless: params are explicit trees of
tensors, so one object serves the learner and the rollout with different
param versions. Sampling draws from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch


class PolicyOutput(NamedTuple):
    """predict_action_batch result (reference mlp_policy.py:296-320)."""

    actions: torch.Tensor            # [B, action_dim] (env-facing)
    logprobs: torch.Tensor           # [B, action_dim] per-dim logprob
    values: Optional[torch.Tensor]   # [B] or None


class Policy:
    """Subclass contract; all methods pure functions of (params, ...)."""

    action_dim: int

    def init(self, generator: torch.Generator, device="cuda") -> Any:
        raise NotImplementedError

    def default_forward(
        self, params, obs: Dict[str, torch.Tensor], actions: torch.Tensor
    ) -> Dict[str, torch.Tensor]:
        """-> {"logprobs": [B, A], "entropy": [B, A], "values": [B]}"""
        raise NotImplementedError

    def predict_action_batch(
        self, params, generator: torch.Generator, obs: Dict[str, torch.Tensor], *,
        deterministic: bool = False,
    ) -> PolicyOutput:
        raise NotImplementedError

    def value(self, params, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def env_actions(self, policy_actions: torch.Tensor) -> torch.Tensor:
        """Map the policy's WIRE actions (what the learner trains on) to the
        env-facing actions. Identity by default; flow-SDE policies override
        to extract x1 from the denoising chain, discrete-bin policies to
        decode bin centers."""
        return policy_actions

    def partition_rules(self):
        """Embodied policies are small: replicate by default."""
        from rlinf_tpu_torch.parallel.sharding import P

        return [(r".*", P())]
