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

    def params_from_numpy(self, tree, device="cuda"):
        """The JAX package's params of this policy (a tree of dicts and
        lists of numpy arrays) -> the port's tree of tensors on ``device``,
        keys and layouts unchanged, so one init feeds both packages."""
        return tree_from_numpy(tree, device)

    def partition_rules(self):
        """Embodied policies are small: replicate by default."""
        from rlinf_tpu_torch.parallel.sharding import P

        return [(r".*", P())]


def tree_from_numpy(tree, device="cuda"):
    """Dicts and lists of numpy arrays -> the same nesting of tensors on
    ``device``, each with its own copy."""
    from rlinf_tpu_torch.models.llm.convert import tensor_from_numpy

    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_from_numpy(v, device) for v in tree]
    return tensor_from_numpy(tree, device)


def to_device(x, device) -> torch.Tensor:
    """A host array or CPU tensor on ``device``. To the card the copy goes
    from pinned memory and does not wait for the work already queued there,
    so that a rollout stage's inputs do not stall behind another stage's
    policy (``rollout/env_loop.py``)."""
    t = torch.as_tensor(x)
    device = torch.device(device)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def normal_noise(generator: torch.Generator, shape, device) -> torch.Tensor:
    """N(0, 1) f32 noise of ``shape`` drawn from the CPU ``generator`` (the
    draw does not depend on the device), sent to ``device`` by ``to_device``."""
    return to_device(torch.randn(tuple(shape), generator=generator), device)
