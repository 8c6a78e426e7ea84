"""Env <-> policy interaction loop with stage pipelining.

Port of ``rlinf_tpu/rollout/env_loop.py`` (reference analog: the
EnvWorker.interact + MultiStepRollout ping-pong,
rlinf/workers/env/env_worker.py:1013-1143): env sends obs, the policy
computes actions, env steps. Both sides live in one process: the card
computes actions for stage s+1 while the host steps stage s's simulators.

The JAX package gets that overlap from async dispatch. On one CUDA stream
a blocking read of stage 0's actions would wait for stage 1's queued policy
too, so here every stage's inputs go to the card from pinned memory
without waiting (``base_policy.to_device``), each stage's actions,
logprobs and values are copied back into pinned host buffers right after
its policy call, without waiting, and an event recorded behind those
copies is the only thing the host waits on before stepping that stage's
envs. A policy that reads anything back to the host inside its step
(``.item()``, boolean indexing, a tensor slot index) defeats it; the
port's policies do not. On the CPU the loop runs the same steps in turn.

Sampling draws from one CPU ``torch.Generator`` passed to ``interact``
(the JAX package splits a threefry key per stage and step).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from rlinf_tpu_torch.data.embodied_io_struct import Trajectory, TrajectoryBuffer
from rlinf_tpu_torch.envs.base import VectorEnv
from rlinf_tpu_torch.models.embodiment.base_policy import Policy, to_device
from rlinf_tpu_torch.utils.device import resolve_device


class _HostCopy:
    """Tensors on their way to the host: on the card, copies into pinned
    buffers queued behind the work that makes them, and an event after
    them; ``get`` waits for that event only."""

    def __init__(self, *tensors: Optional[torch.Tensor]):
        self.event = None
        self.host = []
        for t in tensors:
            if t is None:
                self.host.append(None)
            elif t.is_cuda:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                buf.copy_(t, non_blocking=True)
                self.host.append(buf)
            else:
                self.host.append(t.detach())
        if any(t is not None and t.is_cuda for t in tensors):
            self.event = torch.cuda.Event()
            self.event.record()

    def get(self) -> List[Optional[np.ndarray]]:
        if self.event is not None:
            self.event.synchronize()
        return [None if t is None else t.numpy().copy() for t in self.host]


class EnvLoop:
    """Drives N env stages against a policy.

    ``envs`` is a list of independent VectorEnv instances (the stages). With
    k >= 2 stages the host's env steps of one stage hide behind the card's
    policy compute of the others.
    """

    def __init__(self, envs: List[VectorEnv], policy: Policy, device="cuda"):
        self.envs = envs
        self.policy = policy
        self.device = resolve_device(device)
        self._obs: Optional[List[Dict[str, np.ndarray]]] = None
        self._last_done: Optional[List[np.ndarray]] = None

    @property
    def num_envs(self) -> int:
        return sum(e.num_envs for e in self.envs)

    def reset(self):
        self._obs = [env.reset() for env in self.envs]
        self._last_done = [np.zeros(env.num_envs, np.float32) for env in self.envs]

    def _on_device(self, obs: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {key: to_device(np.ascontiguousarray(v), self.device) for key, v in obs.items()}

    @torch.no_grad()
    def interact(
        self,
        params,
        generator: torch.Generator,
        num_steps: int,
        *,
        deterministic: bool = False,
    ) -> Trajectory:
        """Collect ``num_steps`` chunk-steps from every stage; returns one
        merged time-major Trajectory (stages concatenated on the env axis)."""
        if self._obs is None:
            self.reset()

        k = len(self.envs)
        buffers = [TrajectoryBuffer() for _ in range(k)]
        initial_dones = [d.copy() for d in self._last_done]

        for _ in range(num_steps):
            # Phase 1: queue the policy of ALL stages on the card, each
            # followed by the copies of its outputs to the host.
            pending = []
            for s in range(k):
                out = self.policy.predict_action_batch(
                    params, generator, self._on_device(self._obs[s]),
                    deterministic=deterministic)
                pending.append(_HostCopy(out.actions, out.logprobs, out.values))
            # Phase 2: wait for stage s's outputs only and step its envs on
            # the host while the later stages still compute.
            for s in range(k):
                actions, logprobs, values = pending[s].get()
                # wire actions (trained on) -> env actions (bin policies
                # decode centers)
                env_actions = self.policy.env_actions(torch.from_numpy(actions))
                step = self.envs[s].step(env_actions.numpy())
                buffers[s].add(
                    self._obs[s], actions, step.reward, step.done, values, logprobs
                )
                self._obs[s] = step.obs
                self._last_done[s] = step.done.astype(np.float32)

        # Bootstrap values of the final observations.
        boots = [
            _HostCopy(self.policy.value(params, self._on_device(self._obs[s])))
            if buffers[s]._values else None
            for s in range(k)
        ]
        trajectories = [
            buffers[s].build(
                bootstrap_value=None if boots[s] is None else boots[s].get()[0],
                final_done=self._last_done[s],
                initial_done=initial_dones[s],
            )
            for s in range(k)
        ]
        return _merge_stage_trajectories(trajectories)

    def env_metrics(self) -> Dict[str, float]:
        merged: Dict[str, list] = {}
        for env in self.envs:
            for key, v in env.metrics().items():
                merged.setdefault(key, []).append(v)
        return {k: float(np.mean(v)) for k, v in merged.items()}


def _merge_stage_trajectories(trajs: List[Trajectory]) -> Trajectory:
    if len(trajs) == 1:
        return trajs[0]
    cat = lambda xs: np.concatenate(xs, axis=1)
    return Trajectory(
        obs={k: cat([t.obs[k] for t in trajs]) for k in trajs[0].obs},
        actions=cat([t.actions for t in trajs]),
        rewards=cat([t.rewards for t in trajs]),
        dones=cat([t.dones for t in trajs]),
        values=(
            cat([t.values for t in trajs]) if trajs[0].values is not None else None
        ),
        logprobs=cat([t.logprobs for t in trajs]),
    )
