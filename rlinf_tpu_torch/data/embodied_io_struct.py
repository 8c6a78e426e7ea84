"""Embodied trajectory structs (reference: rlinf/data/embodied_io_struct.py —
Trajectory, EnvOutput, ChunkStepResult).

Port of ``rlinf_tpu/data/embodied_io_struct.py``: host numpy buffers,
a copy.

Time-major host buffers: [T, B, ...] to match the reference's advantage
preprocessing layout (rlinf/algorithms/utils.py:68
preprocess_embodied_advantages_inputs) and our GAE estimator.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Trajectory:
    """One rollout epoch's data. values/dones carry T+1 entries (bootstrap)."""

    obs: Dict[str, np.ndarray]        # each [T, B, ...]
    actions: np.ndarray               # [T, B, A]
    rewards: np.ndarray               # [T, B]
    dones: np.ndarray                 # [T+1, B] float/bool
    values: Optional[np.ndarray]      # [T+1, B] (critic) or None
    logprobs: np.ndarray              # [T, B, A] behavior logprobs

    @property
    def num_steps(self) -> int:
        return self.actions.shape[0]

    @property
    def num_envs(self) -> int:
        return self.actions.shape[1]

    def flatten(self) -> Dict[str, np.ndarray]:
        """[T, B, ...] -> [T*B, ...] for minibatched updates."""
        T, B = self.num_steps, self.num_envs
        out = {
            "actions": self.actions.reshape(T * B, -1),
            "rewards": self.rewards.reshape(T * B),
            "logprobs": self.logprobs.reshape(T * B, -1),
        }
        for k, v in self.obs.items():
            out[f"obs/{k}"] = v.reshape(T * B, *v.shape[2:])
        if self.values is not None:
            out["values"] = self.values[:-1].reshape(T * B)
        return out


class TrajectoryBuffer:
    """Accumulates per-step results into a Trajectory."""

    def __init__(self):
        self._obs: List[Dict[str, np.ndarray]] = []
        self._actions: List[np.ndarray] = []
        self._rewards: List[np.ndarray] = []
        self._dones: List[np.ndarray] = []
        self._values: List[np.ndarray] = []
        self._logprobs: List[np.ndarray] = []

    def add(self, obs, actions, reward, done, value, logprob):
        self._obs.append({k: np.asarray(v) for k, v in obs.items()})
        self._actions.append(np.asarray(actions))
        self._rewards.append(np.asarray(reward))
        self._dones.append(np.asarray(done))
        if value is not None:
            self._values.append(np.asarray(value))
        self._logprobs.append(np.asarray(logprob))

    def build(
        self,
        bootstrap_value: Optional[np.ndarray],
        final_done: np.ndarray,
        initial_done: Optional[np.ndarray] = None,
    ) -> Trajectory:
        """dones[t] marks episode boundary BEFORE step t's transition; the GAE
        recursion reads dones[t+1] to gate bootstrap across resets."""
        T = len(self._actions)
        B = self._actions[0].shape[0]
        dones = np.zeros((T + 1, B), np.float32)
        if initial_done is not None:
            dones[0] = initial_done
        for t in range(1, T + 1):
            dones[t] = self._dones[t - 1]
        values = None
        if self._values:
            values = np.stack(
                self._values + [np.zeros_like(self._values[0])
                                if bootstrap_value is None else bootstrap_value]
            ).astype(np.float32)
        obs = {
            k: np.stack([o[k] for o in self._obs]) for k in self._obs[0]
        }
        return Trajectory(
            obs=obs,
            actions=np.stack(self._actions).astype(np.float32),
            rewards=np.stack(self._rewards).astype(np.float32),
            dones=dones,
            values=values,
            logprobs=np.stack(self._logprobs).astype(np.float32),
        )
