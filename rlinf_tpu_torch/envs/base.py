"""VectorEnv contract: gym-style batched reset/step over numpy arrays.

Port of ``rlinf_tpu/envs/base.py``: pure numpy, kept as a copy (the port
imports nothing of the JAX package).

Reference analog: the common env contract consumed by EnvWorker
(reference rlinf/workers/env/env_worker.py:381-391 — vectorized reset/step
returning batched tensor obs in an EnvOutput, seed_offset/total partitioning,
optional offload()).

Auto-reset semantics: ``step`` returns (obs_after_autoreset, reward, done,
info); when ``done[i]`` the returned obs row i is the FIRST obs of a fresh
episode, and ``info["final_obs"]`` carries the terminal observation for
bootstrap-value computation (the reference's bootstrap-on-truncation,
env_worker.py:688).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class EnvOutput:
    """One batched env step's result (reference data/embodied_io_struct.py)."""

    obs: Dict[str, np.ndarray]
    reward: np.ndarray          # [B]
    done: np.ndarray            # [B] bool (terminated | truncated)
    terminated: np.ndarray      # [B] bool (true env termination)
    info: Dict[str, Any]


class VectorEnv:
    """Subclass and implement reset/step; all arrays batched [num_envs, ...]."""

    num_envs: int
    obs_spec: Dict[str, Tuple[int, ...]]   # name -> per-env shape
    action_dim: int
    discrete: bool = False
    max_episode_steps: int = 0

    def __init__(self, num_envs: int, seed: int = 0, **kwargs):
        self.num_envs = num_envs
        self.seed = seed

    def reset(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def step(self, actions: np.ndarray) -> EnvOutput:
        raise NotImplementedError

    def offload(self):
        """Free sim resources (reference maniskill offload variant)."""

    def metrics(self) -> Dict[str, float]:
        """Episode statistics since last call (success rates etc.)."""
        return {}
