"""Pure-numpy vectorized envs: test/bench stand-ins for the sim adapters.

Port of ``rlinf_tpu/envs/toy.py``: a copy, so that seeded envs give the
same observations and rewards bit for bit in both packages.

``PointReachEnv`` is a continuous-control reach task with the same metric
contract as the reference's headline ManiSkill tasks (``success_once``,
reference docs maniskill.rst:201): a PPO-trained Gaussian MLP should reach
>80% success within a few hundred iterations, giving the parity harness a
learnable signal without simulator dependencies.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from rlinf_tpu_torch.envs import register_env
from rlinf_tpu_torch.envs.base import EnvOutput, VectorEnv


@register_env("point_reach")
class PointReachEnv(VectorEnv):
    """2D point mass: action = clipped velocity, reward shaped by distance to
    goal; success when within ``goal_radius``. Auto-resets on done."""

    def __init__(
        self,
        num_envs: int,
        seed: int = 0,
        max_episode_steps: int = 32,
        arena: float = 1.0,
        goal_radius: float = 0.1,
        dt: float = 0.2,
    ):
        super().__init__(num_envs, seed)
        self.max_episode_steps = max_episode_steps
        self.arena = arena
        self.goal_radius = goal_radius
        self.dt = dt
        self.action_dim = 2
        self.obs_spec = {"states": (4,)}  # pos(2) + goal(2)
        self._rng = np.random.default_rng(seed)
        self._pos = np.zeros((num_envs, 2), np.float32)
        self._goal = np.zeros((num_envs, 2), np.float32)
        self._t = np.zeros(num_envs, np.int32)
        self._succeeded = np.zeros(num_envs, bool)
        self._ep_success: list = []
        self._ep_return: list = []
        self._ret = np.zeros(num_envs, np.float32)

    def _spawn(self, idx: np.ndarray):
        n = int(idx.sum())
        if n == 0:
            return
        self._pos[idx] = self._rng.uniform(-self.arena, self.arena, (n, 2)).astype(
            np.float32
        )
        self._goal[idx] = self._rng.uniform(-self.arena, self.arena, (n, 2)).astype(
            np.float32
        )
        self._t[idx] = 0
        self._succeeded[idx] = False
        self._ret[idx] = 0.0

    def _obs(self) -> Dict[str, np.ndarray]:
        return {
            "states": np.concatenate([self._pos, self._goal], axis=-1).astype(
                np.float32
            )
        }

    def reset(self) -> Dict[str, np.ndarray]:
        self._spawn(np.ones(self.num_envs, bool))
        return self._obs()

    def step(self, actions: np.ndarray) -> EnvOutput:
        actions = np.clip(np.asarray(actions, np.float32), -1.0, 1.0)
        prev_dist = np.linalg.norm(self._pos - self._goal, axis=-1)
        self._pos = np.clip(
            self._pos + self.dt * actions, -1.5 * self.arena, 1.5 * self.arena
        )
        dist = np.linalg.norm(self._pos - self._goal, axis=-1)
        success = dist < self.goal_radius
        # dense shaping + success bonus
        reward = (prev_dist - dist) + 5.0 * (success & ~self._succeeded)
        self._succeeded |= success
        self._t += 1
        self._ret += reward

        terminated = success
        truncated = self._t >= self.max_episode_steps
        done = terminated | truncated

        final_obs = self._obs()
        if done.any():
            for i in np.nonzero(done)[0]:
                self._ep_success.append(bool(self._succeeded[i]))
                self._ep_return.append(float(self._ret[i]))
            self._spawn(done)

        return EnvOutput(
            obs=self._obs(),
            reward=reward.astype(np.float32),
            done=done,
            terminated=terminated,
            info={"final_obs": final_obs, "success": success},
        )

    def metrics(self) -> Dict[str, float]:
        out = {}
        if self._ep_success:
            out["env/success_once"] = float(np.mean(self._ep_success))
            out["env/episode_return"] = float(np.mean(self._ep_return))
            out["env/num_episodes"] = float(len(self._ep_success))
        self._ep_success.clear()
        self._ep_return.clear()
        return out


@register_env("image_reach")
class ImageReachEnv(PointReachEnv):
    """PointReach with a rendered image observation: agent dot (red) + goal
    dot (green) on a ``size``x``size`` canvas, plus the state vector. The
    in-tree learnability check for VLA / image policies — the analog of the
    reference's ManiSkill image tasks in its e2e test matrix (SURVEY.md §4).
    Dots are 2x2 blocks so a patch-16 ViT sees gradient signal everywhere."""

    def __init__(self, num_envs: int, seed: int = 0, size: int = 32, **kw):
        super().__init__(num_envs, seed, **kw)
        self.size = size
        self.obs_spec = {"states": (4,), "images": (size, size, 3)}

    def _render(self) -> np.ndarray:
        B, S = self.num_envs, self.size
        img = np.zeros((B, S, S, 3), np.float32)
        span = 1.5 * self.arena
        rows = np.arange(B)

        def blit(pts, channel):
            xy = ((pts / span + 1.0) * 0.5 * (S - 2)).astype(int).clip(0, S - 2)
            for dy in (0, 1):
                for dx in (0, 1):
                    img[rows, xy[:, 1] + dy, xy[:, 0] + dx, channel] = 1.0

        blit(self._pos, 0)
        blit(self._goal, 1)
        return img

    def _obs(self) -> Dict[str, np.ndarray]:
        out = super()._obs()
        out["images"] = self._render()
        return out


@register_env("bandit")
class BanditEnv(VectorEnv):
    """1-step continuous bandit: reward = -||a - target||^2. The fastest
    possible learnability check for the PPO path."""

    def __init__(self, num_envs: int, seed: int = 0, action_dim: int = 2):
        super().__init__(num_envs, seed)
        self.max_episode_steps = 1
        self.action_dim = action_dim
        self.obs_spec = {"states": (action_dim,)}
        self._rng = np.random.default_rng(seed)
        self._target = np.zeros((num_envs, action_dim), np.float32)

    def reset(self):
        self._target = self._rng.uniform(-0.5, 0.5, (self.num_envs, self.action_dim)).astype(np.float32)
        return {"states": self._target.copy()}

    def step(self, actions):
        actions = np.asarray(actions, np.float32)
        reward = -np.sum((actions - self._target) ** 2, axis=-1)
        done = np.ones(self.num_envs, bool)
        obs = self.reset()
        return EnvOutput(
            obs=obs, reward=reward.astype(np.float32), done=done,
            terminated=done, info={"final_obs": obs},
        )
