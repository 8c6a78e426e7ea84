"""Env wrappers: episode collection (lerobot-style export) and frame capture.

Port of ``rlinf_tpu/envs/wrappers.py``: pure numpy, a copy.

Reference analog: rlinf/envs/wrappers/{collect_episode,record_video}.py.
``CollectEpisodeWrapper`` accumulates per-env episodes (obs/action/reward)
and writes finished ones as compressed npz files — the offline-dataset export
path that feeds OfflineRunner / BC.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from rlinf_tpu_torch.envs.base import EnvOutput, VectorEnv


class CollectEpisodeWrapper(VectorEnv):
    """Wraps a VectorEnv; episodes persist to ``directory`` on completion."""

    def __init__(self, env: VectorEnv, directory: str, max_episodes: int = 0):
        self.env = env
        self.directory = directory
        self.max_episodes = max_episodes
        os.makedirs(directory, exist_ok=True)
        self.num_envs = env.num_envs
        self.obs_spec = env.obs_spec
        self.action_dim = env.action_dim
        self.max_episode_steps = env.max_episode_steps
        self._episodes_written = 0
        self._cur: List[Dict[str, list]] = [
            {"obs": [], "actions": [], "rewards": []} for _ in range(env.num_envs)
        ]
        self._last_obs = None

    def reset(self):
        obs = self.env.reset()
        self._last_obs = obs
        for c in self._cur:
            c["obs"].clear(); c["actions"].clear(); c["rewards"].clear()
        return obs

    def step(self, actions: np.ndarray) -> EnvOutput:
        out = self.env.step(actions)
        for i in range(self.num_envs):
            c = self._cur[i]
            c["obs"].append(
                {k: np.asarray(v[i]) for k, v in self._last_obs.items()}
            )
            c["actions"].append(np.asarray(actions[i]))
            c["rewards"].append(float(out.reward[i]))
            if out.done[i]:
                self._flush_episode(i)
        self._last_obs = out.obs
        return out

    def _flush_episode(self, i: int):
        c = self._cur[i]
        if not c["actions"]:
            return
        if self.max_episodes and self._episodes_written >= self.max_episodes:
            c["obs"].clear(); c["actions"].clear(); c["rewards"].clear()
            return
        data = {
            "actions": np.stack(c["actions"]),
            "rewards": np.asarray(c["rewards"], np.float32),
        }
        for key in c["obs"][0]:
            data[f"obs/{key}"] = np.stack([o[key] for o in c["obs"]])
        path = os.path.join(
            self.directory, f"episode_{self._episodes_written:06d}.npz"
        )
        np.savez_compressed(path, **data)
        self._episodes_written += 1
        c["obs"].clear(); c["actions"].clear(); c["rewards"].clear()

    def metrics(self):
        m = self.env.metrics()
        m["collect/episodes_written"] = float(self._episodes_written)
        return m

    @staticmethod
    def load_episodes_to_buffer(directory: str, buffer) -> int:
        return _load_episodes_to_buffer(directory, buffer)


class RecordVideoWrapper(VectorEnv):
    """Record env-0's frames to mp4 per episode (reference
    envs/wrappers/record_video.py). Frames come from the ``images`` obs key
    when present, else ``env.render()`` when the wrapped env exposes one;
    written with imageio every ``record_every`` episodes."""

    def __init__(self, env: VectorEnv, directory: str, *,
                 record_every: int = 1, fps: int = 20,
                 image_key: str = "images", max_videos: int = 0):
        self.env = env
        self.directory = directory
        self.record_every = record_every
        self.fps = fps
        self.image_key = image_key
        self.max_videos = max_videos
        os.makedirs(directory, exist_ok=True)
        self.num_envs = env.num_envs
        self.obs_spec = env.obs_spec
        self.action_dim = env.action_dim
        self.max_episode_steps = env.max_episode_steps
        self._frames: List[np.ndarray] = []
        self._episode_idx = 0
        self.videos_written = 0
        self._last_obs = None

    def _frame(self, obs) -> Optional[np.ndarray]:
        if self.image_key in obs:
            f = np.asarray(obs[self.image_key][0])
            if f.dtype != np.uint8:
                f = np.clip(f * 255.0, 0, 255).astype(np.uint8)
            return f
        render = getattr(self.env, "render", None)
        if callable(render):
            f = render()
            return None if f is None else np.asarray(f, np.uint8)
        return None

    def reset(self):
        obs = self.env.reset()
        self._frames.clear()
        f = self._frame(obs)
        if f is not None:
            self._frames.append(f)
        self._last_obs = obs
        return obs

    def step(self, actions: np.ndarray) -> EnvOutput:
        out = self.env.step(actions)
        f = self._frame(out.obs)
        if f is not None:
            self._frames.append(f)
        if out.done[0]:
            self._finish_episode()
        self._last_obs = out.obs
        return out

    def _finish_episode(self):
        record = (self._episode_idx % self.record_every == 0
                  and self._frames
                  and not (self.max_videos
                           and self.videos_written >= self.max_videos))
        if record:
            self._write_video(
                os.path.join(self.directory,
                             f"episode_{self._episode_idx:06d}"),
                self._frames)
            self.videos_written += 1
        self._episode_idx += 1
        self._frames.clear()

    def _write_video(self, stem: str, frames: List[np.ndarray]):
        """mp4 via OpenCV when a codec is available, else GIF via imageio's
        pillow backend (ffmpeg isn't guaranteed in minimal images)."""
        h, w = frames[0].shape[:2]
        try:
            import cv2

            writer = cv2.VideoWriter(
                stem + ".mp4", cv2.VideoWriter_fourcc(*"mp4v"),
                self.fps, (w, h))
            if writer.isOpened():
                for f in frames:
                    writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
                writer.release()
                if os.path.getsize(stem + ".mp4") > 0:
                    return
            if os.path.exists(stem + ".mp4"):
                os.unlink(stem + ".mp4")
        except ImportError:
            pass
        import imageio.v2 as imageio

        imageio.mimsave(stem + ".gif", frames,
                        duration=1000.0 / self.fps, loop=0)

    def metrics(self):
        m = self.env.metrics()
        m["video/videos_written"] = float(self.videos_written)
        return m


def _load_episodes_to_buffer(directory: str, buffer) -> int:
    """Feed collected episodes into a ReplayBuffer as transition items
    (obs/next_obs/actions/rewards/dones) for offline training."""
    count = 0
    for name in sorted(os.listdir(directory)):
        if not name.endswith(".npz"):
            continue
        with np.load(os.path.join(directory, name)) as z:
            T = z["actions"].shape[0]
            item = {
                "actions": z["actions"],
                "rewards": z["rewards"],
                "dones": np.concatenate(
                    [np.zeros(T - 1, np.float32), np.ones(1, np.float32)]
                ),
            }
            for k in z.files:
                if k.startswith("obs/"):
                    obs = z[k]
                    item[k] = obs
                    item["next_" + k] = np.concatenate(
                        [obs[1:], obs[-1:]], axis=0
                    )
        buffer.add(item)
        count += 1
    return count


class ActionChunkWrapper(VectorEnv):
    """Executes a K-step action CHUNK per env step.

    The analog of the reference's chunked action stepping for VLA policies
    (reference rlinf/workers/env/env_worker.py chunk-step loop accumulating
    ChunkStepResult, :1035-1143): the policy emits [B, K*A] (K chunk steps of
    an A-dim action); the wrapper steps the inner env K times, sums rewards,
    ORs dones, and reports the final observation. Done-masking within a
    chunk follows the reference's behavior: the inner env auto-resets, and
    remaining chunk actions apply to the fresh episode (chunk boundaries are
    not episode boundaries).
    """

    def __init__(self, env: VectorEnv, chunk: int):
        self.env = env
        self.chunk = chunk
        self.num_envs = env.num_envs
        self.obs_spec = env.obs_spec
        self.inner_action_dim = env.action_dim
        self.action_dim = env.action_dim * chunk
        self.max_episode_steps = max(1, env.max_episode_steps // chunk)

    def reset(self):
        return self.env.reset()

    def step(self, actions: np.ndarray) -> EnvOutput:
        B = actions.shape[0]
        acts = np.asarray(actions, np.float32).reshape(
            B, self.chunk, self.inner_action_dim
        )
        total_reward = np.zeros(B, np.float32)
        done = np.zeros(B, bool)
        terminated = np.zeros(B, bool)
        out = None
        for k in range(self.chunk):
            out = self.env.step(acts[:, k])
            total_reward += out.reward
            done |= out.done
            terminated |= out.terminated
        return EnvOutput(
            obs=out.obs, reward=total_reward, done=done,
            terminated=terminated, info=out.info,
        )

    def metrics(self):
        return self.env.metrics()
