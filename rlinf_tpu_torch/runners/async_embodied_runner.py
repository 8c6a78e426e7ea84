"""Asynchronous embodied actor-learner (SAC).

Port of ``rlinf_tpu/runners/async_embodied_runner.py`` (reference analog:
AsyncEmbodiedRunner, rlinf/runners/async_embodied_runner.py:157-203): the
rollout loop runs in a background thread for the whole run, the learner
drains a bounded queue of transition chunks into a replay buffer, bumps a
version counter and publishes its weights every ``weight_sync_interval``
steps without stopping the rollout.

The thread model. The JAX package hands the rollout thread a params tree
that the learner swaps, race-free because JAX arrays are immutable. The
port's optimizer writes the params in place (``train_state.apply_updates``,
and the f32 master of ``with_master_weights``), so the learner publishes a
CLONE of its params (``PublishedParams``): the tree and its version are one
reference, swapped whole, and the rollout thread reads only what was
published. On the card the clone is queued on the learner's current
stream, followed by an event that the rollout thread's current stream
waits on before it reads the tree (both threads take the default stream
unless a caller sets another; the event keeps the order either way), so
a rollout never reads a half-written clone. The rollout thread holds its
snapshot until its env loop has read back every output
(``EnvLoop.interact`` waits on events recorded after the last kernel that
reads it), so a swapped-out snapshot is freed only after its last reader
ran. A rollout on its own stream measured no faster on an H100: the two
threads contend for the GIL, not for the stream. Grad mode is thread-local: the rollout
thread enters ``torch.no_grad()`` itself. Each thread owns its generator:
the learner's (seed + 1) draws the SAC step's noise and the eval's, the
rollout thread's (seed + 2) its actions; the params come from a third
(seed). If the rollout thread dies, the learner raises with its exception
as the cause.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from rlinf_tpu_torch.data.replay_buffer import ReplayBuffer
from rlinf_tpu_torch.envs.base import VectorEnv
from rlinf_tpu_torch.models.embodiment.sac_policy import MLPSACPolicy
from rlinf_tpu_torch.rollout.env_loop import EnvLoop
from rlinf_tpu_torch.training.sac_learner import SACConfig, make_sac_train_step
from rlinf_tpu_torch.training.train_state import (
    OptimizerConfig,
    create_train_state,
    make_optimizer,
    tree_leaves,
    tree_map,
)
from rlinf_tpu_torch.utils.device import resolve_device
from rlinf_tpu_torch.utils.metrics import MetricLogger


@dataclasses.dataclass(frozen=True)
class AsyncRunnerConfig:
    total_train_steps: int = 1000
    rollout_chunk_steps: int = 16       # env steps per produced chunk
    train_batch_size: int = 256
    warmup_transitions: int = 1000      # before first update
    weight_sync_interval: int = 10      # learner steps between param swaps
    updates_per_chunk: float = 1.0      # UTD control (throttles learner)
    replay_capacity: int = 1000         # items (chunks)
    seed: int = 0
    log_dir: Optional[str] = None
    log_interval: int = 50


class PublishedParams:
    """The weights the rollout thread acts with: a clone of the learner's
    params and its version, held as one reference that ``publish`` swaps.
    ``take`` returns (version, tree); on the card it first makes the
    caller's stream wait for the clone."""

    def __init__(self, params, version: int = 0):
        self.publish(params, version)

    def publish(self, params, version: int) -> None:
        with torch.no_grad():
            tree = tree_map(lambda t: t.detach().clone(), params)
        event = None
        leaves = tree_leaves(tree)
        if leaves and leaves[0].is_cuda:
            event = torch.cuda.Event()
            event.record()
        self._current = (version, tree, event)

    def take(self) -> Tuple[int, object]:
        version, tree, event = self._current
        if event is not None:
            torch.cuda.current_stream().wait_event(event)
        return version, tree

    @property
    def params(self):
        return self._current[1]


class RolloutThread:
    """A daemon thread running ``body(stop)`` under ``torch.no_grad()``;
    ``check`` raises in the caller once the thread has died."""

    def __init__(self, body):
        self.stop = threading.Event()
        self.error: Optional[BaseException] = None
        self._body = body
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            with torch.no_grad():
                self._body(self.stop)
        except BaseException as e:      # re-raised in the learner by check()
            self.error = e
            raise

    def check(self, what: str = "rollout thread died") -> None:
        if not self._thread.is_alive() and not self.stop.is_set():
            raise RuntimeError(f"{what}; see its traceback above") from self.error

    def join(self, timeout: float = 10.0) -> None:
        self.stop.set()
        self._thread.join(timeout=timeout)


class AsyncEmbodiedRunner:
    """SAC actor-learner with continuous background rollout."""

    def __init__(
        self,
        cfg: AsyncRunnerConfig,
        envs: List[VectorEnv],
        policy: MLPSACPolicy,
        *,
        sac: SACConfig = SACConfig(),
        optimizer: OptimizerConfig = OptimizerConfig(
            lr=3e-4, clip_grad=0.0, weight_decay=0.0
        ),
        device="cuda",
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.policy = policy
        self.loop = EnvLoop(envs, policy, device=self.device)
        self.logger = MetricLogger(cfg.log_dir, print_every=cfg.log_interval)

        self.tx = make_optimizer(optimizer)
        init_generator = torch.Generator().manual_seed(cfg.seed)
        self._generator = torch.Generator().manual_seed(cfg.seed + 1)
        self._rollout_generator = torch.Generator().manual_seed(cfg.seed + 2)
        self.state = create_train_state(
            lambda: policy.init(init_generator, device=self.device), self.tx)
        self.train_step = make_sac_train_step(policy, sac, self.tx, device=self.device)

        self.buffer = ReplayBuffer(cfg.replay_capacity, seed=cfg.seed)
        self._chunk_queue: "queue.Queue" = queue.Queue(maxsize=8)
        self.param_version = 0
        self.published = PublishedParams(self.state.params, 0)
        self._rollout: Optional[RolloutThread] = None
        self._chunks_produced = 0
        self.global_step = 0

    @property
    def rollout_params(self):
        """The params the rollout thread acts with (the last published)."""
        return self.published.params

    # ------------------------------------------------------------------
    def _transitions(self, traj, version: int) -> Dict[str, np.ndarray]:
        """[T, B, ...] -> flat transitions with next_obs and version stamps."""
        T, B = traj.num_steps, traj.num_envs
        chunk = {
            "actions": traj.actions[:].reshape(T * B, -1),
            "rewards": traj.rewards.reshape(T * B),
            "dones": traj.dones[1:].reshape(T * B).astype(np.float32),
            "versions": np.full(T * B, version, np.int32),
        }
        for k, v in traj.obs.items():
            nxt = np.concatenate([v[1:], v[-1:]], axis=0)
            chunk[f"obs/{k}"] = v.reshape(T * B, *v.shape[2:])
            chunk[f"next_obs/{k}"] = nxt.reshape(T * B, *v.shape[2:])
        return chunk

    def _rollout_forever(self, stop: threading.Event):
        while not stop.is_set():
            version, params = self.published.take()
            traj = self.loop.interact(params, self._rollout_generator,
                                      self.cfg.rollout_chunk_steps)
            chunk = self._transitions(traj, version)
            try:
                self._chunk_queue.put(chunk, timeout=1.0)
                self._chunks_produced += 1
            except queue.Full:
                pass  # learner behind: drop (off-policy, buffer still fresh)

    def _drain_queue(self):
        drained = 0
        while True:
            try:
                chunk = self._chunk_queue.get_nowait()
            except queue.Empty:
                return drained
            self.buffer.add(chunk)
            drained += 1

    def _target_updates(self) -> float:
        return (self._chunks_produced * self.cfg.rollout_chunk_steps * self.loop.num_envs
                * self.cfg.updates_per_chunk / self.cfg.train_batch_size)

    # ------------------------------------------------------------------
    def run(self, max_steps: Optional[int] = None) -> Dict[str, float]:
        n = max_steps or self.cfg.total_train_steps
        self._rollout = rollout = RolloutThread(self._rollout_forever)
        metrics = {}
        try:
            # warmup
            while self.buffer.total_transitions < self.cfg.warmup_transitions:
                rollout.check("rollout thread died during warmup")
                self._drain_queue()
                time.sleep(0.01)

            while self.global_step < n:
                self._drain_queue()
                batch = self.buffer.sample_transitions(self.cfg.train_batch_size)
                batch.pop("versions", None)
                self.state, metrics = self.train_step(self.state, batch, self._generator)
                self.global_step += 1

                if self.global_step % self.cfg.weight_sync_interval == 0:
                    # non-blocking weight sync (reference no_wait=True analog)
                    self.param_version += 1
                    self.published.publish(self.state.params, self.param_version)

                if self.global_step % self.cfg.log_interval == 0:
                    out = {k: float(v) for k, v in metrics.items()}
                    out.update(self.loop.env_metrics())
                    out["async/buffer_transitions"] = float(self.buffer.total_transitions)
                    out["async/chunks_produced"] = float(self._chunks_produced)
                    out["async/param_version"] = float(self.param_version)
                    self.logger.log(out, self.global_step)
                # UTD throttle: don't run far ahead of data production
                while self.global_step > self._target_updates() + 5 and not rollout.stop.is_set():
                    rollout.check()
                    time.sleep(0.005)
                    self._drain_queue()
        finally:
            rollout.join(timeout=10.0)
        # final weight sync so evaluation sees the trained policy
        self.published.publish(self.state.params, self.param_version)
        return {k: float(v) for k, v in metrics.items()}

    def evaluate(self, env: VectorEnv, num_steps: int = 64) -> Dict[str, float]:
        loop = EnvLoop([env], self.policy, device=self.device)
        loop.reset()
        loop.env_metrics()
        loop.interact(self.state.params, self._generator, num_steps, deterministic=True)
        return {f"eval/{k}": v for k, v in loop.env_metrics().items()}
