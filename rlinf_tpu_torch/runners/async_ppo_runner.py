"""Async PPO actor-learner with decoupled-PPO policy-lag correction.

Port of ``rlinf_tpu/runners/async_ppo_runner.py`` (reference analog: the
async PPO path, rlinf/workers/actor/async_ppo_fsdp_worker.py and
AsyncEmbodiedRunner, async_embodied_runner.py:157): the rollout runs
continuously against published params; each trajectory is stamped with the
version that produced it; the learner trains on whatever arrives,
correcting the off-policyness with the decoupled-PPO proximal anchor
(``algorithms/losses.py compute_decoupled_ppo_actor_loss``: logprobs
interpolated from the version lag).

The rollout thread reads only the params the learner published, a clone
with its version swapped as one reference (``PublishedParams``, see
``runners/async_embodied_runner.py`` for the thread model). The minibatch
permutations come from the learner's generator (seed + 1), the rollout's
actions from the thread's (seed + 2), the init from a third (seed).
"""

from __future__ import annotations

import dataclasses
import queue
from typing import Dict, List, Optional

import numpy as np
import torch

from rlinf_tpu_torch.algorithms import get_advantage_fn
from rlinf_tpu_torch.algorithms.losses import (
    compute_decoupled_ppo_actor_loss,
    compute_ppo_critic_loss,
)
from rlinf_tpu_torch.envs.base import VectorEnv
from rlinf_tpu_torch.models.embodiment.base_policy import Policy
from rlinf_tpu_torch.rollout.env_loop import EnvLoop
from rlinf_tpu_torch.runners.async_embodied_runner import PublishedParams, RolloutThread
from rlinf_tpu_torch.training.learner import _grads, optax_global_norm
from rlinf_tpu_torch.training.train_state import (
    OptimizerConfig,
    TrainState,
    apply_updates,
    create_train_state,
    make_optimizer,
)
from rlinf_tpu_torch.utils.device import resolve_device
from rlinf_tpu_torch.utils.metrics import MetricLogger


@dataclasses.dataclass(frozen=True)
class AsyncPPOConfig:
    total_train_steps: int = 500
    rollout_chunk_steps: int = 16
    num_epochs: int = 1
    num_mini_batches: int = 2
    gamma: float = 0.99
    gae_lambda: float = 0.95
    normalize_advantages: bool = True
    clip_ratio_low: float = 0.2
    clip_ratio_high: float = 0.2
    value_clip: float = 0.2
    huber_delta: float = 10.0
    weight_sync_interval: int = 1     # learner steps between param swaps
    seed: int = 0
    log_dir: Optional[str] = None
    log_interval: int = 20


class AsyncPPORunner:
    def __init__(
        self,
        cfg: AsyncPPOConfig,
        envs: List[VectorEnv],
        policy: Policy,
        *,
        optimizer: OptimizerConfig = OptimizerConfig(lr=3e-4, clip_grad=1.0),
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
        self.train_step = self._make_train_step()

        self.param_version = 0
        self.published = PublishedParams(self.state.params, 0)
        self._chunk_queue: "queue.Queue" = queue.Queue(maxsize=4)
        self._rollout: Optional[RolloutThread] = None
        self.global_step = 0

    @property
    def rollout_params(self):
        return self.published.params

    # ------------------------------------------------------------------
    def _make_train_step(self):
        cfg, policy, tx = self.cfg, self.policy, self.tx

        def loss_fn(params, batch, current_version):
            obs = {k[len("obs/"):]: v for k, v in batch.items() if k.startswith("obs/")}
            fwd = policy.default_forward(params, obs, batch["actions"])
            logprobs = fwd["logprobs"]
            actor_loss, am = compute_decoupled_ppo_actor_loss(
                logprobs=logprobs,
                old_logprobs=batch["old_logprobs"],
                advantages=batch["advantages"][:, None].expand(logprobs.shape),
                versions=batch["versions"][:, None].expand(logprobs.shape),
                current_version=current_version,
                clip_ratio_low=cfg.clip_ratio_low,
                clip_ratio_high=cfg.clip_ratio_high,
            )
            critic_loss, cm = compute_ppo_critic_loss(
                values=fwd["values"],
                returns=batch["returns"],
                prev_values=batch["prev_values"],
                value_clip=cfg.value_clip,
                huber_delta=cfg.huber_delta,
            )
            return actor_loss + critic_loss, {**am, **cm}

        def step(state: TrainState, batch, current_version: float):
            grads, loss, metrics = _grads(
                state.params, lambda p: loss_fn(p, batch, current_version))
            grad_norm = optax_global_norm(grads)
            updates, new_opt = tx.update(grads, state.opt_state, state.params)
            del grads
            apply_updates(state.params, updates)
            metrics = dict(metrics)
            metrics["actor/loss"] = loss
            metrics["actor/grad_norm"] = grad_norm
            return TrainState(state.step + 1, state.params, new_opt), metrics

        return step

    # ------------------------------------------------------------------
    def _rollout_forever(self, stop):
        while not stop.is_set():
            version, params = self.published.take()
            traj = self.loop.interact(params, self._rollout_generator,
                                      self.cfg.rollout_chunk_steps)
            try:
                self._chunk_queue.put((traj, version), timeout=1.0)
            except queue.Full:
                pass  # drop stale work; PPO wants fresh data anyway

    def _chunk_to_batch(self, traj, version) -> Dict[str, torch.Tensor]:
        t = lambda a: torch.as_tensor(a, device=self.device)
        adv, ret = get_advantage_fn("gae")(
            rewards=t(traj.rewards),
            values=t(traj.values),
            dones=t(traj.dones),
            gamma=self.cfg.gamma,
            gae_lambda=self.cfg.gae_lambda,
            normalize_advantages=self.cfg.normalize_advantages,
        )
        flat = traj.flatten()
        N = flat["actions"].shape[0]
        flat["prev_values"] = flat.pop("values")
        flat["old_logprobs"] = flat.pop("logprobs")
        flat["versions"] = np.full(N, version, np.float32)
        flat.pop("rewards")
        batch = {k: t(v) for k, v in flat.items()}
        batch["advantages"] = adv.reshape(N)
        batch["returns"] = ret.reshape(N)
        return batch

    def run(self, max_steps: Optional[int] = None) -> List[Dict[str, float]]:
        n = max_steps or self.cfg.total_train_steps
        self._rollout = rollout = RolloutThread(self._rollout_forever)
        history: List[Dict[str, float]] = []
        try:
            while self.global_step < n:
                rollout.check()
                traj, version = self._chunk_queue.get(timeout=60.0)
                batch = self._chunk_to_batch(traj, version)
                N = batch["actions"].shape[0]
                metrics = {}
                for _ in range(self.cfg.num_epochs):
                    perm = torch.randperm(N, generator=self._generator).numpy()
                    for idx in np.split(perm, self.cfg.num_mini_batches):
                        rows = torch.as_tensor(idx, device=self.device)
                        mb = {k: v[rows] for k, v in batch.items()}
                        self.state, metrics = self.train_step(
                            self.state, mb, float(self.param_version))
                self.global_step += 1
                if self.global_step % self.cfg.weight_sync_interval == 0:
                    self.param_version += 1
                    self.published.publish(self.state.params, self.param_version)
                out = {k: float(v) for k, v in metrics.items()}
                out["rollout/reward_mean"] = float(traj.rewards.mean())
                out["async/version_lag"] = self.param_version - float(version)
                out.update(self.loop.env_metrics())
                history.append(out)
                if self.global_step % self.cfg.log_interval == 0:
                    self.logger.log(out, self.global_step)
        finally:
            rollout.join(timeout=10.0)
        return history
