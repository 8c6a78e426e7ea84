"""Embodied PPO training loop.

Port of ``rlinf_tpu/runners/embodied_runner.py`` (reference analog:
EmbodiedRunner, rlinf/runners/embodied_runner.py:53,478): per global step
an env/rollout interaction epoch (stage-pipelined, ``rollout/env_loop.py``),
GAE advantages (``get_advantage_fn("gae")``), the optional OPD teacher term
mixed into the advantages, PPO epochs over minibatches, periodic eval and
checkpoints with auto-resume. Weight sync between learner and rollout is
the params argument.

The params come from ``policy.init`` drawing on a CPU ``torch.Generator``
seeded with ``seed``, or on ``init_generator`` where one is given (a
generator on the card draws billions of params in milliseconds where the
host takes seconds a billion); the rollout's sampling, the minibatch
permutations and the eval draw from a second one seeded with ``seed + 1``
(the JAX package splits one threefry key for all of these). Like the JAX
runner's key it is not checkpointed, so a resumed run samples anew from
that seed.
The run is on the card unless ``device`` says otherwise.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from rlinf_tpu_torch.algorithms import get_advantage_fn
from rlinf_tpu_torch.data.embodied_io_struct import Trajectory
from rlinf_tpu_torch.envs.base import VectorEnv
from rlinf_tpu_torch.models.embodiment.base_policy import Policy
from rlinf_tpu_torch.rollout.env_loop import EnvLoop
from rlinf_tpu_torch.training.embodied_learner import (
    EmbodiedLossConfig,
    make_embodied_train_step,
)
from rlinf_tpu_torch.training.train_state import (
    OptimizerConfig,
    create_train_state,
    make_optimizer,
)
from rlinf_tpu_torch.utils.checkpoint import CheckpointManager
from rlinf_tpu_torch.utils.device import resolve_device
from rlinf_tpu_torch.utils.metrics import MetricLogger
from rlinf_tpu_torch.utils.sync import host_sync
from rlinf_tpu_torch.utils.timers import Timers


@dataclasses.dataclass(frozen=True)
class EmbodiedRunnerConfig:
    """Mirrors reference examples/embodiment YAML (rollout epoch length, PPO
    epochs/minibatches, GAE params, eval cadence)."""

    num_chunk_steps: int = 32          # env steps per rollout epoch
    num_epochs: int = 4                # PPO epochs per rollout
    num_mini_batches: int = 4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    normalize_advantages: bool = True
    max_steps: int = 100
    seed: int = 0
    log_dir: Optional[str] = None
    checkpoint_dir: Optional[str] = None
    save_interval: int = 100
    eval_interval: int = 0             # 0 = no eval
    eval_steps: int = 64


class EmbodiedRunner:
    def __init__(
        self,
        cfg: EmbodiedRunnerConfig,
        envs: List[VectorEnv],
        policy: Policy,
        *,
        optimizer: OptimizerConfig = OptimizerConfig(lr=3e-4, clip_grad=1.0),
        loss_cfg: EmbodiedLossConfig = EmbodiedLossConfig(),
        eval_envs: Optional[List[VectorEnv]] = None,
        teacher: Optional[tuple] = None,   # (teacher_policy, teacher_params)
        opd_coef: float = 0.0,             # >0 adds OPD distillation term
        init_generator: Optional[torch.Generator] = None,
        device="cuda",
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.policy = policy
        self.loop = EnvLoop(envs, policy, device=self.device)
        self.eval_loop = EnvLoop(eval_envs, policy, device=self.device) if eval_envs else None
        self.timers = Timers()
        self.logger = MetricLogger(cfg.log_dir)

        self.teacher = teacher
        self.opd_coef = opd_coef
        self.tx = make_optimizer(optimizer)
        self._generator = torch.Generator().manual_seed(cfg.seed + 1)
        if init_generator is None:
            init_generator = torch.Generator().manual_seed(cfg.seed)
        self.state = create_train_state(
            lambda: policy.init(init_generator, device=self.device), self.tx)
        self.train_step = make_embodied_train_step(policy, loss_cfg, self.tx,
                                                   device=self.device)

        self.ckpt = (
            CheckpointManager(cfg.checkpoint_dir) if cfg.checkpoint_dir else None
        )
        self.global_step = 0
        if self.ckpt:
            state, extra, step = self.ckpt.restore(self.state)
            if state is not None:
                self.state = state
                self.global_step = step

    @torch.no_grad()
    def _teacher_logprob(self, obs, actions):
        t_policy, t_params = self.teacher
        return t_policy.default_forward(t_params, obs, actions)["logprobs"]

    def _compute_advantages(self, traj: Trajectory):
        gae = get_advantage_fn("gae")
        t = lambda a: torch.as_tensor(a, device=self.device)
        return gae(
            rewards=t(traj.rewards),
            values=t(traj.values) if traj.values is not None else None,
            dones=t(traj.dones),
            gamma=self.cfg.gamma,
            gae_lambda=self.cfg.gae_lambda,
            normalize_advantages=self.cfg.normalize_advantages,
        )

    def run_step(self) -> Dict[str, float]:
        cfg = self.cfg
        t_start = time.perf_counter()

        # 1. rollout epoch ------------------------------------------------
        with self.timers.scope("rollout"):
            traj = self.loop.interact(
                self.state.params, self._generator, cfg.num_chunk_steps
            )

        # 2. advantages ----------------------------------------------------
        adv, ret = self._compute_advantages(traj)  # [T, B]
        flat = traj.flatten()
        N = flat["actions"].shape[0]
        flat["prev_values"] = flat.pop("values")
        flat["old_logprobs"] = flat.pop("logprobs")
        batch = {k: torch.as_tensor(v, device=self.device)
                 for k, v in flat.items() if k != "rewards"}
        batch["advantages"] = adv.reshape(N)
        batch["returns"] = ret.reshape(N)

        # 2b. OPD: teacher logprobs on the rollout actions -> reverse-KL
        # dense reward mixed into the advantages (reference OPD path,
        # advantages.py:325 + fsdp_actor_worker.py:1332 teacher logprobs)
        if self.teacher is not None and self.opd_coef > 0:
            obs_flat = {k[len("obs/"):]: v for k, v in batch.items() if k.startswith("obs/")}
            t_lp = self._teacher_logprob(obs_flat, batch["actions"])
            opd_reward = (t_lp - batch["old_logprobs"]).sum(dim=-1)  # [N] reverse-KL reward
            batch["advantages"] = batch["advantages"] + self.opd_coef * opd_reward

        # 3. PPO epochs ----------------------------------------------------
        metrics = {}
        with self.timers.scope("training"):
            for _ in range(cfg.num_epochs):
                perm = torch.randperm(N, generator=self._generator).numpy()
                for idx in np.split(perm, cfg.num_mini_batches):
                    rows = torch.as_tensor(idx, device=self.device)
                    mb = {k: v[rows] for k, v in batch.items()}
                    self.state, metrics = self.train_step(self.state, mb)
            host_sync(metrics)

        # 4. metrics -------------------------------------------------------
        self.global_step += 1
        out = {k: float(v) for k, v in metrics.items()}
        out.update(self.loop.env_metrics())
        out["rollout/reward_mean"] = float(traj.rewards.mean())
        out["rollout/env_steps"] = float(traj.num_steps * traj.num_envs)
        out.update({f"time/{k}": v for k, v in self.timers.consume().items()})
        out["time/step"] = time.perf_counter() - t_start
        out["perf/env_steps_per_s"] = out["rollout/env_steps"] / out["time/step"]

        if cfg.eval_interval and self.global_step % cfg.eval_interval == 0:
            out.update(self.evaluate())
        self.logger.log(out, self.global_step)
        if self.ckpt and self.global_step % cfg.save_interval == 0:
            self.ckpt.save(self.global_step, self.state)
        return out

    def evaluate(self) -> Dict[str, float]:
        """Deterministic-policy eval epoch (reference embodied_runner.py:193)."""
        if self.eval_loop is None:
            return {}
        self.eval_loop.reset()
        self.eval_loop.env_metrics()  # clear stale stats
        self.eval_loop.interact(
            self.state.params, self._generator, self.cfg.eval_steps,
            deterministic=True,
        )
        return {f"eval/{k}": v for k, v in self.eval_loop.env_metrics().items()}

    def run(self, max_steps: Optional[int] = None) -> List[Dict[str, float]]:
        n = max_steps or self.cfg.max_steps
        history = []
        while self.global_step < n:
            history.append(self.run_step())
        return history
