"""AgentLightning-style runner: train on rollouts produced by a USER'S OWN
agent framework.

Port of ``rlinf_tpu/runners/agentlightning_runner.py``. Reference analog:
AgentLightningRLinfRunner (reference rlinf/runners/agentlightning_runner.py:70):
the external agent framework (any Python program) drives multi-turn LLM
calls against a served endpoint; the framework records the resulting spans
as triplets and the standard GRPO pipeline trains on them. Here each task
gets an ``ExternalAgentAdapter`` whose ``complete(prompt) -> text``
callable is backed by the static rollout engine; the agent program runs
arbitrarily (tools, branching, retries), every completion's tokens are
span-recorded with loss masks, and the adapter's assembled
``AgentRollout``s feed the same GRPO update as the in-process agent loop.

Agent program contract:
    def agent_fn(complete, task) -> Optional[float]
``complete`` is the LLM endpoint; the return value is the trajectory reward
(AgentLightning's span reward). Returning None falls back to
``reward_fn(final_texts, answers)`` — the ``reward_fillna_value`` path.

Randomness: one ``torch.Generator`` seeded from ``cfg.runner.seed`` feeds
every completion of every task in turn (the JAX runner splits a key per
task).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from rlinf_tpu_torch.agents.agent_loop import build_agent_train_batch
from rlinf_tpu_torch.agents.recipes import ExternalAgentAdapter
from rlinf_tpu_torch.algorithms import get_advantage_fn
from rlinf_tpu_torch.config import TrainerConfig, resolve_attn_impl
from rlinf_tpu_torch.data.datasets import PromptDataset, StatefulBatchIterator
from rlinf_tpu_torch.models.llm import init_params
from rlinf_tpu_torch.rollout.engine import RolloutEngine
from rlinf_tpu_torch.training.learner import make_policy_train_step
from rlinf_tpu_torch.training.train_state import create_train_state, make_optimizer
from rlinf_tpu_torch.utils.checkpoint import CheckpointManager
from rlinf_tpu_torch.utils.device import resolve_device
from rlinf_tpu_torch.utils.metrics import MetricLogger
from rlinf_tpu_torch.utils.sync import host_sync
from rlinf_tpu_torch.utils.timers import Timers


class AgentLightningRunner:
    """``init_params_override(seed)`` returns the initial params in place of
    a random init."""

    def __init__(
        self,
        cfg: TrainerConfig,
        tokenizer,
        dataset: PromptDataset,
        agent_fn: Callable,
        *,
        reward_fn: Optional[Callable] = None,
        reward_fillna_value: float = 0.0,
        max_total_len: int = 2048,
        init_params_override=None,
        device="cuda",
    ):
        dev = resolve_device(device)
        cfg = dataclasses.replace(cfg, attn_impl=resolve_attn_impl(cfg, dev))
        self.cfg = cfg
        self.device = dev
        self.tokenizer = tokenizer
        self.agent_fn = agent_fn
        self.reward_fn = reward_fn
        self.reward_fillna_value = reward_fillna_value
        self.max_total_len = max_total_len
        self.timers = Timers()
        self.logger = MetricLogger(cfg.runner.log_dir)

        self.engine = RolloutEngine(
            cfg.model, cfg.sampling, attn_impl=cfg.attn_impl, device=dev
        )
        self.tx = make_optimizer(cfg.optimizer)
        self.train_step = make_policy_train_step(
            cfg.model, cfg.loss, self.tx,
            num_microbatches=cfg.num_microbatches,
            remat=cfg.remat, attn_impl=cfg.attn_impl, device=dev,
        )
        seed = cfg.runner.seed
        init_fn = init_params_override or (lambda s: init_params(cfg.model, s, device=dev))
        self._sample_gen = torch.Generator().manual_seed(seed)
        self.state = create_train_state(lambda: init_fn(seed), self.tx)
        self.iterator = StatefulBatchIterator(
            dataset, cfg.runner.rollout_batch_size, seed=seed
        )
        self.ckpt = (
            CheckpointManager(cfg.runner.checkpoint_dir)
            if cfg.runner.checkpoint_dir else None
        )
        self.global_step = 0

    def run_step(self) -> Dict[str, float]:
        cfg = self.cfg
        t0 = time.perf_counter()
        examples = self.iterator.next_batch()
        group = cfg.algorithm.group_size
        tasks = [ex for ex in examples for _ in range(group)]

        rollouts, agent_rewards = [], []
        with self.timers.scope("rollout"):
            for task in tasks:
                adapter = ExternalAgentAdapter(
                    self.engine, self.tokenizer, self.state.params,
                    self._sample_gen, max_total_len=self.max_total_len,
                )
                reward = self.agent_fn(adapter.complete, task)
                rollouts.append(adapter.finish())
                agent_rewards.append(reward)

        with self.timers.scope("reward"):
            rewards = np.full(len(tasks), np.nan, np.float32)
            for i, r in enumerate(agent_rewards):
                if r is not None:
                    rewards[i] = float(r)
            missing = np.isnan(rewards)
            if missing.any():
                if self.reward_fn is not None:
                    fallback = np.asarray(self.reward_fn(
                        [rollouts[i].final_text
                         for i in np.nonzero(missing)[0]],
                        [tasks[i].answer for i in np.nonzero(missing)[0]],
                    ), np.float32)
                    rewards[missing] = fallback
                else:
                    rewards[missing] = self.reward_fillna_value

        adv_fn = get_advantage_fn(cfg.algorithm.adv_type)
        adv, _ = adv_fn(
            rewards=torch.as_tensor(rewards),
            loss_mask=torch.ones((1, len(rollouts)), dtype=torch.float32),
            group_size=group,
            normalize_advantages=cfg.algorithm.normalize_advantages,
        )
        seq_adv = adv[0].numpy()

        batch = build_agent_train_batch(
            rollouts, seq_adv, pad_id=cfg.sampling.pad_token_id
        )
        batch_dict = {k: torch.as_tensor(v).to(self.device)
                      for k, v in batch.to_dict().items()}
        with self.timers.scope("training"):
            self.state, metrics = self.train_step(self.state, batch_dict)
            host_sync(metrics)

        self.global_step += 1
        out = {k: float(v) for k, v in metrics.items()}
        out["agent/reward_mean"] = float(rewards.mean())
        out["agent/external_reward_rate"] = float(
            np.mean([r is not None for r in agent_rewards]))
        out["agent/llm_calls_mean"] = float(
            np.mean([r.num_turns for r in rollouts]))
        out.update({f"time/{k}": v for k, v in self.timers.consume().items()})
        out["time/step"] = time.perf_counter() - t0
        self.logger.log(out, self.global_step)
        if self.ckpt and self.global_step % cfg.runner.save_interval == 0:
            self.ckpt.save(self.global_step, self.state,
                           extra={"dataloader": self.iterator.state_dict()})
        return out

    def run(self, max_steps: Optional[int] = None) -> List[Dict[str, float]]:
        n = max_steps or self.cfg.runner.max_steps
        history = []
        while self.global_step < n:
            history.append(self.run_step())
        return history
