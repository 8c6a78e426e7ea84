"""Agentic RL driver: multi-turn tool-use rollouts + GRPO updates.

Port of ``rlinf_tpu/runners/agent_runner.py``. The AgentLoop round-batches
conversations through the static rollout engine and the policy train step
consumes the assembled per-turn-masked batches. Randomness: one seeded
``torch.Generator`` for the rollout's sampling (not JAX's threefry).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from rlinf_tpu_torch.agents.agent_loop import AgentLoop, AgentLoopConfig, build_agent_train_batch
from rlinf_tpu_torch.agents.tools import ToolRegistry
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


class AgentRunner:
    """reward_fn(final_texts, answers) -> list[float] scores the full
    multi-turn trajectory (tool outputs included in the text).
    ``init_params_override(seed)`` returns the initial params in place of a
    random init."""

    def __init__(
        self,
        cfg: TrainerConfig,
        tokenizer,
        dataset: PromptDataset,
        tools: ToolRegistry,
        reward_fn: Callable,
        *,
        loop_cfg: AgentLoopConfig = AgentLoopConfig(),
        init_params_override=None,
        device="cuda",
    ):
        dev = resolve_device(device)
        cfg = dataclasses.replace(cfg, attn_impl=resolve_attn_impl(cfg, dev))
        self.cfg = cfg
        self.device = dev
        self.tokenizer = tokenizer
        self.reward_fn = reward_fn
        self.timers = Timers()
        self.logger = MetricLogger(cfg.runner.log_dir)

        self.engine = RolloutEngine(cfg.model, cfg.sampling, attn_impl=cfg.attn_impl,
                                    device=dev)
        self.loop = AgentLoop(self.engine, tokenizer, tools, loop_cfg)

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
        prompts = [
            self.tokenizer.encode(ex.prompt)[: cfg.data.max_prompt_len]
            for ex in examples for _ in range(group)
        ]
        answers = [ex.answer for ex in examples for _ in range(group)]

        with self.timers.scope("rollout"):
            rollouts = self.loop.run(self.state.params, prompts, self._sample_gen)

        with self.timers.scope("reward"):
            rewards = np.asarray(
                self.reward_fn([r.final_text for r in rollouts], answers),
                np.float32,
            )

        # GRPO over final trajectory rewards; per-sequence advantage broadcast
        # to model tokens only.
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
        out["agent/num_turns_mean"] = float(
            np.mean([r.num_turns for r in rollouts])
        )
        out["agent/tool_calls_mean"] = float(
            np.mean([r.num_tool_calls for r in rollouts])
        )
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
