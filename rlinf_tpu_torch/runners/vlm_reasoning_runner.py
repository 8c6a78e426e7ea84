"""GRPO on vision-language reasoning: [image | question] -> graded free text.

Port of ``rlinf_tpu/runners/vlm_reasoning_runner.py`` (reference analog:
VLM GRPO e2e, reference tests/e2e_tests/ VLM configs). The loop of
the reasoning runner (rollout / reward / advantages / PPO), but the rollout
prefills a multimodal prefix (ViT patches + question tokens) through
``VLMReasoningModel.generate`` instead of a token-only engine, and the train
step teacher-forces through the same multimodal ``forward``, so behaviour
and training logprobs are the same computation (step-1 approx_kl ~ 0).

Each step samples ``rollout_batch_size`` examples with numpy
(``seed * 100003 + global_step``, the JAX runner's draw), repeats each
``group_size`` times, and runs one full-batch PPO step per epoch
(``_train_step(state, batch)``, which updates the params and the optimizer
state in place). Sampling seeds come from a CPU ``torch.Generator`` seeded
with ``seed + 1``; like the JAX runner's key it is not checkpointed, so a
resumed run samples anew from that seed. The run is on the card unless
``device`` says otherwise.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from rlinf_tpu_torch.algorithms import get_advantage_fn
from rlinf_tpu_torch.algorithms.rewards.qa_metrics import batch_vqa_rewards
from rlinf_tpu_torch.config import TrainerConfig
from rlinf_tpu_torch.data.datasets import VQADataset
from rlinf_tpu_torch.models.vlm import VLMReasoningModel
from rlinf_tpu_torch.training.learner import _grads, _to_device, _token_level_loss, optax_global_norm
from rlinf_tpu_torch.training.train_state import (
    TrainState, apply_updates, create_train_state, make_optimizer,
)
from rlinf_tpu_torch.utils.checkpoint import CheckpointManager
from rlinf_tpu_torch.utils.device import resolve_device
from rlinf_tpu_torch.utils.metrics import MetricLogger, rollout_metrics
from rlinf_tpu_torch.utils.sync import host_sync
from rlinf_tpu_torch.utils.timers import Timers


def initial_state(cfg: TrainerConfig, init_params, tx):
    """-> (state, checkpoint manager or None, global step): the TrainState of
    ``init_params(seed)``, replaced by the latest checkpoint under
    ``resume="auto"``."""
    state = create_train_state(lambda: init_params(cfg.runner.seed), tx)
    ckpt = CheckpointManager(cfg.runner.checkpoint_dir) if cfg.runner.checkpoint_dir else None
    if ckpt and cfg.runner.resume == "auto":
        restored, _, step = ckpt.restore(state)
        if restored is not None:
            return restored, ckpt, step
    return state, ckpt, 0


def apply_step(tx, state: TrainState, loss_fn):
    """One optimizer step on ``loss_fn(params) -> (loss, metrics)``, the
    params and the optimizer state updated in place -> (state, loss,
    metrics, grad norm before clipping)."""
    grads, loss, metrics = _grads(state.params, loss_fn)
    grad_norm = optax_global_norm(grads)
    updates, new_opt = tx.update(grads, state.opt_state, state.params)
    del grads
    apply_updates(state.params, updates)
    return TrainState(state.step + 1, state.params, new_opt), loss, metrics, grad_norm


class VLMReasoningRunner:
    def __init__(
        self,
        cfg: TrainerConfig,
        tokenizer,
        dataset: VQADataset,
        model: Optional[VLMReasoningModel] = None,
        *,
        reward_fn=None,
        init_params_override=None,
        device="cuda",
    ):
        """``init_params_override(seed)`` returns the initial params (the
        port's tree of tensors on ``device``) in place of a random init:
        an SFT'd model's, for one."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.tokenizer = tokenizer
        self.dataset = dataset
        self.model = model or VLMReasoningModel(vlm_cfg=cfg.model)
        self.reward_fn = reward_fn or batch_vqa_rewards
        self.timers = Timers()
        self.logger = MetricLogger(cfg.runner.log_dir)
        self.tx = make_optimizer(cfg.optimizer)
        self._generator = torch.Generator().manual_seed(cfg.runner.seed + 1)
        self.state, self.ckpt, self.global_step = initial_state(
            cfg, init_params_override or (lambda s: self.model.init(s, device=self.device)),
            self.tx)

    # ------------------------------------------------------------------
    def _train_step(self, state: TrainState, batch) -> tuple:
        """One PPO-clip step on the whole batch (images, prompt_ids,
        prompt_mask, response_ids, loss_mask, old_logprobs, advantages;
        numpy arrays or tensors) -> (state, metrics)."""
        batch = _to_device(batch, self.device)
        temp = self.cfg.sampling.temperature

        def loss_fn(params):
            lp, ent = self.model.forward(
                params, batch["images"], batch["prompt_ids"], batch["prompt_mask"],
                batch["response_ids"], batch["loss_mask"], temperature=temp,
            )
            global_valid = batch["loss_mask"].float().sum().clamp_min(1.0)
            return _token_level_loss(lp, ent, batch, self.cfg.loss, global_valid)

        state, loss, metrics, grad_norm = apply_step(self.tx, state, loss_fn)
        metrics = dict(metrics)
        metrics["actor/loss"] = loss
        metrics["actor/grad_norm"] = grad_norm
        return state, metrics

    def _sample_batch(self) -> List:
        n = self.cfg.runner.rollout_batch_size
        idx = np.random.default_rng(
            self.cfg.runner.seed * 100003 + self.global_step
        ).integers(0, len(self.dataset), n)
        return [self.dataset[int(i)] for i in idx]

    def _encode_prompts(self, examples):
        max_p = self.cfg.data.max_prompt_len
        ids = [self.tokenizer.encode(ex.question)[:max_p] for ex in examples]
        width = max(len(p) for p in ids)
        pad = self.cfg.sampling.pad_token_id
        # left-pad so generation starts right after the question
        out = np.full((len(ids), width), pad, np.int32)
        mask = np.zeros((len(ids), width), bool)
        for i, p in enumerate(ids):
            out[i, width - len(p):] = p
            mask[i, width - len(p):] = True
        return out, mask

    def run_step(self) -> Dict[str, float]:
        cfg = self.cfg
        step_start = time.perf_counter()
        G = cfg.algorithm.group_size
        dev = self.device

        examples = self._sample_batch()
        images = np.stack([VQADataset.load_image(ex) for ex in examples])
        prompt_ids, prompt_mask = self._encode_prompts(examples)
        # GRPO groups: repeat each example G times
        images_g = torch.as_tensor(np.repeat(images, G, axis=0), device=dev)
        ids_g = torch.as_tensor(np.repeat(prompt_ids, G, axis=0), device=dev)
        mask_g = torch.as_tensor(np.repeat(prompt_mask, G, axis=0), device=dev)
        answers_g = [ex.answers for ex in examples for _ in range(G)]

        with self.timers.scope("rollout"):
            out = self.model.generate(self.state.params, self._generator, images_g, ids_g,
                                      mask_g, cfg.sampling)
            resp_ids = out["response_ids"].cpu().numpy()
            resp_mask = out["response_mask"].cpu().numpy()
            resp_lp = out["response_logprobs"].cpu().numpy()

        with self.timers.scope("reward"):
            texts = [
                self.tokenizer.decode([int(t) for t, m in zip(row, mrow) if m])
                for row, mrow in zip(resp_ids, resp_mask)
            ]
            rewards = np.asarray(self.reward_fn(texts, answers_g), np.float32)

        adv_fn = get_advantage_fn(cfg.algorithm.adv_type)
        adv, _ = adv_fn(
            rewards=torch.as_tensor(rewards),
            loss_mask=torch.as_tensor(resp_mask.T),
            group_size=G,
            normalize_advantages=cfg.algorithm.normalize_advantages,
        )
        adv = adv.numpy().T

        batch = {
            "images": images_g,
            "prompt_ids": ids_g,
            "prompt_mask": mask_g,
            "response_ids": torch.as_tensor(resp_ids, device=dev),
            "loss_mask": torch.as_tensor(resp_mask, device=dev),
            "old_logprobs": torch.as_tensor(np.where(resp_mask, resp_lp, 0.0).astype(np.float32),
                                            device=dev),
            "advantages": torch.as_tensor(np.ascontiguousarray(adv, np.float32), device=dev),
        }
        with self.timers.scope("training"):
            metrics = {}
            for _ in range(cfg.runner.num_epochs):
                self.state, metrics = self._train_step(self.state, batch)
            host_sync(metrics)

        self.global_step += 1
        out_m = {k: float(v) for k, v in metrics.items()}
        out_m.update(rollout_metrics(
            resp_mask.sum(1), rewards, cfg.sampling.max_new_tokens
        ))
        times = self.timers.consume()
        out_m.update({f"time/{k}": v for k, v in times.items()})
        out_m["time/step"] = time.perf_counter() - step_start
        self.logger.log(out_m, self.global_step)
        if self.ckpt and self.global_step % cfg.runner.save_interval == 0:
            self.ckpt.save(self.global_step, self.state)
        return out_m

    def run(self, max_steps: Optional[int] = None) -> List[Dict[str, float]]:
        n = max_steps or self.cfg.runner.max_steps
        history = []
        while self.global_step < n:
            history.append(self.run_step())
        return history
