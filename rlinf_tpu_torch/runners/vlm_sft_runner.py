"""VLM SFT: teacher-forced NLL on [image | question] -> answer text.

Port of ``rlinf_tpu/runners/vlm_sft_runner.py`` (reference analog: the VLM
SFT worker, rlinf/workers/sft/megatron_vlm_sft_worker.py): supervised
finetuning of a vision-language model on (image, question, answer)
triples. It reuses ``VLMReasoningModel.forward``; the loss is the answer
tokens' cross-entropy (the question and image prefix masked out), so an
SFT'd model drops straight into ``VLMReasoningRunner`` for GRPO. Batches
are drawn with numpy (``seed * 9176 + global_step``, the JAX runner's
draw); nothing else is random. The run is on the card unless ``device``
says otherwise.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from rlinf_tpu_torch.config import TrainerConfig
from rlinf_tpu_torch.data.datasets import VQADataset
from rlinf_tpu_torch.models.vlm import VLMReasoningModel
from rlinf_tpu_torch.runners.vlm_reasoning_runner import apply_step, initial_state
from rlinf_tpu_torch.training.learner import _to_device
from rlinf_tpu_torch.training.train_state import TrainState, make_optimizer
from rlinf_tpu_torch.utils.device import resolve_device
from rlinf_tpu_torch.utils.metrics import MetricLogger
from rlinf_tpu_torch.utils.sync import host_sync


class VLMSFTRunner:
    def __init__(
        self,
        cfg: TrainerConfig,
        tokenizer,
        dataset: VQADataset,
        model: Optional[VLMReasoningModel] = None,
        *,
        init_params_override=None,
        device="cuda",
    ):
        """``init_params_override(seed)`` returns the initial params (the
        port's tree of tensors on ``device``) in place of a random init."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.tokenizer = tokenizer
        self.dataset = dataset
        self.model = model or VLMReasoningModel(vlm_cfg=cfg.model)
        self.logger = MetricLogger(cfg.runner.log_dir)
        self.tx = make_optimizer(cfg.optimizer)
        self.state, self.ckpt, self.global_step = initial_state(
            cfg, init_params_override or (lambda s: self.model.init(s, device=self.device)),
            self.tx)

    # ------------------------------------------------------------------
    def _train_step(self, state: TrainState, batch) -> tuple:
        """One step of the answer tokens' mean NLL -> (state, metrics)."""
        batch = _to_device(batch, self.device)

        def loss_fn(params):
            lp, _ = self.model.forward(
                params, batch["images"], batch["prompt_ids"], batch["prompt_mask"],
                batch["response_ids"], batch["response_mask"],
            )
            mask = batch["loss_mask"].float()
            valid = mask.sum().clamp_min(1.0)
            return -(lp * mask).sum() / valid, {"sft/valid_tokens": valid}

        state, loss, aux, grad_norm = apply_step(self.tx, state, loss_fn)
        metrics = dict(aux)
        metrics["sft/loss"] = loss
        metrics["sft/ppl"] = torch.exp(loss)
        metrics["sft/grad_norm"] = grad_norm
        return state, metrics

    def _build_batch(self, examples) -> Dict[str, torch.Tensor]:
        """Fixed-width multimodal SFT batch on the runner's device: prompts
        left-padded, answers (+ eos where the tokenizer has one)
        right-padded; the loss on the answer."""
        tok = self.tokenizer
        max_p = self.cfg.data.max_prompt_len
        images = np.stack([VQADataset.load_image(ex) for ex in examples])
        prompts = [tok.encode(ex.question)[:max_p] for ex in examples]
        eos = [tok.eos_id] if getattr(tok, "eos_id", None) is not None else []
        answers = [tok.encode(ex.answers[0]) + eos for ex in examples]
        B = len(examples)
        P = max(len(p) for p in prompts)
        N = max(len(a) for a in answers)
        pad = self.cfg.sampling.pad_token_id
        prompt_ids = np.full((B, P), pad, np.int32)
        prompt_mask = np.zeros((B, P), bool)
        resp_ids = np.full((B, N), pad, np.int32)
        resp_mask = np.zeros((B, N), bool)
        for i, (p, a) in enumerate(zip(prompts, answers)):
            prompt_ids[i, P - len(p):] = p       # left-pad prompts
            prompt_mask[i, P - len(p):] = True
            resp_ids[i, :len(a)] = a
            resp_mask[i, :len(a)] = True
        return _to_device({
            "images": images,
            "prompt_ids": prompt_ids,
            "prompt_mask": prompt_mask,
            "response_ids": resp_ids,
            "response_mask": resp_mask,
            "loss_mask": resp_mask,
        }, self.device)

    def run_step(self) -> Dict[str, float]:
        t0 = time.perf_counter()
        n = self.cfg.runner.rollout_batch_size
        rng = np.random.default_rng(self.cfg.runner.seed * 9176 + self.global_step)
        idx = rng.integers(0, len(self.dataset), n)
        batch = self._build_batch([self.dataset[int(i)] for i in idx])
        self.state, metrics = self._train_step(self.state, batch)
        host_sync(metrics)
        self.global_step += 1
        out = {k: float(v) for k, v in metrics.items()}
        out["time/step"] = time.perf_counter() - t0
        self.logger.log(out, self.global_step)
        if self.ckpt and self.global_step % self.cfg.runner.save_interval == 0:
            self.ckpt.save(self.global_step, self.state)
        return out

    def run(self, max_steps: Optional[int] = None) -> List[Dict[str, float]]:
        n = max_steps or self.cfg.runner.max_steps
        history = []
        while self.global_step < n:
            history.append(self.run_step())
        return history
