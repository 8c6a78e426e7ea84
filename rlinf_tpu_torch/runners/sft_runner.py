"""SFT training loop.

Port of ``rlinf_tpu/runners/sft_runner.py``: (prompt, answer) pairs become
the RL training batch layout with the loss on the answer tokens only, then
``make_sft_train_step`` runs on them, with the metrics, checkpoint and
auto-resume plumbing of the reasoning runner. The run is on the card unless
``device`` says otherwise.

Under ``mesh=`` (every rank runs the same script) the train state holds
this rank's blocks under ``partition_rules()`` (the JAX package's sharded
state, ``create_train_state(mesh=)``), every rank builds the whole batch
and each step keeps its rows; the checkpoints hold the single-card layout
and the mesh's first rank writes the metrics.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch.distributed as dist

from rlinf_tpu_torch.config import TrainerConfig, resolve_attn_impl
from rlinf_tpu_torch.data.datasets import PromptDataset, StatefulBatchIterator
from rlinf_tpu_torch.models.llm import init_params, model as M
from rlinf_tpu_torch.training.sft import make_sft_train_step
from rlinf_tpu_torch.training.train_state import create_train_state, make_optimizer
from rlinf_tpu_torch.utils.checkpoint import CheckpointManager
from rlinf_tpu_torch.utils.device import resolve_device
from rlinf_tpu_torch.utils.metrics import MetricLogger
from rlinf_tpu_torch.utils.sync import host_sync


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class SFTRunner:
    def __init__(
        self,
        cfg: TrainerConfig,
        tokenizer,
        dataset: PromptDataset,
        *,
        init_params_override=None,
        mesh=None,
        seq_bucket: int = 64,
        device="cuda",
    ):
        """``init_params_override(seed)`` returns the initial params (the
        port's dict of tensors on ``device``) in place of a random init."""
        dev = resolve_device(device)
        cfg = dataclasses.replace(cfg, attn_impl=resolve_attn_impl(cfg, dev))
        M.check_mesh(cfg.model, mesh)
        self.cfg = cfg
        self.device = dev
        self.mesh = mesh
        self.tokenizer = tokenizer
        self.seq_bucket = seq_bucket
        writes = mesh is None or (dist.get_rank() if dist.is_initialized() else 0) == mesh.ranks[0]
        self.logger = (MetricLogger(cfg.runner.log_dir) if writes
                       else MetricLogger(None, print_every=0))
        self.tx = make_optimizer(cfg.optimizer)
        self.train_step = make_sft_train_step(
            cfg.model, self.tx,
            num_microbatches=cfg.num_microbatches,
            remat=cfg.remat, attn_impl=cfg.attn_impl,
            logprob_chunk_size=cfg.loss.logprob_chunk_size, mesh=mesh, device=dev,
        )
        seed = cfg.runner.seed
        init_fn = init_params_override or (lambda s: init_params(cfg.model, s, device=dev))
        self.state = create_train_state(lambda: init_fn(seed), self.tx, mesh=mesh,
                                        partition_rules=M.partition_rules())
        self.iterator = StatefulBatchIterator(dataset, cfg.runner.rollout_batch_size, seed=seed)
        layout = None
        if mesh is not None:
            from rlinf_tpu_torch.training.sharded_step import model_layout

            layout = model_layout(cfg.model, mesh, M.partition_rules())
        self.layout = layout
        self.ckpt = (
            CheckpointManager(cfg.runner.checkpoint_dir, layout=layout)
            if cfg.runner.checkpoint_dir else None
        )
        self.global_step = 0
        if self.ckpt and cfg.runner.resume == "auto":
            state, extra, step = self.ckpt.restore(self.state)
            if state is not None:
                self.state = state
                self.global_step = step
                if extra and "dataloader" in extra:
                    self.iterator.load_state_dict(extra["dataloader"])

    def _build_batch(self, examples) -> Dict[str, np.ndarray]:
        """Rows of prompt (cut to ``max_prompt_len``) + answer (+ eos where the
        tokenizer has one), right-padded to T rounded up to ``seq_bucket``;
        the loss covers the answer, from the last prompt token on."""
        max_p = self.cfg.data.max_prompt_len
        rows = []
        for ex in examples:
            p = self.tokenizer.encode(ex.prompt)[:max_p]
            r = self.tokenizer.encode(ex.answer)
            if getattr(self.tokenizer, "eos_id", None) is not None:
                r = r + [self.tokenizer.eos_id]
            rows.append((p, r))
        T = _round_up(max(len(p) + len(r) for p, r in rows), self.seq_bucket)
        B = len(rows)
        pad = self.cfg.sampling.pad_token_id
        input_ids = np.full((B, T), pad, np.int32)
        attention_mask = np.zeros((B, T), bool)
        target_ids = np.full((B, T), pad, np.int32)
        loss_mask = np.zeros((B, T), bool)
        for i, (p, r) in enumerate(rows):
            seq = np.asarray(p + r, np.int32)[:T]
            n, np_ = len(seq), len(p)
            input_ids[i, :n] = seq
            attention_mask[i, :n] = True
            target_ids[i, : n - 1] = seq[1:]
            loss_mask[i, np_ - 1 : n - 1] = True
        return {"input_ids": input_ids, "attention_mask": attention_mask,
                "target_ids": target_ids, "loss_mask": loss_mask}

    def run_step(self) -> Dict[str, float]:
        t0 = time.perf_counter()
        batch = self._build_batch(self.iterator.next_batch())
        self.state, metrics = self.train_step(self.state, batch)
        host_sync(metrics)
        self.global_step += 1
        out = {k: float(v) for k, v in metrics.items()}
        out["time/step"] = time.perf_counter() - t0
        self.logger.log(out, self.global_step)
        if self.ckpt and self.global_step % self.cfg.runner.save_interval == 0:
            self.save_checkpoint()
        return out

    def save_checkpoint(self):
        """The state and the dataloader position, at ``global_step``."""
        self.ckpt.save(self.global_step, self.state,
                       extra={"dataloader": self.iterator.state_dict()})

    def run(self, max_steps: Optional[int] = None) -> List[Dict[str, float]]:
        n = max_steps or self.cfg.runner.max_steps
        history = []
        while self.global_step < n:
            history.append(self.run_step())
        return history
