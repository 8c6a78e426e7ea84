"""Supervised fine-tuning train step for the LLM.

Port of ``rlinf_tpu/training/sft.py``: a token-mean NLL over ``loss_mask``
on the RL training batch layout, with the count of valid tokens taken over
the whole batch, so that accumulation over microbatches equals one big
batch. The forward goes through ``forward_hidden`` and
``linear_logprobs_and_entropy``: on the card K1 (and K7/K8 in the
backward), K5 and K6.

Under ``mesh=`` the state holds this rank's blocks and each step keeps its
rows of the global batch, reducing across the mesh as the policy train
step does (``training/sharded_step.py``); the loss is the sum over the
ranks of their token sums over the global count.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from rlinf_tpu_torch.models.llm import model as M
from rlinf_tpu_torch.models.llm.config import LLMConfig
from rlinf_tpu_torch.ops.cuda.geometry import check_on_card
from rlinf_tpu_torch.ops.logprobs import linear_logprobs_and_entropy
from rlinf_tpu_torch.parallel import collectives as C
from rlinf_tpu_torch.training.learner import (
    _grads, _microbatches, _to_device, optax_global_norm,
)
from rlinf_tpu_torch.training.sharded_step import MeshStep
from rlinf_tpu_torch.training.train_state import Optimizer, TrainState, apply_updates, tree_map
from rlinf_tpu_torch.utils.device import resolve_device


def make_sft_train_step(
    cfg: LLMConfig,
    tx: Optimizer,
    *,
    num_microbatches: int = 1,
    remat=True,
    attn_impl: str = "xla",
    logprob_chunk_size: int = 512,
    mesh=None,
    device="cuda",
) -> Callable[[TrainState, Dict[str, Any]], Tuple[TrainState, Dict]]:
    """``(state, batch) -> (state, metrics)``; the batch holds input_ids,
    attention_mask, target_ids and loss_mask ([B, T], B divisible by
    num_microbatches). The params and the optimizer state are updated in
    place. Metrics: ``sft/loss``, ``sft/ppl`` (exp of the loss clamped at
    20), ``sft/grad_norm`` and ``sft/valid_tokens``."""
    dev = resolve_device(device)
    ms = MeshStep(cfg, mesh, attn_impl=attn_impl)
    check_on_card(M.local_config(cfg, mesh), dev, attn_impl=attn_impl)

    def mb_loss(mb, global_valid):
        def fn(params):
            hidden, _ = M.forward_hidden(
                params, cfg, mb["input_ids"], attention_mask=mb["attention_mask"],
                attn_impl=attn_impl, remat=remat,
            )
            tok = M.context_chunks(mb, attn_impl)
            lp, _ = linear_logprobs_and_entropy(
                params, cfg, hidden, tok["target_ids"], chunk_size=logprob_chunk_size,
            )
            return -(lp * tok["loss_mask"].float()).sum() / global_valid, {}
        return fn

    def train_step(state: TrainState, batch: Dict[str, Any]):
        with ms.active():
            return _train_step(state, batch)

    def _train_step(state: TrainState, batch: Dict[str, Any]):
        batch = _to_device(ms.rows(batch, num_microbatches), dev)
        global_valid = ms.valid(batch["loss_mask"].float().sum()).clamp_min(1.0)
        grads, loss = None, torch.zeros((), device=dev)
        for mb in _microbatches(batch, num_microbatches):
            g, mb_loss_value, _ = _grads(state.params, mb_loss(mb, global_valid))
            if num_microbatches > 1:    # summed in f32, as the JAX package's scan
                g = tree_map(lambda x: x.float(), g)
            grads = g if grads is None else tree_map(torch.add, grads, g)
            loss = loss + mb_loss_value
            del g
        updates, new_opt, grad_norm = ms.update(tx, grads, state, optax_global_norm)
        del grads
        apply_updates(state.params, updates)
        if mesh is not None:
            loss = C.all_reduce_(loss.clone(), "sum", ms.batch_group)
        metrics = {
            "sft/loss": loss,
            "sft/ppl": torch.exp(torch.clamp_max(loss, 20.0)),
            "sft/grad_norm": grad_norm,
            "sft/valid_tokens": global_valid,
        }
        return TrainState(state.step + 1, state.params, new_opt), metrics

    return train_step
