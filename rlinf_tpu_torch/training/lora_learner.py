"""LoRA policy training: the PPO/GRPO loss differentiated with respect to the
low-rank adapters only.

Port of ``rlinf_tpu/training/lora_learner.py``. The base params are an
argument of the step that is read and never written; the optimizer state
covers the adapter tree alone. Each microbatch merges the adapters into the
base inside its loss (``merge_lora``), as the JAX package does, so the
merged weights are rebuilt per microbatch and the gradients flow through
the merge to ``a`` and ``b``. A frozen lm head (no "lm_head" target) takes
no weight-gradient product in K6's wrapper.

Under ``mesh=`` the base params are this rank's blocks and the adapters
are whole on every rank; each rank keeps its rows of the global batch
(``training/sharded_step.py``), merges per rank on its blocks
(``merge_lora(layout=)``) and gets the gradient of the whole adapters
from its blocks: summed over the batch axes (and context, under ring
attention), and over the tensor axis for a target whose block the tensor
axis cuts (the ranks then hold different rows or columns of ``a @ b``, or
partial sums of its gradient); a target the tensor axis leaves whole has
the same gradient on every tensor rank already.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from rlinf_tpu_torch.models.llm.config import LLMConfig
from rlinf_tpu_torch.models.llm.lora import LoRAConfig, merge_lora
from rlinf_tpu_torch.models.llm import model as M
from rlinf_tpu_torch.ops.cuda.geometry import check_on_card
from rlinf_tpu_torch.parallel import collectives as C
from rlinf_tpu_torch.parallel.mesh import AxisNames as Ax
from rlinf_tpu_torch.parallel.sharding import sharded_axes
from rlinf_tpu_torch.training.learner import (
    PolicyLossConfig,
    _grads,
    _microbatches,
    _to_device,
    microbatch_loss_with_moe,
    optax_global_norm,
)
from rlinf_tpu_torch.training.sharded_step import MeshStep
from rlinf_tpu_torch.training.train_state import (
    Optimizer, TrainState, apply_updates, tree_map,
)
from rlinf_tpu_torch.utils.device import resolve_device


def make_lora_policy_train_step(
    cfg: LLMConfig,
    loss_cfg: PolicyLossConfig,
    tx: Optimizer,
    lora_cfg: LoRAConfig,
    *,
    num_microbatches: int = 1,
    remat=True,
    attn_impl: str = "xla",
    mesh=None,
    device="cuda",
) -> Callable[[TrainState, Any, Dict[str, Any]], Tuple[TrainState, Dict]]:
    """``(lora_state, base_params, batch) -> (lora_state, metrics)``.

    ``lora_state.params`` is the adapter tree, updated in place with its
    optimizer state; ``base_params`` stays as it is. The batch is
    ``make_policy_train_step``'s; metrics add ``actor/loss`` (summed over
    microbatches, each globally normalized) and ``actor/grad_norm`` of the
    adapters' gradients, the others are averaged over microbatches."""
    dev = resolve_device(device)
    ms = MeshStep(cfg, mesh, attn_impl=attn_impl)
    check_on_card(M.local_config(cfg, mesh), dev, attn_impl=attn_impl)

    def loss_of(base_params, mb, global_valid):
        return lambda lora: microbatch_loss_with_moe(
            merge_lora(base_params, lora, lora_cfg, ms.layout), cfg, loss_cfg, mb, global_valid,
            attn_impl=attn_impl, remat=remat)

    def reduce_grads(grads):
        """The whole adapters' gradient from this rank's (see the module
        docstring)."""
        batch_axes = Ax.BATCH + ((Ax.CONTEXT,) if ms.ring else ())
        targets = [(grads["blocks"][n], f"blocks/{n}") for n in grads["blocks"]]
        if "lm_head" in grads:
            targets.append((grads["lm_head"], "lm_head"))
        for ab, path in targets:
            tp = (Ax.TENSOR,) if Ax.TENSOR in sharded_axes(ms.layout.specs[path]) else ()
            group = mesh.get_group(batch_axes + tp)
            for g in ab.values():
                C.all_reduce_(g, "sum", group)
        return grads

    def train_step(state: TrainState, base_params, batch: Dict[str, Any]):
        with ms.active():
            return _train_step(state, base_params, batch)

    def _train_step(state: TrainState, base_params, batch: Dict[str, Any]):
        batch = _to_device(ms.rows(batch, num_microbatches), dev)
        global_valid = ms.valid(batch["loss_mask"].float().sum()).clamp_min(1.0)
        grads, loss, metrics_list = None, torch.zeros((), device=dev), []
        for mb in _microbatches(batch, num_microbatches):
            g, mb_loss, mb_metrics = _grads(state.params, loss_of(base_params, mb, global_valid))
            if num_microbatches > 1:    # summed in f32, as the JAX package's scan
                g = tree_map(lambda x: x.float(), g)
            grads = g if grads is None else tree_map(torch.add, grads, g)
            loss = loss + mb_loss
            metrics_list.append(mb_metrics)
        metrics = {k: torch.stack([m[k] for m in metrics_list]).mean() for k in metrics_list[0]}
        if mesh is not None:
            grads = reduce_grads(grads)
        grad_norm = optax_global_norm(grads)
        updates, new_opt_state = tx.update(grads, state.opt_state, state.params)
        apply_updates(state.params, updates)
        metrics["actor/loss"] = loss
        metrics = ms.metrics(metrics, M.context_chunks(batch, attn_impl)["loss_mask"].sum())
        metrics["actor/grad_norm"] = grad_norm
        return TrainState(state.step + 1, state.params, new_opt_state), metrics

    return train_step
