"""Policy update and logprob-recompute steps for LLM RL.

Port of ``rlinf_tpu/training/learner.py``: the PPO-clip train step with
gradient accumulation over microbatches, the split grad/apply form, and the
forward-only logprob recompute. Loss normalization is the JAX package's:
each microbatch's per-token losses are summed and divided by the GLOBAL
count of valid tokens, so accumulation over microbatches equals one big
batch.

Where the JAX package jits one function that donates the state, the port
runs eagerly and updates the params and the optimizer state in place.
The MoE auxiliary loss and ``make_actor_critic_train_step`` come with
their slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from rlinf_tpu_torch.algorithms.losses import (
    compute_decoupled_ppo_actor_loss,
    compute_ppo_actor_loss,
)
from rlinf_tpu_torch.algorithms.utils import kl_penalty
from rlinf_tpu_torch.models.llm import model as M
from rlinf_tpu_torch.models.llm.config import LLMConfig
from rlinf_tpu_torch.ops.cuda.geometry import check_on_card
from rlinf_tpu_torch.ops.logprobs import linear_logprobs_and_entropy
from rlinf_tpu_torch.training.train_state import (
    Optimizer, TrainState, apply_updates, tree_leaves, tree_map,
)
from rlinf_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class PolicyLossConfig:
    """The JAX package's loss block, same fields and defaults."""

    clip_ratio_low: float = 0.2
    clip_ratio_high: float = 0.2
    clip_ratio_c: Optional[float] = None
    entropy_bonus: float = 0.0
    kl_beta: float = 0.0
    kl_penalty_type: str = "low_var_kl"
    loss_agg: str = "token-mean"
    logprob_chunk_size: int = 512
    #: >0 enables dynamic token-budget microbatching
    max_tokens_per_mb: int = 0
    #: "ppo" | "decoupled" (reads batch keys ``versions``, optional
    #: ``proximal_logprobs`` and ``current_version``)
    loss_type: str = "ppo"


def _token_level_loss(
    lp: torch.Tensor,
    entropy: torch.Tensor,
    batch: Dict[str, torch.Tensor],
    loss_cfg: PolicyLossConfig,
    global_valid_tokens: torch.Tensor,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Summed (not averaged) token loss divided by the global token count."""
    mask = batch["loss_mask"]
    mask_f = mask.float()
    sum_agg = lambda v, m, *_: (v * m.float()).sum()
    if loss_cfg.loss_type == "decoupled":
        loss_sum, metrics = compute_decoupled_ppo_actor_loss(
            logprobs=lp,
            old_logprobs=batch["old_logprobs"],
            advantages=batch["advantages"],
            loss_mask=mask,
            clip_ratio_low=loss_cfg.clip_ratio_low,
            clip_ratio_high=loss_cfg.clip_ratio_high,
            clip_ratio_c=loss_cfg.clip_ratio_c,
            proximal_logprobs=batch.get("proximal_logprobs"),
            versions=batch.get("versions"),
            # stored per row so minibatch indexing works; all rows equal
            current_version=(
                batch["current_version"].max() if "current_version" in batch else None),
            loss_agg_func=sum_agg,
        )
    else:
        loss_sum, metrics = compute_ppo_actor_loss(
            logprobs=lp,
            old_logprobs=batch["old_logprobs"],
            advantages=batch["advantages"],
            loss_mask=mask,
            clip_ratio_low=loss_cfg.clip_ratio_low,
            clip_ratio_high=loss_cfg.clip_ratio_high,
            clip_ratio_c=loss_cfg.clip_ratio_c,
            loss_agg_func=sum_agg,
        )

    if loss_cfg.entropy_bonus > 0:
        loss_sum = loss_sum - loss_cfg.entropy_bonus * (entropy * mask_f).sum()
    if loss_cfg.kl_beta > 0 and "ref_logprobs" in batch:
        kld = kl_penalty(lp, batch["ref_logprobs"], loss_cfg.kl_penalty_type)
        loss_sum = loss_sum + loss_cfg.kl_beta * (kld * mask_f).sum()
        metrics["actor/kl"] = (kld.detach() * mask_f).sum() / global_valid_tokens
    metrics["actor/entropy"] = (entropy.detach() * mask_f).sum() / global_valid_tokens
    return loss_sum / global_valid_tokens, metrics


def microbatch_loss_with_moe(
    params, cfg, loss_cfg, mb, global_valid_tokens, *, attn_impl, remat,
    unroll_layers=False,
):
    """Shared microbatch loss (PPO-clip + entropy/KL). The MoE auxiliary loss
    of the JAX package comes with the MoE slice (the port's model raises on
    MoE configs)."""
    if cfg.is_moe:
        raise NotImplementedError("MoE training comes with the port's MoE slice")
    hidden, _ = M.forward_hidden(
        params, cfg, mb["input_ids"],
        attention_mask=mb["attention_mask"],
        attn_impl=attn_impl, remat=remat, unroll_layers=unroll_layers,
    )
    lp, ent = linear_logprobs_and_entropy(
        params, cfg, hidden, mb["target_ids"], chunk_size=loss_cfg.logprob_chunk_size,
    )
    return _token_level_loss(lp, ent, mb, loss_cfg, global_valid_tokens)


def _to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v).to(device)
            for k, v in batch.items()}


def _grads(params, loss_fn) -> Tuple[Any, torch.Tensor, Dict]:
    """(grads tree in the params' dtypes, loss, metrics) of ``loss_fn(p)``.

    The params are differentiated through leaf aliases of their storage, so
    the caller's tensors are not marked as requiring grad."""
    alias = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(alias)
        leaves = tree_leaves(alias)
        flat = torch.autograd.grad(loss, leaves, allow_unused=True)
    flat = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, flat)]
    it = iter(flat)
    grads = tree_map(lambda _: next(it), alias)
    return grads, loss.detach(), {k: v.detach() for k, v in metrics.items()}


def optax_global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum((x.float() ** 2).sum() for x in tree_leaves(tree)))


def make_policy_train_step(
    cfg: LLMConfig,
    loss_cfg: PolicyLossConfig,
    tx: Optimizer,
    *,
    num_microbatches: int = 1,
    remat=True,
    attn_impl: str = "xla",
    mesh=None,
    unroll_layers: bool = False,
    grad_acc_dtype: Optional[torch.dtype] = None,
    device="cuda",
) -> Callable[[TrainState, Dict[str, Any]], Tuple[TrainState, Dict]]:
    """Build the train step ``(state, batch) -> (state, metrics)``.

    Batch dict (all [B, T], numpy arrays or tensors; B divisible by
    num_microbatches): input_ids int32, attention_mask bool, loss_mask bool
    (True where the NEXT token is a response token), target_ids int32,
    old_logprobs fp32, advantages fp32, optional ref_logprobs fp32.

    grad_acc_dtype: dtype of the microbatch gradient accumulator (default
    f32). The params and the optimizer state in ``state`` are updated in
    place; the returned state holds the same tensors.
    """
    if mesh is not None:
        raise NotImplementedError("make_policy_train_step(mesh=...) comes with the parallel slice")
    dev = resolve_device(device)
    check_on_card(cfg, dev, attn_impl=attn_impl)
    acc_dt = grad_acc_dtype or torch.float32

    def loss_of(mb, global_valid):
        return lambda p: microbatch_loss_with_moe(
            p, cfg, loss_cfg, mb, global_valid,
            attn_impl=attn_impl, remat=remat, unroll_layers=unroll_layers)

    def train_step(state: TrainState, batch: Dict[str, Any]):
        batch = _to_device(batch, dev)
        global_valid = batch["loss_mask"].float().sum().clamp_min(1.0)
        if num_microbatches == 1:
            grads, loss, metrics = _grads(state.params, loss_of(batch, global_valid))
        else:
            mbs = [dict(zip(batch, vals)) for vals in
                   zip(*(v.chunk(num_microbatches) for v in batch.values()))]
            grads, loss, metrics_list = None, torch.zeros((), device=dev), []
            for mb in mbs:
                g, mb_loss, mb_metrics = _grads(state.params, loss_of(mb, global_valid))
                if grads is None:
                    grads = tree_map(lambda x: x.to(acc_dt), g)
                else:
                    tree_map(lambda a, x: a.add_(x.to(acc_dt)), grads, g)
                del g
                loss = loss + mb_loss
                metrics_list.append(mb_metrics)
            # sums are already globally normalized; metrics averaged over mbs
            metrics = {k: torch.stack([m[k] for m in metrics_list]).mean()
                       for k in metrics_list[0]}
        grad_norm = optax_global_norm(grads)
        updates, new_opt_state = tx.update(grads, state.opt_state, state.params)
        del grads
        apply_updates(state.params, updates)
        metrics = dict(metrics)
        metrics["actor/loss"] = loss
        metrics["actor/grad_norm"] = grad_norm
        return TrainState(state.step + 1, state.params, new_opt_state), metrics

    return train_step


def make_policy_grad_and_apply(
    cfg: LLMConfig,
    loss_cfg: PolicyLossConfig,
    tx: Optimizer,
    *,
    remat=True,
    attn_impl: str = "xla",
    acc_dtype: Optional[torch.dtype] = None,
    device="cuda",
):
    """Split train step for dynamic microbatching: ``grad_step`` adds one
    microbatch's gradient (normalized by the global token count) into an
    accumulator, ``apply_step`` performs one optimizer update, with
    gradients identical to the one-big-batch form."""
    dev = resolve_device(device)
    check_on_card(cfg, dev, attn_impl=attn_impl)

    def grad_step(params, acc_grads, mb, global_valid_tokens):
        mb = _to_device(mb, dev)
        gv = torch.as_tensor(global_valid_tokens, dtype=torch.float32, device=dev)
        g, loss, metrics = _grads(params, lambda p: microbatch_loss_with_moe(
            p, cfg, loss_cfg, mb, gv, attn_impl=attn_impl, remat=remat))
        tree_map(lambda a, x: a.add_(x.to(a.dtype)), acc_grads, g)
        return acc_grads, loss, metrics

    def apply_step(state: TrainState, grads):
        grad_norm = optax_global_norm(grads)
        updates, new_opt = tx.update(grads, state.opt_state, state.params)
        apply_updates(state.params, updates)
        return TrainState(state.step + 1, state.params, new_opt), grad_norm

    def zero_grads(params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dtype or torch.float32,
                                              device=p.device), params)

    return grad_step, apply_step, zero_grads


def make_logprob_fn(
    cfg: LLMConfig,
    *,
    chunk_size: int = 512,
    attn_impl: str = "xla",
    temperature: float = 1.0,
    device="cuda",
) -> Callable[[Any, Dict[str, Any]], Tuple[torch.Tensor, torch.Tensor]]:
    """Forward-only logprob (+entropy) recompute, for old/ref/proximal
    logprobs. Unlike the train step's loss, it passes ``temperature`` to
    the lm-head (as the JAX package does; the two agree at 1.0)."""
    dev = resolve_device(device)
    check_on_card(cfg, dev, attn_impl=attn_impl)

    @torch.no_grad()
    def logprob_fn(params, batch):
        batch = _to_device(batch, dev)
        hidden, _ = M.forward_hidden(
            params, cfg, batch["input_ids"],
            attention_mask=batch["attention_mask"], attn_impl=attn_impl,
        )
        return linear_logprobs_and_entropy(
            params, cfg, hidden, batch["target_ids"], chunk_size=chunk_size,
            temperature=temperature,
        )

    return logprob_fn
