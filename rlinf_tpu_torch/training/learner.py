"""Policy update and logprob-recompute steps for LLM RL.

Port of ``rlinf_tpu/training/learner.py``: the PPO-clip train step with
gradient accumulation over microbatches, the split grad/apply form, and the
forward-only logprob recompute. Loss normalization is the JAX package's:
each microbatch's per-token losses are summed and divided by the GLOBAL
count of valid tokens, so accumulation over microbatches equals one big
batch.

Where the JAX package jits one function that donates the state, the port
runs eagerly and updates the params and the optimizer state in place.
Under ``mesh=`` a step takes the GLOBAL batch, keeps this rank's rows and
reduces across the mesh as ``training/sharded_step.py`` says; the logprob
recompute returns the global result on every rank. Under
``attn_impl="ring"`` on a context axis > 1 the forward runs on this rank's
chunk of the sequence, and so do the loss's per-token inputs
(``model.context_chunks``): ``target_ids`` are already shifted per
position, so each chunk's logprobs are local, and the token sums over the
global count of valid tokens add up over the context ranks too.
An MoE model's auxiliary loss joins the policy loss in
``microbatch_loss_with_moe``, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from rlinf_tpu_torch.algorithms.losses import (
    compute_decoupled_ppo_actor_loss,
    compute_ppo_actor_loss,
    compute_ppo_critic_loss,
)
from rlinf_tpu_torch.algorithms.utils import kl_penalty
from rlinf_tpu_torch.models.llm import model as M
from rlinf_tpu_torch.models.llm.config import LLMConfig
from rlinf_tpu_torch.ops.cuda.geometry import check_on_card
from rlinf_tpu_torch.ops.logprobs import linear_logprobs_and_entropy
from rlinf_tpu_torch.training.sharded_step import MeshStep
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
    """Shared microbatch loss (PPO-clip + entropy/KL + MoE aux). An MoE
    model adds its auxiliary loss summed over layers, weighted by this
    microbatch's share of the valid tokens (``aux * local / global``), and
    reports it as ``actor/moe_aux_loss``."""
    hidden, _, moe_aux = M.forward_hidden(
        params, cfg, mb["input_ids"],
        attention_mask=mb["attention_mask"],
        attn_impl=attn_impl, remat=remat, return_aux=True, unroll_layers=unroll_layers,
    )
    mb = M.context_chunks(mb, attn_impl)
    lp, ent = linear_logprobs_and_entropy(
        params, cfg, hidden, mb["target_ids"], chunk_size=loss_cfg.logprob_chunk_size,
    )
    loss, metrics = _token_level_loss(lp, ent, mb, loss_cfg, global_valid_tokens)
    if cfg.is_moe:
        local = mb["loss_mask"].float().sum()
        loss = loss + moe_aux * local / global_valid_tokens
        metrics["actor/moe_aux_loss"] = moe_aux.detach()
    return loss, metrics


def _to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v).to(device)
            for k, v in batch.items()}


def _microbatches(batch: Dict[str, torch.Tensor], n: int) -> list:
    """``batch`` as ``n`` microbatches of consecutive rows."""
    if n == 1:
        return [batch]
    return [dict(zip(batch, vals)) for vals in zip(*(v.chunk(n) for v in batch.values()))]


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
    dev = resolve_device(device)
    ms = MeshStep(cfg, mesh, attn_impl=attn_impl)
    check_on_card(M.local_config(cfg, mesh), dev, attn_impl=attn_impl)
    acc_dt = grad_acc_dtype or torch.float32

    def loss_of(mb, global_valid):
        return lambda p: microbatch_loss_with_moe(
            p, cfg, loss_cfg, mb, global_valid,
            attn_impl=attn_impl, remat=remat, unroll_layers=unroll_layers)

    def train_step(state: TrainState, batch: Dict[str, Any]):
        with ms.active():
            return _train_step(state, batch)

    def _train_step(state: TrainState, batch: Dict[str, Any]):
        batch = _to_device(ms.rows(batch, num_microbatches), dev)
        global_valid = ms.valid(batch["loss_mask"].float().sum()).clamp_min(1.0)
        if num_microbatches == 1:
            grads, loss, metrics = _grads(state.params, loss_of(batch, global_valid))
        else:
            grads, loss, metrics_list = None, torch.zeros((), device=dev), []
            for mb in _microbatches(batch, num_microbatches):
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
        updates, new_opt_state, grad_norm = ms.update(tx, grads, state, optax_global_norm)
        del grads
        apply_updates(state.params, updates)
        metrics = dict(metrics)
        metrics["actor/loss"] = loss
        metrics = ms.metrics(metrics, M.context_chunks(batch, attn_impl)["loss_mask"].sum())
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
    mesh=None,
    device="cuda",
):
    """Split train step for dynamic microbatching: ``grad_step`` adds one
    microbatch's gradient (normalized by the global token count) into an
    accumulator, ``apply_step`` performs one optimizer update, with
    gradients identical to the one-big-batch form.

    Under ``mesh=`` ``grad_step`` takes a GLOBAL microbatch and keeps this
    rank's rows (a microbatch whose rows the batch axes do not divide is
    first padded with rows that hold no valid token; they add nothing), and
    ``apply_step`` reduces the accumulated blocks over the mesh as the
    train step does; its loss and metrics are this rank's share (summed
    over the ranks by ``reduce_metrics``)."""
    dev = resolve_device(device)
    ms = MeshStep(cfg, mesh, attn_impl=attn_impl)
    check_on_card(M.local_config(cfg, mesh), dev, attn_impl=attn_impl)
    def grad_step(params, acc_grads, mb, global_valid_tokens):
        # the rows padding the microbatch to the batch axes are no MoE tokens
        with ms.active(real_rows=len(next(iter(mb.values())))):
            mb = _to_device(ms.rows(ms.pad_rows(mb)), dev)
            gv = torch.as_tensor(global_valid_tokens, dtype=torch.float32, device=dev)
            g, loss, metrics = _grads(params, lambda p: microbatch_loss_with_moe(
                p, cfg, loss_cfg, mb, gv, attn_impl=attn_impl, remat=remat))
            tree_map(lambda a, x: a.add_(x.to(a.dtype)), acc_grads, g)
        return acc_grads, loss, metrics

    def apply_step(state: TrainState, grads):
        with ms.active():
            updates, new_opt, grad_norm = ms.update(tx, grads, state, optax_global_norm)
        apply_updates(state.params, updates)
        return TrainState(state.step + 1, state.params, new_opt), grad_norm

    def zero_grads(params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dtype or torch.float32,
                                              device=p.device), params)

    def reduce_metrics(metrics, mb):
        """Metrics of the global microbatch ``mb`` (this rank's shares)
        reduced over the mesh, as the train step reduces them."""
        with ms.active():
            mine = M.context_chunks(_to_device(ms.rows(ms.pad_rows(mb)), dev), attn_impl)
            return ms.metrics(metrics, mine["loss_mask"].sum())

    grad_step.reduce_metrics = reduce_metrics
    return grad_step, apply_step, zero_grads


def make_actor_critic_train_step(
    cfg: LLMConfig,
    loss_cfg: PolicyLossConfig,
    tx: Optimizer,
    *,
    value_clip: float = 0.2,
    huber_delta: float = 10.0,
    value_coef: float = 1.0,
    remat=True,
    attn_impl: str = "xla",
    mesh=None,
    device="cuda",
) -> Callable[[TrainState, Dict[str, Any]], Tuple[TrainState, Dict]]:
    """PPO actor-critic step for LLMs with a shared trunk and value head:
    one forward gives the actor's logprobs and entropy (K5/K6 on the card)
    and the values; the loss is the actor's + ``value_coef`` x the
    critic's. The batch adds ``returns`` and ``prev_values`` (fp32,
    aligned with target_ids). Under ``mesh`` as ``make_policy_train_step``:
    both losses are token sums over the global count of valid tokens."""
    from rlinf_tpu_torch.models.llm.value_head import values_from_hidden

    dev = resolve_device(device)
    ms = MeshStep(cfg, mesh, value_head=True, attn_impl=attn_impl)
    check_on_card(M.local_config(cfg, mesh), dev, attn_impl=attn_impl)

    def loss_of(batch, global_valid):
        def fn(params):
            hidden, _ = M.forward_hidden(
                params, cfg, batch["input_ids"], attention_mask=batch["attention_mask"],
                attn_impl=attn_impl, remat=remat,
            )
            tok = M.context_chunks(batch, attn_impl)     # the chunk's per-token inputs
            lp, ent = linear_logprobs_and_entropy(
                params, cfg, hidden, tok["target_ids"],
                chunk_size=loss_cfg.logprob_chunk_size,
            )
            values = values_from_hidden(params, hidden)
            actor_loss, metrics = _token_level_loss(lp, ent, tok, loss_cfg, global_valid)
            critic_loss, cmetrics = compute_ppo_critic_loss(
                values=values, returns=tok["returns"], prev_values=tok["prev_values"],
                value_clip=value_clip, huber_delta=huber_delta, loss_mask=tok["loss_mask"],
            )
            if mesh is not None:
                # the critic's masked mean over the global tokens: this
                # rank's share, summed over the ranks
                local = tok["loss_mask"].float().sum().clamp_min(1.0)
                critic_loss = critic_loss * local / global_valid
            metrics.update(cmetrics)
            metrics["_values"] = values          # for the whole batch's metrics
            return actor_loss + value_coef * critic_loss, metrics
        return fn

    def train_step(state: TrainState, batch: Dict[str, Any]):
        with ms.active():
            batch = _to_device(ms.rows(batch), dev)
            global_valid = ms.valid(batch["loss_mask"].float().sum()).clamp_min(1.0)
            grads, loss, metrics = _grads(state.params, loss_of(batch, global_valid))
            values = metrics.pop("_values")
            updates, new_opt, grad_norm = ms.update(tx, grads, state, optax_global_norm)
            del grads
            apply_updates(state.params, updates)
            metrics = dict(metrics)
            metrics["actor/loss"] = loss
            tok = M.context_chunks(batch, attn_impl)
            metrics = ms.critic_metrics(ms.metrics(metrics, tok["loss_mask"].sum()), values,
                                        tok["returns"], tok["prev_values"], tok["loss_mask"],
                                        value_clip)
            metrics["actor/grad_norm"] = grad_norm
        return TrainState(state.step + 1, state.params, new_opt), metrics

    return train_step


def make_logprob_fn(
    cfg: LLMConfig,
    *,
    chunk_size: int = 512,
    attn_impl: str = "xla",
    temperature: float = 1.0,
    mesh=None,
    device="cuda",
) -> Callable[[Any, Dict[str, Any]], Tuple[torch.Tensor, torch.Tensor]]:
    """Forward-only logprob (+entropy) recompute, for old/ref/proximal
    logprobs. Unlike the train step's loss, it passes ``temperature`` to
    the lm-head (as the JAX package does; the two agree at 1.0). Under
    ``mesh`` each rank computes its rows of the global batch (under ring
    attention on a context axis, its chunk of their sequence) and every
    rank gets the global result."""
    from rlinf_tpu_torch.parallel.distributed import fetch_global
    from rlinf_tpu_torch.parallel.mesh import AxisNames as Ax

    dev = resolve_device(device)
    ms = MeshStep(cfg, mesh, attn_impl=attn_impl)
    spec = (Ax.BATCH, Ax.CONTEXT) if ms.ring else (Ax.BATCH,)
    check_on_card(M.local_config(cfg, mesh), dev, attn_impl=attn_impl)

    @torch.no_grad()
    def logprob_fn(params, batch):
        with ms.active():
            batch = _to_device(ms.rows(batch), dev)
            hidden, _ = M.forward_hidden(
                params, cfg, batch["input_ids"],
                attention_mask=batch["attention_mask"], attn_impl=attn_impl,
            )
            lp, ent = linear_logprobs_and_entropy(
                params, cfg, hidden, M.context_chunks(batch, attn_impl)["target_ids"],
                chunk_size=chunk_size, temperature=temperature,
            )
            if mesh is None:
                return lp, ent
            return fetch_global(lp, mesh, spec), fetch_global(ent, mesh, spec)

    return logprob_fn
