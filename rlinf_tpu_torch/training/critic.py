"""Separate-critic PPO: the critic as its own model and optimizer.

Port of ``rlinf_tpu/training/critic.py``: the critic is a full LLM trunk
with a scalar value head and no lm head in use, its own ``TrainState`` and
optimizer, trained every step on the clipped-value huber loss against GAE
returns; ``CriticConfig.warmup_steps`` critic-only steps come before the
first actor update. The shared-trunk value head is
``training/learner.py make_actor_critic_train_step``.

Where the JAX package jits a step that donates the state, the port runs
eagerly and updates the critic's params and optimizer state in place.
Under ``mesh=`` the step takes the global batch and keeps this rank's rows
(``training/sharded_step.py``); the critic's masked-mean loss is weighted
by the rank's share of the valid tokens, so the ranks' losses add up to
the global one. The value fn returns the global values on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from rlinf_tpu_torch.algorithms.losses import compute_ppo_critic_loss
from rlinf_tpu_torch.models.llm import model as M
from rlinf_tpu_torch.models.llm.config import LLMConfig
from rlinf_tpu_torch.models.llm.value_head import add_value_head, forward_values
from rlinf_tpu_torch.ops.cuda.geometry import check_on_card
from rlinf_tpu_torch.training.sharded_step import MeshStep
from rlinf_tpu_torch.training.train_state import Optimizer, TrainState, apply_updates
from rlinf_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class CriticConfig:
    """``algorithm.critic='separate'`` knobs."""

    value_clip: float = 0.2
    huber_delta: float = 10.0
    #: critic-only steps before the first actor update
    warmup_steps: int = 0
    #: None = reuse the actor's optimizer config
    lr: Optional[float] = None


def init_critic_params(cfg: LLMConfig, seed: int, device="cuda") -> Dict:
    """Full trunk + near-zero value head; no LM head is ever used. The
    trunk draws from ``seed``, the head from ``seed + 1``."""
    return add_value_head(M.init_params(cfg, seed, device), cfg, seed + 1, device)


def make_critic_value_fn(cfg: LLMConfig, *, attn_impl: str = "xla", mesh=None,
                         device="cuda"):
    """fp32 token values [B, T] from the critic's own trunk (or a shared
    trunk's value head), without grad."""
    from rlinf_tpu_torch.parallel.distributed import fetch_global
    from rlinf_tpu_torch.parallel.mesh import AxisNames as Ax

    dev = resolve_device(device)
    ms = MeshStep(cfg, mesh, value_head=True, attn_impl=attn_impl)
    spec = (Ax.BATCH, Ax.CONTEXT) if ms.ring else (Ax.BATCH,)
    check_on_card(M.local_config(cfg, mesh), dev, attn_impl=attn_impl)

    @torch.no_grad()
    def value_fn(params, input_ids, attention_mask):
        with ms.active():
            rows = ms.rows({"ids": input_ids, "mask": attention_mask})
            v = forward_values(params, cfg, torch.as_tensor(rows["ids"], device=dev),
                               torch.as_tensor(rows["mask"], device=dev), attn_impl=attn_impl)
            return v if mesh is None else fetch_global(v, mesh, spec)

    return value_fn


def make_critic_train_step(
    cfg: LLMConfig,
    critic_cfg: CriticConfig,
    tx: Optimizer,
    *,
    remat=True,
    attn_impl: str = "xla",
    mesh=None,
    device="cuda",
) -> Callable[[TrainState, Dict[str, Any]], Tuple[TrainState, Dict]]:
    """One critic update on a batch with ``returns`` / ``prev_values``:
    each parameter's update is added in f32 and cast back to its dtype
    (``apply_updates``), as the JAX package's tree map does."""
    from rlinf_tpu_torch.training.learner import _grads, _to_device, optax_global_norm

    dev = resolve_device(device)
    ms = MeshStep(cfg, mesh, value_head=True, attn_impl=attn_impl)
    check_on_card(M.local_config(cfg, mesh), dev, attn_impl=attn_impl)

    def loss_fn(batch, share):
        def fn(params):
            values = forward_values(params, cfg, batch["input_ids"], batch["attention_mask"],
                                    attn_impl=attn_impl, remat=remat)
            tok = M.context_chunks(batch, attn_impl)    # the chunk's per-token inputs
            loss, metrics = compute_ppo_critic_loss(
                values=values, returns=tok["returns"], prev_values=tok["prev_values"],
                value_clip=critic_cfg.value_clip, huber_delta=critic_cfg.huber_delta,
                loss_mask=tok["loss_mask"])
            metrics["_values"] = values          # for the whole batch's metrics
            return (loss if share is None else loss * share), metrics
        return fn

    def train_step(state: TrainState, batch: Dict[str, Any]):
        with ms.active():
            batch = _to_device(ms.rows(batch), dev)
            share = None
            local = M.context_chunks(batch, attn_impl)["loss_mask"].float().sum()
            if mesh is not None:
                share = local.clamp_min(1.0) / ms.valid(
                    batch["loss_mask"].float().sum()).clamp_min(1.0)
            grads, _, metrics = _grads(state.params, loss_fn(batch, share))
            values = metrics.pop("_values")
            updates, new_opt, grad_norm = ms.update(tx, grads, state, optax_global_norm)
            apply_updates(state.params, updates)
            tok = M.context_chunks(batch, attn_impl)
            metrics = ms.critic_metrics(ms.metrics(dict(metrics), local), values,
                                        tok["returns"], tok["prev_values"], tok["loss_mask"],
                                        critic_cfg.value_clip)
            metrics["critic/grad_norm"] = grad_norm
        return TrainState(state.step + 1, state.params, new_opt), metrics

    return train_step

