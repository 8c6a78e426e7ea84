"""Composable loss-scale stages for multi-turn / multi-agent GRPO.

The port's own copy of ``rlinf_tpu/algorithms/loss_scales.py``.

Reference analog: rlinf/algorithms/loss_scales.py — a registry of scaling
stages applied in order to a dynamic rollout batch before the actor update:

  * ``group_level`` — rescales advantages so the effective contribution
    matches the configured global batch after dynamic turn counts merge
    across data-parallel workers (the outer 1/G of GRPO).
  * ``agent_level`` — per-trajectory 1/A_i (number of agents) and a uniform
    1/T_{i,a} across each agent's turns.
  * ``turn_level`` — refines the uniform per-turn factor into
    token-proportional weighting: 1/T_{i,a} -> |o_t| / sum_t |o_t| (with the
    later valid-token reduction this yields per-agent normalization by total
    agent tokens).

Stages are host-side numpy preprocessing (they run before the update step,
matching the reference's run_training context), enforce the same ordering
contract via ``context["folding_scale"]``, and write ``batch["loss_scales"]``
([num_turns] float32) that the learner multiplies into per-turn advantages.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np

_LOSS_SCALE_REGISTRY: Dict[str, Callable] = {}


def register_loss_scale(name: str):
    def deco(fn):
        _LOSS_SCALE_REGISTRY[name] = fn
        return fn

    return deco


def get_loss_scales(names: List[str]) -> List[Callable]:
    out = []
    for name in names:
        if name not in _LOSS_SCALE_REGISTRY:
            raise KeyError(
                f"unknown loss scale {name!r}; have "
                f"{sorted(_LOSS_SCALE_REGISTRY)}"
            )
        out.append(_LOSS_SCALE_REGISTRY[name])
    return out


def apply_loss_scales(names: List[str], context: dict, batch: dict) -> dict:
    """Run the named stages in order (context tracks the folding order)."""
    context.setdefault("folding_scale", [])
    if "loss_scales" not in batch:
        batch["loss_scales"] = np.ones(
            len(batch["idx_to_traj"]), np.float32
        )
    for fn in get_loss_scales(names):
        batch = fn(context, batch)
    return batch


def _group_turns(idx_to_traj) -> Dict[int, List[int]]:
    out: Dict[int, List[int]] = {}
    for idx, traj in enumerate(list(idx_to_traj)):
        out.setdefault(int(traj), []).append(idx)
    return out


@register_loss_scale("group_level")
def group_scale(context: dict, batch: dict) -> dict:
    """Outer 1/G GRPO normalization vs the configured global batch."""
    folding = context["folding_scale"]
    assert "group_level" not in folding, (
        "`group_level` loss scaling can only be applied once and must come "
        "before agent_level/turn_level"
    )
    folding.append("group_level")
    num_sequence = len(batch["idx_to_traj"])
    dp = context.get("data_parallel_world_size", 1)
    scale = num_sequence * dp / context["actor_global_batch_size"]
    batch["advantages"] = np.asarray(batch["advantages"]) * scale
    return batch


@register_loss_scale("agent_level")
def agent_scale(context: dict, batch: dict) -> dict:
    """1/A_i per trajectory and uniform 1/T_{i,a} per agent's turns."""
    folding = context["folding_scale"]
    assert "group_level" in folding and "agent_level" not in folding, (
        "`agent_level` requires `group_level` first and can only be applied "
        "once"
    )
    folding.append("agent_level")
    idx_to_sub = list(batch["idx_to_sub_traj"])
    scales = batch["loss_scales"]
    for traj_idxes in _group_turns(batch["idx_to_traj"]).values():
        sub: Dict[int, List[int]] = {}
        for idx in traj_idxes:
            sub.setdefault(int(idx_to_sub[idx]), []).append(idx)
        for sub_idxes in sub.values():
            for idx in sub_idxes:
                scales[idx] *= 1.0 / len(sub) / len(sub_idxes)
    return batch


@register_loss_scale("turn_level")
def turn_scale(context: dict, batch: dict) -> dict:
    """Uniform 1/T_{i,a} -> token-proportional |o_t| / sum_t |o_t|."""
    folding = context["folding_scale"]
    assert (
        "group_level" in folding and "agent_level" in folding
        and "turn_level" not in folding
    ), (
        "`turn_level` requires group_level and agent_level first and can "
        "only be applied once"
    )
    folding.append("turn_level")
    idx_to_sub = list(batch["idx_to_sub_traj"])
    tokens = np.asarray(batch["response_mask"]).sum(-1).astype(np.float64)
    scales = batch["loss_scales"]
    for traj_idxes in _group_turns(batch["idx_to_traj"]).values():
        sub: Dict[int, List[int]] = {}
        for idx in traj_idxes:
            sub.setdefault(int(idx_to_sub[idx]), []).append(idx)
        for sub_idxes in sub.values():
            total = max(float(tokens[sub_idxes].sum()), 1.0)
            T = len(sub_idxes)
            for idx in sub_idxes:
                # undo the uniform 1/T, apply |o_t| / total
                scales[idx] *= T * float(tokens[idx]) / total
    return batch
