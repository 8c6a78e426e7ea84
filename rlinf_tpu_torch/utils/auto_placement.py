"""Auto-placement: pick collocated vs disaggregated device splits from
profiled phase costs.

A copy of ``rlinf_tpu/utils/auto_placement.py`` (pure Python; the port
imports nothing of the JAX package). The model of a step:
  * collocated:  step = rollout(N) + train(N) + sync_colloc
  * disaggregated(k): step = max(rollout(k), train(N-k)) + sync_disagg
    (the phases overlap across steps, as the pipelined mode runs them)
Phase scaling follows a measured exponent: t(n) = t_ref * (ref/n)^alpha
(alpha=1 perfect scaling; alpha<1 sublinear, e.g. decode at small batch).
Device counts are ranks here (one process a device), chips in the JAX
package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class PhaseCost:
    """One phase's profiled cost: seconds at ``ref_chips`` chips."""

    name: str
    seconds: float
    ref_chips: int = 1
    scaling_alpha: float = 1.0     # t(n) = seconds * (ref_chips / n) ** alpha

    def at(self, chips: int) -> float:
        if chips <= 0:
            return float("inf")
        return self.seconds * (self.ref_chips / chips) ** self.scaling_alpha


@dataclasses.dataclass
class PlacementPlan:
    mode: str                      # "collocated" | "disaggregated"
    rollout_chips: int
    train_chips: int
    step_seconds: float
    details: Dict[str, float]

    def component_placement(self, total: int) -> Dict[str, str]:
        """YAML-able chip ranges (reference component_placement format)."""
        if self.mode == "collocated":
            rng = f"0-{total - 1}" if total > 1 else "0"
            return {"rollout": rng, "actor": rng}
        r = self.rollout_chips
        return {
            "rollout": f"0-{r - 1}" if r > 1 else "0",
            "actor": f"{r}-{total - 1}" if total - r > 1 else str(r),
        }


def solve_placement(
    total_chips: int,
    rollout: PhaseCost,
    train: PhaseCost,
    *,
    sync_collocated_s: float = 0.0,
    sync_disaggregated_s: float = 0.05,
    other_phases_s: float = 0.0,
) -> PlacementPlan:
    """Enumerate splits and return the fastest plan (reference workflow.py
    enumeration, minus the DAG generality the mesh design removes)."""
    best: Optional[PlacementPlan] = None

    # collocated: time-sliced phases on the full mesh
    colloc = (
        rollout.at(total_chips) + train.at(total_chips)
        + sync_collocated_s + other_phases_s
    )
    best = PlacementPlan(
        mode="collocated",
        rollout_chips=total_chips,
        train_chips=total_chips,
        step_seconds=colloc,
        details={"rollout_s": rollout.at(total_chips),
                 "train_s": train.at(total_chips)},
    )

    # disaggregated: k rollout chips, N-k train chips, phases pipelined
    for k in range(1, total_chips):
        r_s = rollout.at(k)
        t_s = train.at(total_chips - k)
        step = max(r_s, t_s) + sync_disaggregated_s + other_phases_s
        if step < best.step_seconds:
            best = PlacementPlan(
                mode="disaggregated",
                rollout_chips=k,
                train_chips=total_chips - k,
                step_seconds=step,
                details={"rollout_s": r_s, "train_s": t_s},
            )
    return best


def phase_costs_from_metrics(
    history: List[Dict[str, float]],
    chips: int,
    *,
    rollout_key: str = "time/rollout",
    train_key: str = "time/training",
    skip_steps: int = 2,
) -> Dict[str, PhaseCost]:
    """Build PhaseCosts from a runner's metric history (the profiling half of
    the reference's fitter.py; skips compile/warmup steps)."""
    import numpy as np

    rows = history[skip_steps:] if len(history) > skip_steps else history
    return {
        "rollout": PhaseCost(
            "rollout", float(np.mean([r[rollout_key] for r in rows])), chips
        ),
        "train": PhaseCost(
            "train", float(np.mean([r[train_key] for r in rows])), chips
        ),
    }
