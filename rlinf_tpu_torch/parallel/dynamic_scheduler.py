"""Dynamic scheduler: online device migration between rollout and training.

Port of ``rlinf_tpu/parallel/dynamic_scheduler.py``. ``DynamicScheduler``
watches per-step timings and, every ``interval`` steps, re-solves the
rollout/train split (``utils.auto_placement.solve_placement``) with
hysteresis, emitting a ``Migration`` when the projected step improves; it
is pure Python, as in the JAX package.

Placement is data here too: a phase owns a mesh over a set of ranks
(``submesh``), and migrating devices is re-sharding the param and
optimizer trees onto a new mesh. Where the JAX package makes one
resharding ``device_put`` of global arrays, a rank of the port holds its
blocks only, so a move is explicit: the old mesh's ranks gather each leaf
whole, its first rank broadcasts it to every rank of the world, and each
rank of the new mesh keeps its block (``migrate_sharded_state``, built on
``train_state.rescale_train_state``; a rank that held nothing receives its
blocks). ``reshard_delta`` moves only the leaves whose placement (the
ranks and the block each holds) changes.

Every function here that moves data is collective over the world: every
rank calls it, in the same order, with the same meshes. Meshes themselves
are built on the main thread of every rank (``dist.new_group`` is
collective and ordered), never inside ``StandbyMigrator.prepare``'s
thread, which issues no collective either: collectives from two threads
meet in a different order on each rank.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from rlinf_tpu_torch.parallel import collectives as C
from rlinf_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from rlinf_tpu_torch.parallel.sharding import (
    Layout, PartitionSpec, _axes, gather_block, local_block,
)
from rlinf_tpu_torch.utils.auto_placement import PhaseCost, PlacementPlan, solve_placement


@dataclasses.dataclass
class Migration:
    """A decided device migration (the RolloutAction/ActorAction analog)."""

    step: int
    plan: PlacementPlan
    prev_rollout_chips: int
    prev_train_chips: int

    @property
    def delta(self) -> int:
        return self.plan.rollout_chips - self.prev_rollout_chips


class DynamicScheduler:
    """Observes per-step phase timings; every ``interval`` steps re-solves the
    rollout/train split and emits a Migration when the projected step time
    improves by more than ``hysteresis`` (relative).

    The runner applies a Migration by calling ``migrate_sharded_state`` for
    each state tree and building its phase functions on the new meshes."""

    def __init__(
        self,
        total_devices: int,
        *,
        interval: int = 5,
        hysteresis: float = 0.15,
        warmup_steps: int = 2,
        sync_collocated_s: float = 0.0,
        sync_disaggregated_s: float = 0.01,
        rollout_alpha: float = 1.0,
        train_alpha: float = 1.0,
        rollout_key: str = "time/rollout",
        train_key: str = "time/training",
        sync_key: str = "time/weight_sync",
    ):
        # With linear phase scaling and no switch cost, collocated time
        # slicing is always best: disaggregation wins when collocation pays
        # a per-step switch cost (sync_collocated_s) or a phase scales
        # sublinearly (alpha < 1).
        self.total_devices = total_devices
        self.interval = interval
        self.hysteresis = hysteresis
        self.warmup_steps = warmup_steps
        self.sync_collocated_s = sync_collocated_s
        self.sync_disaggregated_s = sync_disaggregated_s
        self.rollout_alpha = rollout_alpha
        self.train_alpha = train_alpha
        self.rollout_key = rollout_key
        self.train_key = train_key
        self.sync_key = sync_key
        self.history: List[Dict[str, float]] = []
        self.current: Optional[PlacementPlan] = None
        self.migrations: List[Migration] = []
        self._step = 0

    def observe(self, metrics: Dict[str, float]) -> Optional[Migration]:
        """Feed one step's timing metrics; returns a Migration when the
        scheduler decides to move devices."""
        self._step += 1
        if self.rollout_key in metrics and self.train_key in metrics:
            self.history.append(dict(metrics))
        if (self._step <= self.warmup_steps
                or self._step % self.interval != 0
                or len(self.history) < self.warmup_steps + 1):
            return None
        return self._replan()

    def _current_chips(self) -> Dict[str, int]:
        if self.current is None:
            return {"rollout": self.total_devices, "train": self.total_devices}
        return {"rollout": self.current.rollout_chips, "train": self.current.train_chips}

    def _replan(self) -> Optional[Migration]:
        chips = self._current_chips()
        # phase costs at their current device counts, over the last
        # ``interval`` steps (timings after the last migration only)
        window = self.history[-self.interval:]
        rollout = PhaseCost("rollout", float(np.median([r[self.rollout_key] for r in window])),
                            chips["rollout"], scaling_alpha=self.rollout_alpha)
        train = PhaseCost("train", float(np.median([r[self.train_key] for r in window])),
                          chips["train"], scaling_alpha=self.train_alpha)
        # the measured collocated switch cost, where the runner reports one
        sync_obs = [r[self.sync_key] for r in window if self.sync_key in r]
        sync_colloc = float(np.median(sync_obs)) if sync_obs else self.sync_collocated_s
        plan = solve_placement(self.total_devices, rollout, train,
                               sync_collocated_s=sync_colloc,
                               sync_disaggregated_s=self.sync_disaggregated_s)

        if self.current is None:
            # first plan: adopted only if it beats the observed collocated step
            observed = rollout.seconds + train.seconds + sync_colloc
            if plan.step_seconds < observed * (1.0 - self.hysteresis):
                mig = Migration(self._step, plan, self.total_devices, self.total_devices)
                self.current = plan
                self.migrations.append(mig)
                return mig
            return None

        same_split = (plan.mode == self.current.mode
                      and plan.rollout_chips == self.current.rollout_chips)
        improved = plan.step_seconds < self.current.step_seconds * (1.0 - self.hysteresis)
        if same_split or not improved:
            # refresh the projected time of the standing plan
            self.current = dataclasses.replace(
                self.current,
                step_seconds=(max(rollout.seconds, train.seconds) + self.sync_disaggregated_s
                              if self.current.mode == "disaggregated"
                              else rollout.seconds + train.seconds + sync_colloc))
            return None
        mig = Migration(self._step, plan, self.current.rollout_chips, self.current.train_chips)
        self.current = plan
        self.migrations.append(mig)
        return mig


# ---------------------------------------------------------------------------
# State migration
# ---------------------------------------------------------------------------

def submesh(ranks: Sequence[int], start: int, count: int,
            axis_names=("data", "tensor"), model_parallel: int = 1, device_type=None):
    """A mesh of ``count / model_parallel`` x ``model_parallel`` over the
    ranks ``ranks[start:start + count]`` (the JAX package's ``(data,
    model)`` submesh; the port's axes are named, so the second is one of
    its axis names, ``tensor`` by default). Collective: every rank of the
    world builds it, on its main thread."""
    if count % model_parallel:
        raise ValueError(f"{count} ranks not divisible by model_parallel={model_parallel}")
    outer, inner = axis_names
    sizes = {"data": 1, outer: count // model_parallel}
    sizes[inner] = model_parallel if inner != outer else count
    return make_mesh(MeshConfig(**sizes), ranks=list(ranks)[start:start + count],
                     device_type=device_type)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's placement: its resolved spec on a mesh (the JAX package's
    ``NamedSharding``)."""

    mesh: Any
    spec: PartitionSpec

    def blocks(self, ndim: int) -> Dict[int, tuple]:
        """Each rank of the mesh -> which block it holds: (index, count)
        along every dim."""
        out = {}
        for r in self.mesh.ranks:
            blk = []
            for d in range(ndim):
                a = self.spec[d] if d < len(self.spec) else None
                if a is None:
                    blk.append((0, 1))
                else:
                    blk.append((self.mesh.axis_index(_axes(a), r), self.mesh.size(_axes(a))))
            out[r] = tuple(blk)
        return out

    def is_equivalent_to(self, other: "NamedSharding", ndim: int) -> bool:
        """The same ranks hold the same blocks."""
        return self.blocks(ndim) == other.blocks(ndim)


def _world() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def _device(mesh) -> torch.device:
    return torch.device(mesh.device_type) if mesh is not None else torch.device("cpu")


def _broadcast_tree(tree, src: int, device: torch.device):
    """A tree of tensors (and small objects) held whole on rank ``src`` ->
    on every rank of the world: its structure with each tensor's shape and
    dtype as one object, then each tensor, in ``tree_leaves`` order.
    ``tree`` is ignored elsewhere."""
    from rlinf_tpu_torch.training.train_state import tree_leaves, tree_map

    if not _world():
        return tree
    mine = dist.get_rank() == src
    meta = C.broadcast_object(
        tree_map(lambda t: ("tensor", tuple(t.shape), t.dtype) if torch.is_tensor(t)
                 else ("object", t), tree) if mine else None, src, dist.group.WORLD)
    out = tree_map(lambda t: t.to(device) if torch.is_tensor(t) else t, tree) if mine else tree_map(
        lambda m: torch.empty(m[1], dtype=m[2], device=device) if m[0] == "tensor" else m[1],
        meta)
    for leaf in tree_leaves(out):
        if torch.is_tensor(leaf):
            C.broadcast_(leaf, src, dist.group.WORLD)
    return out


def migrate_sharded_state(state, new_mesh, rules, *, old_layout: Optional[Layout] = None,
                          src: Optional[int] = None):
    """Re-shard a live tree (or a ``TrainState``: its params and optimizer
    state) onto ``new_mesh`` under ``rules``.

    ``state`` is this rank's blocks under ``old_layout`` (a ``Layout`` over
    the old mesh; None: the leaves are whole), or None on a rank that holds
    nothing. The old mesh's ranks gather each leaf whole; its first rank
    (or ``src``, where there is no old layout) broadcasts the whole tree to
    every rank of the world; each rank of ``new_mesh`` keeps its block
    (``rescale_train_state``) and every other rank gets None. Collective
    over the world."""
    from rlinf_tpu_torch.training.train_state import TrainState, rescale_train_state

    if src is None:
        src = old_layout.mesh.ranks[0] if old_layout is not None else 0
    holds = state is not None and (old_layout is None or old_layout.mesh.contains())
    whole = None
    if holds:
        as_ts = state if isinstance(state, TrainState) else TrainState(None, state, None)
        whole = rescale_train_state(as_ts, None, rules, old_layout=old_layout)
        whole = {"step": whole.step, "params": whole.params, "opt_state": whole.opt_state}
    whole = _broadcast_tree(whole, src, _device(new_mesh))
    if new_mesh is not None and not new_mesh.contains():
        return None
    out = rescale_train_state(TrainState(**whole), new_mesh, rules)
    return out if whole["step"] is not None else out.params


def make_migratable_phase(build_fn: Callable[[Any], Callable]) -> Callable[[Any], Callable]:
    """Memoize phase-function builds per mesh (its ranks and shape), so
    that flipping back to an earlier split reuses the built step."""
    cache: Dict[tuple, Callable] = {}

    def get(mesh) -> Callable:
        key = _mesh_key(mesh)
        if key not in cache:
            cache[key] = build_fn(mesh)
        return cache[key]

    return get


def _mesh_key(mesh) -> tuple:
    return (tuple(mesh.ranks), tuple(mesh.shape.items()))


def reshard_delta(tree, shardings, current):
    """Re-shard only the leaves whose target placement differs: ``tree``
    holds this rank's blocks under ``current`` (a tree of
    ``NamedSharding`` in its structure), ``shardings`` the targets. An
    equivalent leaf (the same ranks hold the same blocks) is returned as
    it is, the same tensor; a moved leaf is gathered over its mesh,
    broadcast from the mesh's first rank and cut to the target block (None
    on a rank outside the target mesh). Collective over the world, in the
    tree's order."""
    from rlinf_tpu_torch.training.train_state import tree_map

    def move(x, new, old):
        src = old.mesh.ranks[0]
        ndim = C.broadcast_object(None if x is None else x.dim(), src, dist.group.WORLD) \
            if _world() else x.dim()
        if old.is_equivalent_to(new, ndim):
            return x
        whole = gather_block(x, old.spec, old.mesh) if x is not None and old.mesh.contains() \
            else None
        whole = _broadcast_tree(whole, src, _device(new.mesh))
        return (local_block(whole, new.spec, new.mesh).contiguous().clone()
                if new.mesh.contains() else None)

    return tree_map(move, tree, shardings, current)


class StandbyMigrator:
    """Standby phase functions for candidate mesh splits.

    ``build_fn(mesh)`` -> the phase callable ``(state, batch) -> (state,
    metrics)`` (e.g. ``make_policy_train_step(..., mesh=mesh)``). The JAX
    package compiles the phase ahead of time on a thread (``lower`` /
    ``compile`` need no chip). The port has no ahead-of-time compile: its
    kernels are built once a process, at first use, and a step runs eagerly.
    So ``prepare`` builds the phase function on a thread (the step's
    layout, its mesh side, its optimizer wiring) and "ready" means that the
    function exists and the first call pays nothing but the migration and
    the step itself. The target mesh must already exist on every rank
    (built on the main thread: its groups are collective), and
    ``build_fn`` must issue no collective.
    """

    def __init__(self, build_fn: Callable[[Any], Callable], rules):
        self.build_fn = build_fn
        self.rules = rules
        self._entries: Dict[tuple, dict] = {}

    def prepare(self, mesh, state=None, batch=None, *, block: bool = False) -> None:
        """Start (or, with ``block=True``, also finish) building the phase
        function for ``mesh`` on a thread. ``state`` and ``batch`` are
        accepted for the JAX signature (it takes them as shape templates);
        the port's step needs none."""
        del state, batch
        key = _mesh_key(mesh)
        if key in self._entries:
            if block:
                self._entries[key]["thread"].join()
            return
        entry = {"fn": None, "error": None}

        def work():
            try:
                entry["fn"] = self.build_fn(mesh)
            except Exception as e:  # raised again by migrate()
                entry["error"] = e

        t = threading.Thread(target=work, daemon=True)
        entry["thread"] = t
        self._entries[key] = entry
        t.start()
        if block:
            t.join()

    def ready(self, mesh) -> bool:
        e = self._entries.get(_mesh_key(mesh))
        return bool(e) and not e["thread"].is_alive() and e["fn"] is not None

    def migrate(self, mesh, state, batch, *, old_layout: Optional[Layout] = None,
                src: Optional[int] = None):
        """Move ``state`` onto ``mesh`` (``migrate_sharded_state``) and run
        ONE step of the standby function on ``batch`` (the global batch).
        Returns (new state, metrics); (None, None) on a rank outside
        ``mesh``. Without a standby entry the function is built first."""
        key = _mesh_key(mesh)
        if key not in self._entries:
            self.prepare(mesh, block=True)
        e = self._entries[key]
        e["thread"].join()
        if e["error"] is not None:
            raise e["error"]
        state = migrate_sharded_state(state, mesh, self.rules, old_layout=old_layout, src=src)
        if state is None:
            return None, None
        return e["fn"](state, batch)


__all__ = [
    "DynamicScheduler", "Migration", "NamedSharding", "StandbyMigrator",
    "make_migratable_phase", "migrate_sharded_state", "reshard_delta", "submesh",
]
