"""Disaggregated reasoning RL: the actor and the rollout on disjoint ranks.

Port of ``rlinf_tpu/runners/disaggregated_runner.py``. The JAX package runs
the rollout in a background thread on the rollout submesh while the actor
submesh trains. Here the two are sets of processes (ranks): every rank
builds the runner with the same placement and calls ``run``, and the ranks
of each set do their part of each step:

  rollout ranks  generate batch N+1 on the rollout mesh (the static
                 engine, ``rollout(mesh=)``) while the actor ranks train on
                 batch N, with the weights of the last sync: a lag of one
                 version at ``sync_interval=1``
  actor ranks    train on the batch the rollout ranks sent (stamped with the
                 version that made it; the decoupled-PPO loss reads the
                 stamps), then every ``sync_interval`` steps send the
                 weights through ``parallel/weight_sync.py``

The rollout's first rank broadcasts each result to the world, and the
actor's first rank broadcasts each step's metrics, so every rank returns
the same history. ``check_sync=True`` compares the rollout ranks' whole
weights with the actor's after every sync (``disagg/sync_max_abs``). The
rollout ranks hold no train state (its tensors are on the meta device).
Collocated placements and the plain PPO loss are refused, as in the JAX
package.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from rlinf_tpu_torch.config import TrainerConfig
from rlinf_tpu_torch.models.llm import model as M
from rlinf_tpu_torch.parallel import collectives as C
from rlinf_tpu_torch.parallel.mesh import ComponentPlacement, PlacementMode
from rlinf_tpu_torch.parallel.weight_sync import make_weight_syncer
from rlinf_tpu_torch.runners.reasoning_runner import ReasoningRunner


class DisaggregatedReasoningRunner(ReasoningRunner):
    def __init__(
        self,
        cfg: TrainerConfig,
        tokenizer,
        dataset,
        *,
        placement: ComponentPlacement,
        reward_fn=None,
        syncer: str = "bucket",
        syncer_kwargs: Optional[dict] = None,
        sync_interval: int = 1,
        check_sync: bool = False,
        device="cuda",
    ):
        if placement.mode != PlacementMode.DISAGGREGATED:
            raise ValueError(
                f"placement mode is {placement.mode}, expected DISAGGREGATED "
                "(use ReasoningRunner for collocated/hybrid)")
        if cfg.loss.loss_type != "decoupled":
            raise ValueError(
                "disaggregated mode trains against stale rollouts; set "
                "loss.loss_type=decoupled (reference async semantics)")
        self.placement = placement
        self.actor_mesh = placement.mesh("actor")
        self.rollout_mesh = placement.mesh("rollout")
        self.is_actor = self.actor_mesh.contains()
        own = self.actor_mesh if self.is_actor else self.rollout_mesh
        init = None
        if not self.is_actor:
            init = lambda s: M.init_params(cfg.model, s, device="meta")
        super().__init__(cfg, tokenizer, dataset, mesh=own, reward_fn=reward_fn,
                         init_params_override=init, device=device)
        self.syncer = make_weight_syncer(
            syncer, self.rollout_mesh, M.partition_rules(),
            source_mesh=self.actor_mesh, source_rules=M.partition_rules(),
            full_shapes=M.init_params(cfg.model, 0, device="meta"),
            device=self.device, **(syncer_kwargs or {}))
        self.sync_interval = sync_interval
        self.check_sync = check_sync
        self.world = dist.group.WORLD
        self.rollout_leader = self.rollout_mesh.ranks[0]
        self.actor_leader = self.actor_mesh.ranks[0]
        # the initial full sync: the rollout ranks get the actor's weights
        self.rollout_params = self.syncer.sync(self._policy_params() if self.is_actor else None)
        self.param_version = 0
        self._behavior_version = 0
        self.last_sync = {}

    # -- hooks ------------------------------------------------------------
    def _augment_batch(self, batch_dict, result):
        B, T = batch_dict["loss_mask"].shape
        dev = batch_dict["loss_mask"].device
        v = float(getattr(result, "version", self._behavior_version))
        batch_dict["versions"] = torch.full((B, T), v, dtype=torch.float32, device=dev)
        batch_dict["current_version"] = torch.full(
            (B,), float(self.param_version), dtype=torch.float32, device=dev)

    def _disagg_rollout(self):
        """Generate on the rollout mesh with the synced weights."""
        examples = self.iterator.next_batch()
        request = self._make_request(examples)
        result = self.engine.rollout(self.rollout_params, request, self._sample_gen,
                                     mesh=self.rollout_mesh)
        result.version = self.param_version
        return result

    def _sync_weights(self):
        """Actor -> rollout transfer, on every rank."""
        t0 = time.perf_counter()
        out = self.syncer.sync(self._policy_params() if self.is_actor else None)
        if not self.is_actor:
            self.rollout_params = out
        self.param_version += 1
        self.last_sync = {"seconds": time.perf_counter() - t0,
                          "bytes": float(self.syncer.last_bytes_sent)}
        if self.check_sync:
            self.last_sync["max_abs"] = self._sync_max_abs()

    def _sync_max_abs(self) -> float:
        """The largest |rollout - actor| over the whole weights (0.0 for
        the full and bucket syncers: the bytes arrive as they left)."""
        actor_full = self._layout(False).gather(self.state.params) if self.is_actor else None
        got = self.syncer.full_params() if not self.is_actor else None
        from rlinf_tpu_torch.parallel.sharding import flatten_with_paths

        mine = {p: t.float().cpu() for p, t in flatten_with_paths(got)} if got else None
        mine = C.broadcast_object(mine, self.rollout_leader, self.world)
        diff = 0.0
        if self.is_actor:
            for p, t in flatten_with_paths(actor_full):
                diff = max(diff, float((t.float().cpu() - mine[p]).abs().max()))
        return C.broadcast_object(diff, self.actor_leader, self.world)

    # -- the loop ---------------------------------------------------------
    def run(self, max_steps: Optional[int] = None) -> List[Dict[str, float]]:
        """The rollout ranks generate batch N+1 while the actor ranks train
        on batch N; every rank returns the actor's metrics."""
        n = max_steps or self.cfg.runner.max_steps
        history: List[Dict[str, float]] = []
        result = self._disagg_rollout() if not self.is_actor else None
        while self.global_step < n:
            result = C.broadcast_object(result, self.rollout_leader, self.world)
            metrics = None
            if self.is_actor:
                self._behavior_version = getattr(result, "version", self.param_version)
                metrics = self._train_on_result(result)
                metrics["disagg/version_lag"] = float(self.param_version - self._behavior_version)
            else:
                self.global_step += 1
                t0 = time.perf_counter()
                result = self._disagg_rollout() if self.global_step < n else None
                rollout_s = time.perf_counter() - t0
            if self.global_step % self.sync_interval == 0:
                self._sync_weights()
                if self.is_actor:
                    metrics["disagg/sync_s"] = self.last_sync["seconds"]
                    metrics["disagg/sync_bytes"] = self.last_sync["bytes"]
                    if self.check_sync:
                        metrics["disagg/sync_max_abs"] = self.last_sync["max_abs"]
            if self.is_actor:
                metrics["disagg/param_version"] = float(self.param_version)
            metrics = C.broadcast_object(metrics, self.actor_leader, self.world)
            if not self.is_actor:
                metrics = dict(metrics, **{"disagg/rollout_s": rollout_s})
            history.append(metrics)
        return history

    run_pipelined = run
