"""What a train step does differently under a mesh.

The JAX package pins the batch to the batch axes and lets XLA reduce the
gradients; a rank of the port holds its rows and its parameter blocks, and
reduces explicitly:

  rows      the global batch -> this rank's rows (its block along data x
            fsdp, ``distributed.shard_rows_for_process``)
  valid     the global count of valid tokens (an all-reduce of the ranks'
            counts): every rank divides its token-loss sum by it, so the
            sum over ranks is the global token mean
  grads     a leaf the forward gathered over fsdp came back reduce-scattered
            over fsdp, so it is summed over data alone; every other leaf is
            summed over data x fsdp. Tensor-parallel ranks hold the same
            gradient of a replicated leaf already (Megatron's f/g pairs)
  norm      the global norm: each leaf's sum of squares over its blocks,
            counted once (a block held by r ranks is weighted 1/r), summed
            over the mesh in one all-reduce
  metrics   one all-reduce over the batch axes: sums of per-token terms
            (the losses, entropy, kl) are summed, the rest (masked means
            over the rank's valid tokens) weighted by the rank's count of
            valid tokens, so that each is the global masked mean (with
            several microbatches, the mean over each rank's microbatches)

Without a mesh every method is the single-device step's own.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from rlinf_tpu_torch.parallel import collectives as C
from rlinf_tpu_torch.parallel.distributed import shard_rows_for_process
from rlinf_tpu_torch.parallel.mesh import AxisNames as Ax, use_mesh
from rlinf_tpu_torch.parallel.sharding import Layout, flatten_with_paths, sharded_axes

#: metrics that are sums over tokens (divided by the global count or not):
#: the ranks' values add up to the global one
SUMMED_METRICS = ("actor/loss", "actor/policy_loss", "actor/policy_loss_abs",
                  "actor/entropy", "actor/kl", "critic/loss")


def model_layout(cfg, mesh, rules=None, value_head: bool = False) -> Layout:
    """The layout of a model's params (and a value head) on ``mesh``,
    resolved against the full shapes (made on the meta device)."""
    from rlinf_tpu_torch.models.llm import model as M
    from rlinf_tpu_torch.models.llm.value_head import value_partition_rules

    full = M.init_params(cfg, 0, device="meta")
    if value_head:
        full["value_head"] = torch.empty((cfg.hidden_size, 1), device="meta")
    rules = rules if rules is not None else value_partition_rules() + M.partition_rules()
    return Layout.from_rules(mesh, rules, full)


class MeshStep:
    """The mesh's side of a train step (see the module docstring)."""

    def __init__(self, cfg, mesh, *, value_head: bool = False):
        self.mesh = mesh
        if mesh is None:
            self.layout = None
            return
        from rlinf_tpu_torch.models.llm.model import check_mesh

        check_mesh(cfg, mesh)
        self.layout = model_layout(cfg, mesh, value_head=value_head)
        self.batch_group = mesh.get_group(Ax.BATCH)
        self.data_group = mesh.get_group(Ax.DATA)
        self.mesh_group = mesh.get_group(tuple(mesh.shape))

    def active(self):
        return use_mesh(self.mesh)

    def rows(self, batch: Dict) -> Dict:
        """The global batch -> this rank's rows."""
        if self.mesh is None:
            return batch
        n = next(iter(batch.values())).shape[0]
        sl = shard_rows_for_process(n, self.mesh)
        return {k: v[sl] for k, v in batch.items()}

    def valid(self, local: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return local
        return C.all_reduce_(local.float().clone(), "sum", self.batch_group)

    def grads(self, grads):
        """Sum each leaf's gradient over the batch axes it was not
        reduce-scattered over."""
        if self.mesh is None:
            return grads
        for path, g in flatten_with_paths(grads):
            spec = self.layout.spec_for(path, g.shape)
            group = self.data_group if Ax.FSDP in sharded_axes(spec) else self.batch_group
            C.all_reduce_(g, "sum", group)
        return grads

    def norm(self, grads) -> Optional[torch.Tensor]:
        """The global norm of the sharded gradient (None without a mesh:
        the optimizer takes the norm of its whole gradient itself)."""
        if self.mesh is None:
            return None
        total = None
        size = self.mesh.size()
        for path, g in flatten_with_paths(grads):
            w = self.layout.shard_count(path, g.shape) / size
            sq = (g * g).float().sum().to(g.dtype).float() * w
            total = sq if total is None else total + sq
        return torch.sqrt(C.all_reduce_(total, "sum", self.mesh_group))

    def update(self, tx, grads, state, local_norm):
        """The optimizer's update from this rank's gradient blocks, reduced
        over the mesh, and the global grad norm: ``local_norm(grads)``
        without a mesh, the sharded norm (which the clip reads) with one."""
        grads = self.grads(grads)
        norm = self.norm(grads)
        if norm is None:
            updates, opt_state = tx.update(grads, state.opt_state, state.params)
            return updates, opt_state, local_norm(grads)
        updates, opt_state = tx.update(grads, state.opt_state, state.params, grad_norm=norm)
        return updates, opt_state, norm

    def metrics(self, metrics: Dict[str, torch.Tensor], local_count) -> Dict[str, torch.Tensor]:
        """Reduce the metrics over the batch axes; ``local_count``: this
        rank's valid tokens."""
        if self.mesh is None or self.batch_group is None:
            return metrics
        keys = list(metrics)
        dev = torch.device(self.mesh.device_type)
        w = torch.as_tensor(local_count).float().reshape(()).to(dev)
        vals = [torch.as_tensor(metrics[k]).float().reshape(()).to(dev) for k in keys]
        vec = torch.stack([v if k in SUMMED_METRICS else v * w for k, v in zip(keys, vals)]
                          + [w])
        C.all_reduce_(vec, "sum", self.batch_group)
        total = vec[-1].clamp_min(1.0)
        return {k: (vec[i] if k in SUMMED_METRICS else vec[i] / total)
                for i, k in enumerate(keys)}
