"""What a train step does differently under a mesh.

The JAX package pins the batch to the batch axes and lets XLA reduce the
gradients; a rank of the port holds its rows and its parameter blocks, and
reduces explicitly:

  rows      the global batch -> this rank's rows (its block along data x
            fsdp, ``distributed.shard_rows_for_process``; with n
            microbatches, its block of each of the n consecutive row blocks,
            so that its microbatch j is its share of the global microbatch
            j, as the JAX package cuts them); under ring
            attention on a context axis > 1 every context rank keeps the
            same rows, and the forward and the loss take its chunk of the
            sequence (``model.context_chunks``)
  valid     the global count of valid tokens (an all-reduce of the ranks'
            counts): every rank divides its token-loss sum by it, so the
            sum over ranks is the global token mean
  grads     a leaf the forward gathered over fsdp came back reduce-scattered
            over fsdp, so it is summed over data alone; every other leaf is
            summed over data x fsdp. Tensor-parallel ranks hold the same
            gradient of a replicated leaf already (Megatron's f/g pairs).
            Under ring attention the context ranks computed different
            tokens: the context axis joins both sums (without ring they
            computed the same rows, and it joins neither)
  norm      the global norm: each leaf's sum of squares over its blocks,
            counted once (a block held by r ranks is weighted 1/r), summed
            over the mesh in one all-reduce
  metrics   one all-reduce over the batch axes (and context, under ring,
            where each rank's count is its chunk's): sums of per-token terms
            (the losses, entropy, kl) are summed, the rest (masked means
            over the rank's valid tokens) weighted by the rank's count of
            valid tokens, so that each is the global masked mean (with
            several microbatches, the mean over each rank's microbatches).
            The critic's explained variance and clip ratio, which are not
            masked means, are made from whole-batch sums (``critic_metrics``)

``shards()`` tells an optimizer whose update of an element reads others
(adafactor) how each leaf is cut, so that it reduces whole rows and
columns over the ranks that hold them.

Without a mesh every method is the single-device step's own.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch

from rlinf_tpu_torch.parallel import collectives as C
from rlinf_tpu_torch.parallel.distributed import shard_rows_for_process
from rlinf_tpu_torch.parallel.mesh import AxisNames as Ax, use_mesh
from rlinf_tpu_torch.parallel.sharding import Layout, flatten_with_paths, sharded_axes

#: metrics that are sums over tokens (divided by the global count or not):
#: the ranks' values add up to the global one
SUMMED_METRICS = ("actor/loss", "actor/policy_loss", "actor/policy_loss_abs",
                  "actor/entropy", "actor/kl", "critic/loss")


def shards_of(layout: Layout, tree):
    """``train_state.Blocks`` of every leaf of ``tree`` under ``layout``
    (its spec by path and local shape), in ``tree``'s structure."""
    from rlinf_tpu_torch.parallel.sharding import _map_with_paths
    from rlinf_tpu_torch.training.train_state import Blocks

    return _map_with_paths(
        lambda path, leaf: Blocks(layout.spec_for(path, leaf.shape), layout.mesh), tree)


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

    def __init__(self, cfg, mesh, *, value_head: bool = False, attn_impl: str = "xla",
                 rules=None):
        self.mesh = mesh
        if mesh is None:
            self.layout = None
            self.ring = False
            return
        from rlinf_tpu_torch.models.llm.model import check_mesh

        check_mesh(cfg, mesh)
        self.layout = model_layout(cfg, mesh, rules=rules, value_head=value_head)
        #: the context ranks hold different chunks of the sequence
        self.ring = attn_impl == "ring" and mesh.size(Ax.CONTEXT) > 1
        ctx = (Ax.CONTEXT,) if self.ring else ()
        self.valid_group = mesh.get_group(Ax.BATCH)
        self.batch_group = mesh.get_group(Ax.BATCH + ctx)
        self.data_group = mesh.get_group((Ax.DATA,) + ctx)
        self.mesh_group = mesh.get_group(tuple(mesh.shape))

    @contextlib.contextmanager
    def active(self, real_rows=None):
        """The mesh active, and an MoE layer's token batch this rank's share
        of the rows split over the batch axes (``ops.moe.rows_split_over``;
        ``real_rows``: the global rows before ``pad_rows``'s padding)."""
        from rlinf_tpu_torch.ops.moe import rows_split_over

        with use_mesh(self.mesh), rows_split_over(self.mesh, Ax.BATCH, real_rows):
            yield

    def rows(self, batch: Dict, num_microbatches: int = 1) -> Dict:
        """The global batch -> this rank's rows (see the module docstring)."""
        if self.mesh is None:
            return batch
        n = next(iter(batch.values())).shape[0]
        if num_microbatches == 1:
            sl = shard_rows_for_process(n, self.mesh)
            return {k: v[sl] for k, v in batch.items()}
        if n % num_microbatches:
            raise ValueError(f"batch {n} not divisible by {num_microbatches} microbatches")
        per = n // num_microbatches
        sl = shard_rows_for_process(per, self.mesh)
        idx = np.concatenate([np.arange(j * per + sl.start, j * per + sl.stop)
                              for j in range(num_microbatches)])
        return {k: v[torch.as_tensor(idx, device=v.device) if torch.is_tensor(v) else idx]
                for k, v in batch.items()}

    def pad_rows(self, batch: Dict) -> Dict:
        """``batch`` with rows appended, up to a multiple of the batch axes'
        size, that hold no valid token (masks False, zeros elsewhere): a
        token-budget microbatch has any number of rows."""
        if self.mesh is None:
            return batch
        n = next(iter(batch.values())).shape[0]
        extra = -n % self.mesh.size(Ax.BATCH)
        if not extra:
            return batch

        def pad(v):
            v = torch.as_tensor(v)
            return torch.cat([v, torch.zeros((extra,) + tuple(v.shape[1:]), dtype=v.dtype,
                                             device=v.device)])
        return {k: pad(v) for k, v in batch.items()}

    def valid(self, local: torch.Tensor) -> torch.Tensor:
        """The global count from this rank's rows' count (whole rows: the
        context ranks' counts are the same and are not added)."""
        if self.mesh is None:
            return local
        return C.all_reduce_(local.float().clone(), "sum", self.valid_group)

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

    def shards(self, tree):
        """A ``train_state.Blocks`` for every leaf of ``tree`` (params or
        their gradients): its resolved spec on the mesh (None without
        one)."""
        if self.mesh is None:
            return None
        return shards_of(self.layout, tree)

    def update(self, tx, grads, state, local_norm):
        """The optimizer's update from this rank's gradient blocks, reduced
        over the mesh, and the global grad norm: ``local_norm(grads)``
        without a mesh, the sharded norm (which the clip reads) with one."""
        grads = self.grads(grads)
        norm = self.norm(grads)
        if norm is None:
            updates, opt_state = tx.update(grads, state.opt_state, state.params)
            return updates, opt_state, local_norm(grads)
        updates, opt_state = tx.update(grads, state.opt_state, state.params, grad_norm=norm,
                                       shards=self.shards(grads))
        return updates, opt_state, norm

    def critic_metrics(self, metrics: Dict[str, torch.Tensor], values, returns, prev_values,
                       mask, value_clip: float) -> Dict[str, torch.Tensor]:
        """``metrics`` (already reduced) with the critic's explained
        variance and clip ratio of the whole batch (two passes over
        all-reduced sums, as the single-device metrics take them), where a
        mesh splits the batch."""
        if self.mesh is None or self.batch_group is None:
            return metrics
        values, returns, prev_values = values.float(), returns.float(), prev_values.float()
        m = mask.float()
        clipped = (prev_values + torch.clamp(values - prev_values, -value_clip, value_clip)
                   - prev_values).abs() > value_clip
        first = torch.stack([m.sum(), (returns * m).sum(), clipped.float().sum(),
                             torch.tensor(float(m.numel()), device=m.device)])
        C.all_reduce_(first, "sum", self.batch_group)
        count = first[0].clamp_min(1.0)
        mean = first[1] / count
        second = torch.stack([(torch.square(returns - mean) * m).sum(),
                              (torch.square(returns - values) * m).sum()])
        C.all_reduce_(second, "sum", self.batch_group)
        ret_var, err_var = second[0] / count, second[1] / count
        return {**metrics,
                "critic/value_clip_ratio": first[2] / first[3],
                "critic/explained_variance": 1.0 - err_var / torch.clamp(ret_var, min=1e-8)}

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
