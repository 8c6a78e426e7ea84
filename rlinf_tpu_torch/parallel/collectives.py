"""Every collective of the port, with autograd where a forward needs one.

The JAX package has no counterpart: XLA's SPMD partitioner inserts its
collectives. Here each is explicit, and this module is the only place that
calls ``torch.distributed``'s collectives:

  copy_to(x, group)        identity forward, all-reduce (sum) backward
                           (Megatron's "f", before a column-parallel matmul)
  all_reduce(x, group)     all-reduce (sum) forward, identity backward
                           (Megatron's "g", after a row-parallel matmul)
  all_gather(x, dim, group, backward=)
                           concatenation along ``dim``; its backward is a
                           reduce-scatter (``"reduce_scatter"``: the ranks
                           computed different terms of the loss, as fsdp's)
                           or the rank's own slice (``"split"``: every rank
                           computed the same loss, as tensor-parallel ranks)
  reduce_scatter(x, dim, group)
                           sum, then the rank's slice along ``dim``
  all_to_all(x, send_sizes, recv_sizes, group)
                           rows exchanged with per-rank sizes: this rank's
                           rows are its chunks for ranks 0, 1, ... in order
                           (``send_sizes[j]`` rows for rank j), and it
                           receives ``recv_sizes[i]`` rows from each rank i,
                           in rank order; its backward is the same exchange
                           with the sizes swapped
  ring_shift(x, group)     the rank's block to the next rank of the group
                           (index + 1, modulo its size), the previous
                           rank's block back (JAX's ``ppermute`` with the
                           ring's permutation); its backward is the shift
                           the other way
  all_reduce_(x, op, group), broadcast_(x, src, group), broadcast_object
                           in place / on objects, no autograd

A group of None (an axis of size 1, or no ``torch.distributed`` world)
means no communication: each op is then the identity.

gloo takes CUDA tensors for ``broadcast`` and ``all_reduce`` only (no CUDA
``all_gather``, ``reduce_scatter`` or ``send``/``recv``); ranks that share
one card cannot use NCCL. On a gloo group holding CUDA tensors,
``all_gather`` is therefore an all-reduce of a zero-padded buffer (each
rank writes its block at its offset, the sum is the concatenation) and
``reduce_scatter`` an all-reduce followed by the rank's slice, and
``ring_shift`` the same zero-padded all-reduce as the all-gather, from
which each rank keeps its predecessor's block. This moves ``world`` times
the bytes of a real all-gather (or of a send): the times of such a run
say nothing of NCCL on several cards. Where the backend takes
point-to-point calls (gloo on CPU tensors, NCCL), the shift is one
``batch_isend_irecv`` of a send and a receive, and the all-to-all one
``all_to_all_single`` with split sizes.

``COUNTS`` counts the calls made to the backend by kind, for the drills'
reports.
"""

from __future__ import annotations

import collections
from typing import Any, List

import torch
import torch.distributed as dist

#: backend calls by kind ("all_reduce", "all_gather", "reduce_scatter",
#: "broadcast", "broadcast_object", "ring_shift" and "all_to_all": one a
#: shift or an exchange, in either form); reset by the caller
COUNTS: collections.Counter = collections.Counter()


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _index(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _emulated(x: torch.Tensor, group) -> bool:
    """A CUDA tensor on a gloo group: gather/scatter built from all_reduce."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _reduce_op(op: str):
    return {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
            "min": dist.ReduceOp.MIN}[op]


# ---------------------------------------------------------------------------
# In place, no autograd
# ---------------------------------------------------------------------------

def all_reduce_(x: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """``x`` reduced over ``group`` in place ("sum" | "max" | "min")."""
    if _size(group) == 1:
        return x
    COUNTS["all_reduce"] += 1
    dist.all_reduce(x, op=_reduce_op(op), group=group)
    return x


def broadcast_(x: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``x`` from global rank ``src`` to every rank of ``group``, in place."""
    if group is None:
        return x
    COUNTS["broadcast"] += 1
    dist.broadcast(x, src=src, group=group)
    return x


def broadcast_object(obj: Any, src: int, group=None) -> Any:
    """A picklable object from global rank ``src`` to every rank of
    ``group`` (through the host)."""
    if group is None:
        return obj
    COUNTS["broadcast_object"] += 1
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = _size(group)
    if n == 1:
        return x
    x = x.contiguous()
    if _emulated(x, group):
        COUNTS["all_reduce"] += 1
        shape = list(x.shape)
        shape[dim] *= n
        out = torch.zeros(shape, dtype=x.dtype, device=x.device)
        k = x.shape[dim]
        out.narrow(dim, _index(group) * k, k).copy_(x)
        dist.all_reduce(out, group=group)
        return out
    COUNTS["all_gather"] += 1
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def _scatter_sum(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = _size(group)
    if n == 1:
        return x
    x = x.contiguous()
    k = x.shape[dim] // n
    if _emulated(x, group):
        COUNTS["all_reduce"] += 1
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x.narrow(dim, _index(group) * k, k).contiguous()
    COUNTS["reduce_scatter"] += 1
    if dim != 0:
        parts = [p.contiguous() for p in x.split(k, dim)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=group)
        return out
    out = torch.empty((k,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x, group=group)
    return out


def _slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = _size(group)
    if n == 1:
        return x
    k = x.shape[dim] // n
    return x.narrow(dim, _index(group) * k, k).contiguous()


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """The block of the rank ``step`` places before this one in the group
    (this rank's own goes ``step`` places after it)."""
    n = _size(group)
    if n == 1:
        return x
    x = x.contiguous()
    me = _index(group)
    COUNTS["ring_shift"] += 1
    if _emulated(x, group):
        out = torch.zeros((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        out[me].copy_(x)
        dist.all_reduce(out, group=group)
        return out[(me - step) % n].clone()
    recv = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, (me + step) % n), group),
           dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, (me - step) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def _exchange(x: torch.Tensor, send_sizes, recv_sizes, group) -> torch.Tensor:
    """Rows of ``x`` (chunks for ranks 0..n-1 in order, ``send_sizes``)
    -> the rows this rank receives (``recv_sizes`` from ranks 0..n-1)."""
    n = _size(group)
    send_sizes, recv_sizes = [int(v) for v in send_sizes], [int(v) for v in recv_sizes]
    if n == 1:
        return x
    x = x.contiguous()
    COUNTS["all_to_all"] += 1
    if _emulated(x, group):
        me = _index(group)
        sizes = torch.zeros((n, n), dtype=torch.int64, device=x.device)
        sizes[me] = torch.as_tensor(send_sizes, dtype=torch.int64, device=x.device)
        COUNTS["all_reduce"] += 2
        dist.all_reduce(sizes, group=group)
        sizes = sizes.cpu()
        rows = int(sizes.sum(dim=1).max())
        buf = torch.zeros((n, rows) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        buf[me, :x.shape[0]].copy_(x)
        dist.all_reduce(buf, group=group)
        offsets = sizes.cumsum(dim=1) - sizes               # [sender, receiver]
        return torch.cat([buf[i, int(offsets[i, me]):int(offsets[i, me]) + recv_sizes[i]]
                          for i in range(n)])
    out = torch.empty((sum(recv_sizes),) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_to_all_single(out, x, output_split_sizes=recv_sizes,
                           input_split_sizes=send_sizes, group=group)
    return out


def gather_tensor(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather without autograd (checkpoints, weight sync, results)."""
    with torch.no_grad():
        return _gather(x, dim, group)


# ---------------------------------------------------------------------------
# With autograd
# ---------------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        return all_reduce_(g, "sum", ctx.group), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, backward):
        ctx.dim, ctx.group, ctx.backward = dim, group, backward
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.backward == "split":
            return _slice(g, ctx.dim, ctx.group), None, None, None
        return _scatter_sum(g, ctx.dim, ctx.group), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _scatter_sum(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, send_sizes, recv_sizes, group):
        ctx.sizes, ctx.group = (send_sizes, recv_sizes), group
        return _exchange(x, send_sizes, recv_sizes, group)

    @staticmethod
    def backward(ctx, g):
        send_sizes, recv_sizes = ctx.sizes
        return _exchange(g, recv_sizes, send_sizes, ctx.group), None, None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: identity forward, sum of the gradients backward."""
    if _size(group) == 1:
        return x
    return _CopyTo.apply(x, group)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: sum forward, identity backward."""
    if _size(group) == 1:
        return x
    return _AllReduce.apply(x, group)


def all_gather(x: torch.Tensor, dim: int, group, backward: str = "reduce_scatter"
               ) -> torch.Tensor:
    """Concatenate the ranks' blocks along ``dim`` (see the module
    docstring for ``backward``)."""
    if backward not in ("reduce_scatter", "split"):
        raise ValueError(f"backward must be reduce_scatter | split, got {backward!r}")
    if _size(group) == 1:
        return x
    return _AllGather.apply(x, dim, group, backward)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Sum over the ranks, then the rank's block along ``dim``."""
    if _size(group) == 1:
        return x
    return _ReduceScatter.apply(x, dim, group)


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """Send this rank's ``x`` to the next rank of ``group`` and return the
    previous rank's (ranks in the group's order, wrapping around); the
    gradient goes back the other way."""
    if _size(group) == 1:
        return x
    return _RingShift.apply(x, group)


def all_to_all(x: torch.Tensor, send_sizes, recv_sizes, group) -> torch.Tensor:
    """Exchange rows with per-rank sizes (see the module docstring): the
    gradient of the received rows goes back to their senders."""
    if _size(group) == 1:
        return x
    return _AllToAll.apply(x, tuple(int(v) for v in send_sizes),
                           tuple(int(v) for v in recv_sizes), group)


def group_size(group) -> int:
    return _size(group)


def counts() -> dict:
    return dict(COUNTS)


def reset_counts() -> None:
    COUNTS.clear()


__all__: List[str] = [
    "COUNTS", "all_gather", "all_reduce", "all_reduce_", "all_to_all", "broadcast_", "broadcast_object",
    "copy_to", "counts", "gather_tensor", "group_size", "reduce_scatter", "reset_counts",
    "ring_shift",
]
