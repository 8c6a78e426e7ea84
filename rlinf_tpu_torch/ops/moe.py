"""Mixture-of-Experts layer: top-k routing, SwiGLU experts, and the Switch
load-balancing auxiliary loss.

Port of ``rlinf_tpu/ops/moe.py``, with two dispatches:

* ``moe_layer_capacity`` (GShard/Switch): each expert takes at most
  ``capacity = max(1, round(N * k / E * capacity_factor))`` of the N = B*S
  tokens (padding included); choice 0 of every token claims its slot before
  choice 1, and a (token, choice) over capacity is dropped (the residual
  passes through). The JAX package builds one-hot [k, N, E, C] dispatch and
  combine tensors for einsums; the port dispatches by index: a scatter of
  the kept tokens into an [E, C, D] buffer by (expert, slot), the experts as
  batched products, and a gather back weighted by the gates. The function is
  the same; the one-hot tensors would cost k*N*E*C*4 bytes.
* ``moe_layer_dropless``: the (token, choice) pairs stably sorted by
  expert, the experts as grouped products over the contiguous groups, then
  a gate-weighted scatter-add. The JAX package's ``lax.ragged_dot`` is an
  XLA op, not a Pallas kernel; the port pads each group to the largest
  group (one host read of that size a layer) and runs one batched product
  per projection.

The router runs in f32 and its top-k probabilities are renormalised. Top-k
is a stable descending sort, so ties go to the lower expert index, as
``lax.top_k`` breaks them. Parameters: ``router`` [D, E], ``gate`` and
``up`` [E, D, F], ``down`` [E, F, D].

Inside ``rows_split_over(mesh, axes)`` (a sharded train or logprob step,
a sharded rollout: each rank holds its share of the token batch, split
over ``axes`` of ``mesh``) the layer's batch-wide quantities are those of
the whole batch, as the JAX package's layer sees the global batch: the
capacity counts every rank's tokens, a (token, choice) claims its slot
after every claim of earlier choices and of the tokens before it in the
global [B, S] order, and the auxiliary loss's mean router probabilities
and expert loads are all-reduced (the probabilities' gradient all-reduced
back, since every rank's loss adds its share of the one auxiliary loss).
Where only rows are split (the batch axes), the slot order takes one
all-gather of the ranks' [k, E] claim counts; where the context axis
splits the sequence too (ring attention), the ranks' expert choices are
all-gathered and the slots counted over the whole [B, S] grid.

Under a tensor axis (``tp``, the group whose ranks hold partial outputs)
the columns of each expert are split and the caller all-reduces the
output after ``down``; the router is whole on every rank and routes
alike. Under an expert axis (``ep``, the expert group; ``tp`` is then the
expert x tensor group) a rank holds ``E / ep`` whole experts (its block
of ``gate``/``up``/``down`` along E) and sees every token of its rows, as
the JAX package's partition rules put the experts on the expert axis and
the rows on the batch axes only: it computes the (token, choice) pairs
routed to its experts, from the whole routing (the capacity slots of
every expert are known on every rank), and the caller's all-reduce adds
the other ranks' experts. The expert products take the input through
``copy_to`` (their partial gradients are summed over the group) and the
router takes it as it is, its combine weights through ``copy_to`` too:
the weights' gradient from the rank's partial expert outputs is summed
over the group, so that the router's gradient is whole on every rank, as
a replicated leaf's, and the auxiliary loss, the same on every rank of
the group, is counted once.

``moe_layer_dropless_ep`` is the JAX package's expert-parallel dropless
layer (a ``shard_map`` with ``lax.ragged_all_to_all`` and
``lax.ragged_dot``, XLA ops, not Pallas kernels): the batch split over the
expert axis, each rank's (token, choice) pairs sent to the ranks that
hold their experts by ``collectives.all_to_all`` and back
(``FORCE_RAGGED``).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rlinf_tpu_torch.parallel import collectives as C
from rlinf_tpu_torch.utils.device import resolve_device

#: None = auto (the sized all-to-all on every backend); True/False pins
#: ``moe_layer_dropless_ep``'s exchange: the sized all-to-all
#: (``collectives.all_to_all``), or the all-gather emulation of the JAX
#: package's CPU branch
FORCE_RAGGED: Optional[bool] = None

_ROW_SPLIT: contextvars.ContextVar = contextvars.ContextVar("rlinf_moe_rows",
                                                            default=(None, (), None))


@contextlib.contextmanager
def rows_split_over(mesh, axes=(), real_rows: Optional[int] = None):
    """Inside the block, the token batch of every MoE layer is this rank's
    share of a batch split over ``axes`` of ``mesh`` (the batch axes split
    the rows; the context axis, where it is named, the sequence): its
    capacity, slot order and statistics count the whole batch. A mesh of
    None, or no axis of size > 1, means the whole batch is this rank's.
    ``real_rows``: only the batch's first rows hold tokens, the rest pad it
    to a multiple of the batch axes (a token-budget microbatch): the
    padding rows claim no slot and count in no statistic."""
    token = _ROW_SPLIT.set((mesh, tuple(axes) if not isinstance(axes, str) else (axes,),
                            real_rows))
    try:
        yield
    finally:
        _ROW_SPLIT.reset(token)


def row_split():
    """(mesh, axes, real_rows) of the ``rows_split_over`` active here
    ((None, (), None) outside one)."""
    return _ROW_SPLIT.get()


@dataclasses.dataclass(frozen=True)
class _Split:
    """The active row split: the group over its axes (None: no split), how
    many of its ranks split the sequence (the context axis, innermost in
    the group's rank order) and the global rows that hold tokens."""

    group: object = None
    seq: int = 1
    real_rows: Optional[int] = None

    def counted(self, B: int, S: int, device) -> Tuple[Optional[torch.Tensor], int]:
        """(which of this rank's B x S tokens count, [B*S] bool or None for
        all; the whole batch's count of tokens)."""
        n = C.group_size(self.group)
        if self.real_rows is None or self.real_rows >= B * (n // self.seq):   # no padding
            return None, B * S * n
        block = 0 if self.group is None else torch.distributed.get_rank(self.group) // self.seq
        rows = torch.arange(B, device=device) + block * B
        valid = (rows < self.real_rows)[:, None].expand(B, S).reshape(-1)
        return valid, self.real_rows * S * self.seq


def _split_now() -> _Split:
    mesh, axes, real_rows = _ROW_SPLIT.get()
    if mesh is None or not axes:
        return _Split()
    from rlinf_tpu_torch.parallel.mesh import AxisNames as Ax

    return _Split(mesh.get_group(axes), mesh.size(Ax.CONTEXT) if Ax.CONTEXT in axes else 1,
                  real_rows)


def _token_sum(probs: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    """The router probabilities summed over the tokens that count."""
    return probs.sum(dim=0) if valid is None else (probs * valid[:, None]).sum(dim=0)


def _sum_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the ranks that split the rows, forward and backward (every
    rank's loss adds its share of one auxiliary loss)."""
    if group is None:
        return x
    return C.all_reduce(C.copy_to(x, group), group)


def _count_rows(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else C.all_reduce_(x.clone(), "sum", group)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    num_experts_per_token: int = 2
    capacity_factor: float = 1.5
    aux_loss_coef: float = 0.01
    #: "capacity" (drops at capacity) | "dropless" (sorted grouped products)
    impl: str = "capacity"


def init_moe_params(seed: int, hidden: int, ffn: int, moe: MoEConfig, dtype,
                    device="cuda") -> Dict[str, torch.Tensor]:
    """normal(0.02) router and expert weights, drawn with numpy from ``seed``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    E = moe.num_experts

    def init(shape):
        a = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
        return a.to(device=dev).to(dtype) * 0.02

    return {
        "router": init((hidden, E)),
        "gate": init((E, hidden, ffn)),
        "up": init((E, hidden, ffn)),
        "down": init((E, ffn, hidden)),
    }


def moe_layer(params: Dict[str, torch.Tensor], x: torch.Tensor,
              moe: MoEConfig, tp=None, ep=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch on ``moe.impl``. Returns (output [B, S, D], aux_loss);
    under ``tp`` the output is this rank's partial sum, and under ``ep``
    this rank holds its block of the experts and the partial sum is f32
    (see the module docstring)."""
    if moe.impl == "dropless":
        out, aux, _ = moe_layer_dropless(params, x, moe, tp, ep)
        return out, aux
    if moe.impl != "capacity":
        raise ValueError(f"moe impl must be 'capacity' or 'dropless', got {moe.impl!r}")
    return moe_layer_capacity(params, x, moe, tp, ep)


def _local_experts(params: Dict[str, torch.Tensor], ep) -> Tuple[int, int]:
    """(first expert, number of experts) this rank holds: its block along
    E under the expert group ``ep``, all of them without one."""
    n = params["gate"].shape[0]
    return (0 if ep is None else torch.distributed.get_rank(ep) * n), n


def _route(params: Dict[str, torch.Tensor], tokens: torch.Tensor, moe: MoEConfig):
    """f32 router softmax + renormalised top-k. tokens [N, D] ->
    (probs [N, E], topk_probs [N, k], topk_idx [N, k])."""
    logits = tokens.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    sorted_probs, sorted_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = moe.num_experts_per_token
    topk_probs, topk_idx = sorted_probs[:, :k], sorted_idx[:, :k]
    topk_probs = topk_probs / topk_probs.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return probs, topk_probs, topk_idx


def capacity_of(n_tokens: int, moe: MoEConfig) -> int:
    """Slots per expert of the capacity path (Python's round, as in JAX)."""
    E, k = moe.num_experts, moe.num_experts_per_token
    return int(max(1, round(n_tokens * k / E * moe.capacity_factor)))


def _slots(topk_idx: torch.Tensor, E: int, capacity: int, split: _Split = _Split(),
           rows: int = 1, valid: Optional[torch.Tensor] = None):
    """Choice-major (expert [kN], position in expert [kN], kept [kN]): the
    position counts every earlier claim on the expert, dropped ones too;
    under ``split`` also the claims of the tokens before this rank's in the
    global order (``split.seq`` > 1: its ranks split the sequence of this
    rank's ``rows`` rows too, see ``_global_positions``). A token that
    ``valid`` [N] leaves out (padding) claims nothing and is not kept."""
    flat_expert = topk_idx.T.reshape(-1)
    k = topk_idx.shape[1]
    counts_too = None if valid is None else valid.repeat(k)     # choice-major
    group = split.group
    if group is not None and split.seq > 1:
        pos = _global_positions(topk_idx, E, group, split.seq, rows, split.real_rows)
        kept = pos < capacity
        return flat_expert, pos, kept if counts_too is None else kept & counts_too
    onehot = F.one_hot(flat_expert, E)
    if counts_too is not None:
        onehot = onehot * counts_too[:, None]
    if group is None:
        pos = ((onehot.cumsum(dim=0) - onehot) * onehot).sum(dim=-1)
    else:
        per = onehot.view(k, -1, E)                                  # [k, N, E]
        counts = C.gather_tensor(per.sum(dim=1)[None], 0, group)     # [R, k, E]
        me = torch.distributed.get_rank(group)
        before = counts[:me].sum(dim=0) + F.pad(counts.sum(dim=0).cumsum(dim=0)[:-1],
                                                (0, 0, 1, 0))
        prefix = per.cumsum(dim=1) - per + before[:, None, :]
        pos = (prefix * per).sum(dim=-1).reshape(-1)
    kept = pos < capacity
    return flat_expert, pos, kept if counts_too is None else kept & counts_too


def _global_positions(topk_idx: torch.Tensor, E: int, group, seq: int, rows: int,
                      real_rows: Optional[int] = None) -> torch.Tensor:
    """Choice-major slot positions [kN] of this rank's (token, choice)
    pairs where the ranks of ``group`` split a [B, S] batch into blocks of
    ``rows`` rows x S/seq positions (rank index = row block * seq +
    sequence chunk): the expert choices of every rank are gathered, laid
    out on the global grid, and each position counts the claims before it
    in the global choice-major order (rows from ``real_rows`` on claim
    nothing)."""
    N, k = topk_idx.shape
    s = N // rows
    got = C.gather_tensor(topk_idx.reshape(1, rows, s, k), 0, group)   # [R, rows, s, k]
    nb = got.shape[0] // seq
    grid = got.view(nb, seq, rows, s, k).permute(4, 0, 2, 1, 3).reshape(k, nb * rows, seq * s)
    onehot = F.one_hot(grid.reshape(-1), E)
    if real_rows is not None:
        claims = (torch.arange(nb * rows, device=grid.device) < real_rows)
        onehot = onehot * claims[None, :, None].expand(k, -1, seq * s).reshape(-1, 1)
    pos = ((onehot.cumsum(dim=0) - onehot) * onehot).sum(dim=-1).view(k, nb * rows, seq * s)
    me = torch.distributed.get_rank(group)
    b0, c0 = (me // seq) * rows, (me % seq) * s
    return pos[:, b0:b0 + rows, c0:c0 + s].reshape(-1)


def moe_layer_capacity(params: Dict[str, torch.Tensor], x: torch.Tensor,
                       moe: MoEConfig, tp=None, ep=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity dispatch by index. Returns (output [B, S, D], aux_loss)."""
    B, S, D = x.shape
    E, k = moe.num_experts, moe.num_experts_per_token
    N = B * S
    split = _split_now()
    group = split.group
    valid, N_all = split.counted(B, S, x.device)                # the whole batch's tokens
    tokens = x.reshape(N, D)
    probs, topk_probs, topk_idx = _route(params, tokens, moe)
    tokens, topk_probs = C.copy_to(tokens, tp), C.copy_to(topk_probs, tp)
    cap = capacity_of(N_all, moe)
    flat_expert, pos, kept = _slots(topk_idx, E, cap, split, B, valid)
    lo, n_local = _local_experts(params, ep)
    mine = kept & (flat_expert >= lo) & (flat_expert < lo + n_local)
    token_of = torch.arange(N, device=x.device).repeat(k)       # choice-major
    # slot n_local*cap is a zero row that the dropped pairs (and, under an
    # expert axis, the pairs of other ranks' experts) read
    slot = torch.where(mine, (flat_expert - lo) * cap + pos, n_local * cap)
    src = torch.where(mine[:, None], tokens[token_of], torch.zeros((), dtype=x.dtype, device=x.device))
    expert_in = torch.zeros(n_local * cap + 1, D, dtype=x.dtype, device=x.device).index_copy(
        0, slot, src)
    expert_in = expert_in[:n_local * cap].view(n_local, cap, D)

    h = F.silu(torch.bmm(expert_in, params["gate"])) * torch.bmm(expert_in, params["up"])
    expert_out = torch.bmm(h, params["down"]).reshape(n_local * cap, D)
    expert_out = torch.cat([expert_out, expert_out.new_zeros(1, D)])

    y = expert_out[slot].view(k, N, D).float()                  # [k, N, D]
    w = topk_probs.T.to(x.dtype).float()                        # [k, N]
    # under an expert axis the partial sum stays f32 for the all-reduce, so
    # that the choices are added in f32 and rounded once, as without one
    out = (y * w[..., None]).sum(dim=0).to(x.dtype if ep is None else torch.float32)
    out = out.view(B, S, D)

    if group is None and valid is None:
        me = probs.mean(dim=0)
    else:
        me = _sum_rows(_token_sum(probs, valid), group) / N_all
    counts = _count_rows(torch.bincount(flat_expert[kept], minlength=E).float(), group)
    ce = counts / N_all / k
    aux = moe.aux_loss_coef * E * (me * ce).sum()
    return out, aux


def _grouped_swiglu(xs: torch.Tensor, sorted_expert: torch.Tensor, lo: int,
                    params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The SwiGLU experts on rows ``xs`` [M, D] sorted by expert, each row
    by its expert ``sorted_expert`` [M] (ascending); the experts ``[lo, lo + n)`` are
    those of ``params`` (``gate``/``up`` [n, D, F], ``down`` [n, F, D]) and
    a row of another expert gives 0. The groups are padded to the largest
    one for one batched product a projection (one host read of its size)."""
    n, D = params["gate"].shape[0], xs.shape[1]
    local = (sorted_expert >= lo) & (sorted_expert < lo + n)
    le = torch.where(local, sorted_expert - lo, n)              # n: not this rank's
    sizes = torch.bincount(le, minlength=n + 1)
    # each row's place in its expert's group: the rows are sorted by expert
    rank = torch.arange(xs.shape[0], device=xs.device) - torch.searchsorted(
        sorted_expert, sorted_expert)
    M = int(sizes[:n].max()) if n else 0                        # one host read a layer
    row = torch.where(local, le * M + rank, n * M)              # n*M: a spare row
    buf = torch.zeros(n * M + 1, D, dtype=xs.dtype, device=xs.device).index_copy(0, row, xs)
    grouped = buf[:n * M].view(n, M, D)
    g = torch.bmm(grouped, params["gate"])
    u = torch.bmm(grouped, params["up"])
    h = F.silu(g.float()).to(xs.dtype) * u
    ys = torch.bmm(h, params["down"]).view(n * M, D)
    return torch.cat([ys, ys.new_zeros(1, D)])[row]


def moe_layer_dropless(params: Dict[str, torch.Tensor], x: torch.Tensor, moe: MoEConfig,
                       tp=None, ep=None
                       ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Zero-drop MoE: stable-sort (token, choice) pairs by expert, run the
    experts as batched products over the groups padded to the largest one,
    scatter-add back. Returns (out [B, S, D], aux_loss, metrics)."""
    B, S, D = x.shape
    E, K = moe.num_experts, moe.num_experts_per_token
    N = B * S
    tokens = x.reshape(N, D)
    probs, topk_probs, topk_idx = _route(params, tokens, moe)
    tokens, topk_probs = C.copy_to(tokens, tp), C.copy_to(topk_probs, tp)

    flat_expert = topk_idx.reshape(N * K)                       # token-major
    order = torch.sort(flat_expert, stable=True).indices
    token_of = order // K
    group_sizes = torch.bincount(flat_expert, minlength=E)
    lo, _ = _local_experts(params, ep)
    ys = _grouped_swiglu(tokens[token_of], flat_expert[order], lo, params)   # [NK, D] sorted

    w = topk_probs.reshape(N * K)[order].to(x.dtype)
    acc = x.dtype if ep is None else torch.float32       # as the capacity path
    out = torch.zeros(N, D, dtype=acc, device=x.device).index_add(
        0, token_of, (ys * w[:, None]).to(acc))

    split = _split_now()
    group = split.group
    valid, N_all = split.counted(B, S, x.device)                # the whole batch's tokens
    if group is None and valid is None:
        me = probs.mean(dim=0)
    else:
        me = _sum_rows(_token_sum(probs, valid), group) / N_all
    if valid is not None:
        group_sizes = torch.bincount(flat_expert[valid.repeat_interleave(K)], minlength=E)
    sizes = _count_rows(group_sizes.float(), group)
    ce = sizes / float(N_all * K)
    aux = moe.aux_loss_coef * E * (me * ce).sum()
    load = sizes * (E / float(N_all * K))
    metrics = {
        "moe_overflow_frac": torch.zeros((), device=x.device),
        "moe_max_load": load.max(),
        "moe_min_load": load.min(),
    }
    return out.view(B, S, D), aux, metrics


def capacity_overflow_frac(params: Dict[str, torch.Tensor], x: torch.Tensor,
                           moe: MoEConfig) -> torch.Tensor:
    """Fraction of (token, choice) routings the capacity path drops."""
    B, S, _ = x.shape
    N = B * S
    _, _, topk_idx = _route(params, x.reshape(N, -1), moe)
    _, _, kept = _slots(topk_idx, moe.num_experts, capacity_of(N, moe))
    return 1.0 - kept.float().sum() / float(N * moe.num_experts_per_token)


def moe_layer_dropless_ep(params: Dict[str, torch.Tensor], x: torch.Tensor, moe: MoEConfig,
                          mesh, axis: str = "expert") -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel dropless MoE over the ``axis`` group of ``mesh``:
    ``x`` [B/ep, S, D] is this rank's block of the batch, ``router`` whole,
    ``gate``/``up``/``down`` this rank's E/ep experts. Returns (this
    rank's output [B/ep, S, D], the global auxiliary loss).

    Per rank, as the JAX package's ``shard_map``: route the local tokens;
    stable-sort the (token, choice) pairs by global expert (the chunk for
    each rank is then contiguous); all-gather the [ep] send sizes into the
    [ep, ep] size matrix; send the pairs and their expert ids to the ranks
    that hold the experts; run the local experts' grouped products; send
    the results back by the transposed matrix; unsort and scatter-add them
    weighted by the gates. The JAX package receives into a buffer of
    ``M * ep`` rows whose unused rows (zeros, expert id E) go through a
    zero-weight padding group and are never sent back; the port receives
    exactly the rows sent, so that no row differs and none is padding.

    The Switch auxiliary loss is made from the all-reduced router means and
    loads (the JAX package's ``psum``), the same on every rank; its
    all-reduce passes the gradient through as it is, so that each rank's
    probabilities get the loss's gradient once. The router enters through
    ``copy_to``: its gradient (each rank's reaches only its own tokens'
    gates) is summed over the group, whole on every rank, as the gradient
    of the JAX package's replicated input."""
    group = mesh.get_group(axis)
    ep = mesh.size(axis)
    E, K = moe.num_experts, moe.num_experts_per_token
    if E % ep:
        raise ValueError(f"num_experts {E} not divisible by mesh.{axis}={ep}")
    n_local = E // ep
    if params["gate"].shape[0] != n_local:
        raise ValueError(f"gate holds {params['gate'].shape[0]} experts; this rank's block "
                         f"under mesh.{axis}={ep} is {n_local}")
    me_idx = mesh.axis_index(axis)
    b, s, D = x.shape
    n = b * s
    tokens = x.reshape(n, D)
    router = C.copy_to(params["router"], group)
    probs, topk_probs, topk_idx = _route({"router": router}, tokens, moe)
    flat_expert = topk_idx.reshape(n * K)
    order = torch.sort(flat_expert, stable=True).indices
    token_of = order // K
    xs = tokens[token_of]                                       # [M, D] by expert
    sorted_expert = flat_expert[order]

    counts = torch.bincount(flat_expert, minlength=E)
    send = counts.view(ep, n_local).sum(dim=-1)
    sizes = C.gather_tensor(send[None], 0, group).cpu()         # [ep, ep]: row i sends
    send_sizes, recv_sizes = sizes[me_idx].tolist(), sizes[:, me_idx].tolist()
    ragged = True if FORCE_RAGGED is None else FORCE_RAGGED
    if ragged:
        recv_x = C.all_to_all(xs, send_sizes, recv_sizes, group)
        with torch.no_grad():
            recv_e = C.all_to_all(sorted_expert, send_sizes, recv_sizes, group)
    else:
        recv_x = _gathered_rows(C.all_gather(xs, 0, group), sizes, me_idx)
        recv_e = _gathered_rows(C.gather_tensor(sorted_expert, 0, group), sizes, me_idx)

    order2 = torch.sort(recv_e, stable=True).indices
    ys2 = _grouped_swiglu(recv_x[order2], recv_e[order2], me_idx * n_local, params)
    recv_y = torch.empty_like(ys2).index_copy(0, order2, ys2)
    if ragged:
        ys = C.all_to_all(recv_y, recv_sizes, send_sizes, group)
    else:
        # every rank's buffer of M * ep rows (the most it can receive), as JAX's
        cap = n * K * ep
        padded = F.pad(recv_y, (0, 0, 0, cap - recv_y.shape[0]))
        ys = _gathered_rows(C.all_gather(padded, 0, group), sizes.T, me_idx)

    w = topk_probs.reshape(n * K)[order].to(x.dtype)
    out = torch.zeros(n, D, dtype=x.dtype, device=x.device).index_add(0, token_of, ys * w[:, None])

    n_total = n * ep
    me_g = C.all_reduce(probs.sum(dim=0), group) / n_total
    ce_g = _count_rows(counts.float(), group) / (n_total * K)
    aux = moe.aux_loss_coef * E * (me_g * ce_g).sum()
    return out.view(b, s, D), aux


def _gathered_rows(gathered: torch.Tensor, sizes: torch.Tensor, me: int) -> torch.Tensor:
    """The rows rank ``me`` receives, cut from every rank's buffer
    all-gathered along dim 0 (``sizes[i, j]``: the rows rank i sends rank j,
    each rank's buffer holding its chunks in rank order): the JAX
    package's all-gather emulation of the exchange."""
    ep = sizes.shape[0]
    per = gathered.shape[0] // ep
    offsets = sizes.cumsum(dim=1) - sizes
    idx = torch.cat([torch.arange(int(offsets[i, me]), int(offsets[i, me] + sizes[i, me]))
                     + i * per for i in range(ep)]).to(gathered.device)
    return gathered[idx]
