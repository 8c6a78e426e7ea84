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
``up`` [E, D, F], ``down`` [E, F, D]. The expert-parallel
``moe_layer_dropless_ep`` (``shard_map``) comes with the expert axis
(ROADMAP.md §A.9b.3).

Inside ``rows_split_over(group)`` (a sharded train or logprob step: each
rank holds its share of the rows of the token batch, the ranks of
``group`` in order) the layer's batch-wide quantities are those of the
whole batch, as the JAX package's layer sees the global batch: the
capacity counts every rank's tokens, a (token, choice) claims its slot
after every claim of earlier choices and of earlier ranks' tokens (one
all-gather of the [k, E] claim counts), and the auxiliary loss's mean
router probabilities and expert loads are all-reduced (the probabilities'
gradient all-reduced back, since every rank's loss adds its share of the
one auxiliary loss). Under a tensor axis (``tp``, the tensor group) the
columns of each expert are split and the caller all-reduces the output
after ``down``; the router is whole on every tensor rank and routes
alike. The expert products take the input through ``copy_to`` (their
partial gradients are summed over the group) and the router takes it as
it is, its combine weights through ``copy_to`` too: the weights' gradient
from the rank's partial expert outputs is summed over the group, so that
the router's gradient is whole on every rank, as a replicated leaf's.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rlinf_tpu_torch.parallel import collectives as C
from rlinf_tpu_torch.utils.device import resolve_device

_ROW_GROUP: contextvars.ContextVar = contextvars.ContextVar("rlinf_moe_rows", default=None)


@contextlib.contextmanager
def rows_split_over(group):
    """Inside the block, the token batch of every MoE layer is this rank's
    share of rows split over ``group`` (None: the whole batch)."""
    token = _ROW_GROUP.set(group)
    try:
        yield
    finally:
        _ROW_GROUP.reset(token)


def row_group():
    """The group of ``rows_split_over`` active here (None outside one)."""
    return _ROW_GROUP.get()


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
              moe: MoEConfig, tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch on ``moe.impl``. Returns (output [B, S, D], aux_loss);
    under ``tp`` the output is this rank's partial sum (see the module
    docstring)."""
    if moe.impl == "dropless":
        out, aux, _ = moe_layer_dropless(params, x, moe, tp)
        return out, aux
    if moe.impl != "capacity":
        raise ValueError(f"moe impl must be 'capacity' or 'dropless', got {moe.impl!r}")
    return moe_layer_capacity(params, x, moe, tp)


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


def _slots(topk_idx: torch.Tensor, E: int, capacity: int, group=None):
    """Choice-major (expert [kN], position in expert [kN], kept [kN]): the
    position counts every earlier claim on the expert, dropped ones too;
    under ``group`` also the claims of the ranks before this one."""
    flat_expert = topk_idx.T.reshape(-1)
    onehot = F.one_hot(flat_expert, E)
    if group is None:
        pos = ((onehot.cumsum(dim=0) - onehot) * onehot).sum(dim=-1)
        return flat_expert, pos, pos < capacity
    k = topk_idx.shape[1]
    per = onehot.view(k, -1, E)                                  # [k, N, E]
    counts = C.gather_tensor(per.sum(dim=1)[None], 0, group)     # [R, k, E]
    me = torch.distributed.get_rank(group)
    before = counts[:me].sum(dim=0) + F.pad(counts.sum(dim=0).cumsum(dim=0)[:-1], (0, 0, 1, 0))
    prefix = per.cumsum(dim=1) - per + before[:, None, :]
    pos = (prefix * per).sum(dim=-1).reshape(-1)
    return flat_expert, pos, pos < capacity


def moe_layer_capacity(params: Dict[str, torch.Tensor], x: torch.Tensor,
                       moe: MoEConfig, tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity dispatch by index. Returns (output [B, S, D], aux_loss)."""
    B, S, D = x.shape
    E, k = moe.num_experts, moe.num_experts_per_token
    N = B * S
    group = _ROW_GROUP.get()
    N_all = N * C.group_size(group)                             # the whole batch's tokens
    tokens = x.reshape(N, D)
    probs, topk_probs, topk_idx = _route(params, tokens, moe)
    tokens, topk_probs = C.copy_to(tokens, tp), C.copy_to(topk_probs, tp)
    cap = capacity_of(N_all, moe)
    flat_expert, pos, kept = _slots(topk_idx, E, cap, group)
    token_of = torch.arange(N, device=x.device).repeat(k)       # choice-major
    # slot E*cap is a zero row that the dropped pairs read
    slot = torch.where(kept, flat_expert * cap + pos, E * cap)
    src = torch.where(kept[:, None], tokens[token_of], torch.zeros((), dtype=x.dtype, device=x.device))
    expert_in = torch.zeros(E * cap + 1, D, dtype=x.dtype, device=x.device).index_copy(
        0, slot, src)
    expert_in = expert_in[:E * cap].view(E, cap, D)

    h = F.silu(torch.bmm(expert_in, params["gate"])) * torch.bmm(expert_in, params["up"])
    expert_out = torch.bmm(h, params["down"]).reshape(E * cap, D)
    expert_out = torch.cat([expert_out, expert_out.new_zeros(1, D)])

    y = expert_out[slot].view(k, N, D).float()                  # [k, N, D]
    w = topk_probs.T.to(x.dtype).float()                        # [k, N]
    out = (y * w[..., None]).sum(dim=0).to(x.dtype).view(B, S, D)

    if group is None:
        me = probs.mean(dim=0)
    else:
        me = _sum_rows(probs.sum(dim=0), group) / N_all
    counts = _count_rows(torch.bincount(flat_expert[kept], minlength=E).float(), group)
    ce = counts / N_all / k
    aux = moe.aux_loss_coef * E * (me * ce).sum()
    return out, aux


def moe_layer_dropless(params: Dict[str, torch.Tensor], x: torch.Tensor, moe: MoEConfig,
                       tp=None) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
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
    sorted_expert = flat_expert[order]
    group_sizes = torch.bincount(flat_expert, minlength=E)
    starts = group_sizes.cumsum(0) - group_sizes
    rank = torch.arange(N * K, device=x.device) - starts[sorted_expert]
    M = int(group_sizes.max())                                  # one host read a layer
    row = sorted_expert * M + rank
    xs = torch.zeros(E * M, D, dtype=x.dtype, device=x.device).index_copy(
        0, row, tokens[token_of]).view(E, M, D)

    g = torch.bmm(xs, params["gate"])
    u = torch.bmm(xs, params["up"])
    h = F.silu(g.float()).to(x.dtype) * u
    ys = torch.bmm(h, params["down"]).view(E * M, D)[row]       # [NK, D] sorted

    w = topk_probs.reshape(N * K)[order].to(x.dtype)
    out = torch.zeros(N, D, dtype=x.dtype, device=x.device).index_add(0, token_of, ys * w[:, None])

    group = _ROW_GROUP.get()
    N_all = N * C.group_size(group)                             # the whole batch's tokens
    if group is None:
        me = probs.mean(dim=0)
    else:
        me = _sum_rows(probs.sum(dim=0), group) / N_all
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
