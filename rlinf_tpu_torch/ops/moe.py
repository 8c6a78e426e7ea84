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
``moe_layer_dropless_ep`` (``shard_map``) comes with the parallel slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rlinf_tpu_torch.utils.device import resolve_device


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
              moe: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch on ``moe.impl``. Returns (output [B, S, D], aux_loss)."""
    if moe.impl == "dropless":
        out, aux, _ = moe_layer_dropless(params, x, moe)
        return out, aux
    if moe.impl != "capacity":
        raise ValueError(f"moe impl must be 'capacity' or 'dropless', got {moe.impl!r}")
    return moe_layer_capacity(params, x, moe)


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


def _slots(topk_idx: torch.Tensor, E: int, capacity: int):
    """Choice-major (expert [kN], position in expert [kN], kept [kN]): the
    position counts every earlier claim on the expert, dropped ones too."""
    flat_expert = topk_idx.T.reshape(-1)
    onehot = F.one_hot(flat_expert, E)
    pos = ((onehot.cumsum(dim=0) - onehot) * onehot).sum(dim=-1)
    return flat_expert, pos, pos < capacity


def moe_layer_capacity(params: Dict[str, torch.Tensor], x: torch.Tensor,
                       moe: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity dispatch by index. Returns (output [B, S, D], aux_loss)."""
    B, S, D = x.shape
    E, k = moe.num_experts, moe.num_experts_per_token
    N = B * S
    tokens = x.reshape(N, D)
    probs, topk_probs, topk_idx = _route(params, tokens, moe)
    C = capacity_of(N, moe)
    flat_expert, pos, kept = _slots(topk_idx, E, C)
    token_of = torch.arange(N, device=x.device).repeat(k)       # choice-major
    # slot E*C is a zero row that the dropped pairs read
    slot = torch.where(kept, flat_expert * C + pos, E * C)
    src = torch.where(kept[:, None], tokens[token_of], torch.zeros((), dtype=x.dtype, device=x.device))
    expert_in = torch.zeros(E * C + 1, D, dtype=x.dtype, device=x.device).index_copy(0, slot, src)
    expert_in = expert_in[:E * C].view(E, C, D)

    h = F.silu(torch.bmm(expert_in, params["gate"])) * torch.bmm(expert_in, params["up"])
    expert_out = torch.bmm(h, params["down"]).reshape(E * C, D)
    expert_out = torch.cat([expert_out, expert_out.new_zeros(1, D)])

    y = expert_out[slot].view(k, N, D).float()                  # [k, N, D]
    w = topk_probs.T.to(x.dtype).float()                        # [k, N]
    out = (y * w[..., None]).sum(dim=0).to(x.dtype).view(B, S, D)

    me = probs.mean(dim=0)
    counts = torch.bincount(flat_expert[kept], minlength=E).float()
    ce = counts / N / k
    aux = moe.aux_loss_coef * E * (me * ce).sum()
    return out, aux


def moe_layer_dropless(params: Dict[str, torch.Tensor], x: torch.Tensor, moe: MoEConfig
                       ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Zero-drop MoE: stable-sort (token, choice) pairs by expert, run the
    experts as batched products over the groups padded to the largest one,
    scatter-add back. Returns (out [B, S, D], aux_loss, metrics)."""
    B, S, D = x.shape
    E, K = moe.num_experts, moe.num_experts_per_token
    N = B * S
    tokens = x.reshape(N, D)
    probs, topk_probs, topk_idx = _route(params, tokens, moe)

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

    me = probs.mean(dim=0)
    ce = group_sizes.float() / float(N * K)
    aux = moe.aux_loss_coef * E * (me * ce).sum()
    load = group_sizes.float() * (E / float(N * K))
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
