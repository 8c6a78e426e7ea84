"""Scalar value head over LLM hidden states (the critic model).

Port of ``rlinf_tpu/models/llm/value_head.py``. The critic either shares
the trunk with the actor (one params dict with a ``value_head`` leaf) or
is a params dict of its own (``training/critic.py``). Under a mesh the head
is replicated (``value_partition_rules``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from rlinf_tpu_torch.models.llm import model as M
from rlinf_tpu_torch.models.llm.config import LLMConfig
from rlinf_tpu_torch.utils.device import resolve_device


def init_value_head(cfg: LLMConfig, seed: int, device="cuda") -> torch.Tensor:
    """[D, 1] f32 head, near-zero init (values start ~0): normal x 0.01,
    drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((cfg.hidden_size, 1), dtype=np.float32))
    return a.to(resolve_device(device)) * 0.01


def add_value_head(params: M.Params, cfg: LLMConfig, seed: int, device="cuda") -> M.Params:
    out = dict(params)
    out["value_head"] = init_value_head(cfg, seed, device)
    return out


def values_from_hidden(params: M.Params, hidden: torch.Tensor) -> torch.Tensor:
    """f32 values [B, T] of hidden states [B, T, D] (the JAX einsum with
    ``preferred_element_type=f32``: the trunk's dtype widened to f32)."""
    return (hidden.float() @ params["value_head"].float())[..., 0]


def forward_values(
    params: M.Params,
    cfg: LLMConfig,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    *,
    attn_impl: str = "xla",
    remat=False,
) -> torch.Tensor:
    """Token-level values [B, T] in fp32."""
    hidden, _ = M.forward_hidden(
        params, cfg, input_ids, attention_mask=attention_mask,
        attn_impl=attn_impl, remat=remat,
    )
    return values_from_hidden(params, hidden)


def value_partition_rules():
    """The value head's rule: replicated (it is [D, 1])."""
    from rlinf_tpu_torch.parallel.sharding import P

    return [(r"value_head", P())]
