"""JAX param tree (as numpy arrays) -> the port's dict of tensors.

The port keeps the JAX package's key names and [D_in, D_out] layouts, so
one random init (or one checkpoint) feeds both packages. A leaf is a numpy
array (bfloat16 arrays from JAX arrive with the ``ml_dtypes`` bfloat16
dtype) or a quantized leaf with ``.q`` and ``.scale`` arrays, which becomes
the port's ``QTensor``. ``cache_from_numpy`` does the same for the decode
state: a stacked int8 cache, per-layer cache tuples or page pools.
"""

from __future__ import annotations

import numpy as np
import torch

from rlinf_tpu_torch.models.llm.config import LLMConfig
from rlinf_tpu_torch.models.llm.quant import QTensor
from rlinf_tpu_torch.utils.device import resolve_device


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """A tensor with its own copy of ``a`` (JAX hands out read-only arrays)."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(resolve_device(device))


def _convert(node, device):
    if isinstance(node, dict):
        return {k: _convert(v, device) for k, v in node.items()}
    if hasattr(node, "q") and hasattr(node, "scale"):
        return QTensor(tensor_from_numpy(node.q, device), tensor_from_numpy(node.scale, device))
    return tensor_from_numpy(node, device)


def params_from_numpy(tree: dict, cfg: LLMConfig, device="cuda") -> dict:
    """Convert a JAX-layout param tree of numpy arrays for ``cfg``."""
    embed_shape = tuple(np.shape(tree["embed"]))
    if embed_shape != (cfg.vocab_size, cfg.hidden_size):
        raise ValueError(
            f"embed shape {embed_shape} does not match the config "
            f"({cfg.vocab_size}, {cfg.hidden_size})")
    return _convert(tree, resolve_device(device))


def cache_from_numpy(tree, device="cuda"):
    """A KV cache of the JAX package given as numpy arrays -> the port's
    tensors with the same nesting: the stacked int8 cache of the megakernel
    ``(kc, vc, ks, vs)``, per-layer ``(k, v[, k_scale, v_scale])`` tuples, or
    per-layer page pools."""
    if isinstance(tree, (tuple, list)):
        return tuple(cache_from_numpy(t, device) for t in tree)
    return tensor_from_numpy(tree, device)
