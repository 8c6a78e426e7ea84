"""LoRA adapters for the decoder family.

Port of ``rlinf_tpu/models/llm/lora.py``. The decoder's matmul weights are
stacked per layer (``blocks["wq"]: [L, d, q]``), so one adapter per target
is a pair of stacked low-rank factors ``a: [L, in, r]``, ``b: [L, r, out]``
and the merge is one einsum per target over all layers. Training
differentiates the loss with respect to the adapter tree only; the frozen
base params are read, never written (``training/lora_learner.py``).

Under a mesh the base params are this rank's blocks under the model's
partition rules and the adapters are whole on every rank (the JAX
package's layout); ``merge_lora(..., layout=)`` merges per rank on its
blocks: ``a``'s input rows and ``b``'s output columns cut as the target's
block is cut, so that ``a @ b`` is the block of the whole product.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from rlinf_tpu_torch.models.llm.config import LLMConfig
from rlinf_tpu_torch.utils.device import resolve_device

Params = Dict[str, Any]

#: every per-layer matmul weight of the dense decoder; "lm_head" may be added
#: as an unstacked target: it adapts the output projection even of a tied
#: model, whose merged tree then gains an explicit "lm_head" leaf (which
#: ``lm_head_weight`` prefers to the embedding)
DEFAULT_TARGETS: Tuple[str, ...] = ("wq", "wk", "wv", "wo", "gate", "up", "down")


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    """The JAX package's lora block, same fields and defaults."""

    enabled: bool = False
    rank: int = 16
    alpha: float = 32.0
    targets: Tuple[str, ...] = DEFAULT_TARGETS
    path: str = ""          # adapter checkpoint to start from ('' = fresh)

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


def _dims(cfg: LLMConfig) -> Dict[str, Tuple[int, int]]:
    return {
        "wq": (cfg.hidden_size, cfg.q_dim),
        "wk": (cfg.hidden_size, cfg.kv_dim),
        "wv": (cfg.hidden_size, cfg.kv_dim),
        "wo": (cfg.q_dim, cfg.hidden_size),
        "gate": (cfg.hidden_size, cfg.intermediate_size),
        "up": (cfg.hidden_size, cfg.intermediate_size),
        "down": (cfg.intermediate_size, cfg.hidden_size),
    }


def init_lora_params(cfg: LLMConfig, lora_cfg: LoRAConfig, generator: torch.Generator,
                     device="cuda") -> Params:
    """Fresh adapters: ``a ~ N(0, 1/d_in)`` (fan-in), ``b = 0``, so the merged
    model starts exactly at the base model. ``a`` is drawn in f32 on the host
    from ``generator`` (target by target, in ``lora_cfg.targets``' order)
    and cast to the compute dtype."""
    device = resolve_device(device)
    dims, L, r, dt = _dims(cfg), cfg.num_layers, lora_cfg.rank, cfg.compute_dtype

    def pair(shape_a, d_in, d_out_shape):
        a = torch.randn(shape_a, generator=generator, dtype=torch.float32) / math.sqrt(d_in)
        return {"a": a.to(dt).to(device), "b": torch.zeros(d_out_shape, dtype=dt, device=device)}

    out: Params = {"blocks": {}}
    for name in lora_cfg.targets:
        if name == "lm_head":
            d = cfg.hidden_size
            out["lm_head"] = pair((d, r), d, (r, cfg.vocab_size))
            continue
        if name not in dims:
            raise KeyError(f"unknown LoRA target {name!r}; have {sorted(dims) + ['lm_head']}")
        d_in, d_out = dims[name]
        out["blocks"][name] = pair((L, d_in, r), d_in, (L, r, d_out))
    return out


def merge_lora(base_params: Params, lora_params: Params, lora_cfg: LoRAConfig,
               layout=None) -> Params:
    """Effective params: ``W + scaling * (a @ b)`` per target, all layers in
    one f32 einsum, added to ``W`` in f32 and cast to ``W``'s dtype (the JAX
    package's rounding order). Other leaves are the base's tensors, shared.
    ``layout`` (a ``parallel.sharding.Layout`` of the model's params): the
    base leaves are this rank's blocks under it, and each target merges
    its block (see the module docstring)."""
    def cut(ab, spec, lead):
        if layout is None:
            return ab["a"], ab["b"]
        from rlinf_tpu_torch.parallel.sharding import local_block

        spec = tuple(spec) + (None,) * (lead + 2 - len(spec))
        pre = (None,) * lead
        return (local_block(ab["a"], pre + (spec[lead], None), layout.mesh),
                local_block(ab["b"], pre + (None, spec[lead + 1]), layout.mesh))

    merged_blocks = dict(base_params["blocks"])
    for name, ab in lora_params["blocks"].items():
        w = base_params["blocks"][name]
        a, b = cut(ab, layout.specs[f"blocks/{name}"] if layout else (), 1)
        delta = torch.einsum("lir,lro->lio", a.float(), b.float()) * lora_cfg.scaling
        merged_blocks[name] = (w.float() + delta).to(w.dtype)
    merged = dict(base_params)
    merged["blocks"] = merged_blocks
    if "lm_head" in lora_params:
        ab = lora_params["lm_head"]
        w = base_params.get("lm_head")
        if w is None:
            if layout is not None:
                raise NotImplementedError(
                    "a LoRA lm_head target on tied embeddings under a mesh: the merged "
                    "head would have no layout of its own; untie the head or drop the target")
            w = base_params["embed"].T  # tied embeddings
        a, b = cut(ab, layout.specs["lm_head"] if layout else (), 0)
        delta = (a.float() @ b.float()) * lora_cfg.scaling
        merged["lm_head"] = (w.float() + delta).to(w.dtype)
    return merged


def lora_num_params(lora_params: Params) -> int:
    from rlinf_tpu_torch.training.train_state import tree_leaves

    return sum(x.numel() for x in tree_leaves(lora_params))
