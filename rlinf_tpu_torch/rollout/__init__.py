"""Rollout engines on the card.

Port of ``rlinf_tpu/rollout/__init__.py``: static batch generation,
continuous slot-pool batching, or paged-KV continuous batching. "auto"
knobs resolve on the DEVICE the engine runs on: int8 weights and the
hand-written kernels on CUDA, no quantization and the plain versions on
the CPU. Only sharded rollout (``mesh=``) is not ported.
"""

import torch

from rlinf_tpu_torch.rollout.engine import RolloutEngine
from rlinf_tpu_torch.utils.device import resolve_device

__all__ = [
    "RolloutEngine",
    "build_rollout_engine",
    "resolve_rollout_paths",
    "resolve_recompute_logprobs",
]


def resolve_rollout_paths(cfg, mesh=None, device="cuda"):
    """Resolve the ``auto`` knobs: -> (engine, weight_quant, decode_attn)."""
    on_cuda = torch.device(device).type == "cuda"
    ro = cfg.rollout
    engine = ro.engine
    if engine == "auto":
        engine = "static" if mesh is not None else "continuous"
    quant = ro.weight_quant
    if quant == "auto":
        quant = "int8" if on_cuda else "none"
    decode_attn = ro.decode_attn_impl or ("pallas" if on_cuda else "xla")
    return engine, quant, decode_attn


def resolve_recompute_logprobs(cfg, mesh=None, device="cuda") -> bool:
    """The rollout/training logprob-consistency invariant.

    ``algorithm.recompute_logprobs=None`` resolves to True whenever the
    rollout decode path is a different computation from the training path
    (int8 decode weights, an int8 KV cache, or a decode attention other than
    the training one), so engine-reported behaviour logprobs are never fed
    into a plain PPO ratio as if on-policy.
    """
    explicit = cfg.algorithm.recompute_logprobs
    if explicit is not None:
        return bool(explicit)
    _, quant, decode_attn = resolve_rollout_paths(cfg, mesh=mesh, device=device)
    return (
        quant != "none"
        or cfg.rollout.kv_quant != "none"
        or decode_attn != cfg.attn_impl
    )


def build_rollout_engine(cfg, mesh=None, device="cuda"):
    """Build the rollout engine selected by ``cfg.rollout``.

    "auto" resolves to static under a mesh and continuous otherwise, as in
    the JAX package.
    """
    device = resolve_device(device)
    if mesh is not None:
        raise NotImplementedError(
            "sharded rollout (mesh=...) comes with the port's parallel slice")
    engine, quant, decode_attn = resolve_rollout_paths(cfg, mesh=mesh, device=device)
    if engine == "static":
        return RolloutEngine(
            cfg.model, cfg.sampling,
            prompt_bucket=cfg.rollout.prompt_bucket,
            attn_impl=cfg.attn_impl,
            decode_attn_impl=cfg.rollout.decode_attn_impl,
            weight_quant=quant,
            device=device,
        )
    ro = cfg.rollout
    max_seq_len = min(
        cfg.model.max_seq_len,
        cfg.data.max_prompt_len + cfg.sampling.max_new_tokens,
    )
    if engine == "continuous":
        from rlinf_tpu_torch.rollout.continuous_engine import ContinuousBatchingEngine

        return ContinuousBatchingEngine(
            cfg.model, cfg.sampling,
            num_slots=ro.num_slots,
            max_seq_len=max_seq_len,
            prompt_bucket=ro.prompt_bucket,
            decode_chunk=ro.decode_chunk,
            weight_quant=quant,
            kv_quant=ro.kv_quant,
            decode_attn_impl=ro.decode_attn_impl,
            attn_impl=cfg.attn_impl,
            device=device,
        )
    if engine == "paged":
        from rlinf_tpu_torch.rollout.paged_engine import PagedContinuousEngine

        return PagedContinuousEngine(
            cfg.model, cfg.sampling,
            num_slots=ro.num_slots,
            max_seq_len=max_seq_len,
            prompt_bucket=ro.prompt_bucket,
            decode_chunk=ro.decode_chunk,
            page_size=ro.page_size,
            attn_impl=decode_attn,
            device=device,
        )
    raise ValueError(f"unknown rollout engine {engine!r}")
