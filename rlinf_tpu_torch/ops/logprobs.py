"""Token logprob and entropy under the lm-head.

Port of ``rlinf_tpu/ops/logprobs.py``. All results are float32. The
chunked plain path never holds more than [B, chunk, V] logits and
recomputes each chunk in the backward (``torch.utils.checkpoint``, as
``jax.checkpoint`` there). On a CUDA device the dispatcher takes the fused
kernels K5/K6 (``ops/cuda/linear_ce.py``), which hold no [rows, V] logits
in the forward at all. ``vocab_parallel_logprobs_and_entropy`` (a
tensor-parallel reduction over a mesh) comes with the parallel slice.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint


def logprobs_and_entropy_from_logits(
    logits: torch.Tensor,
    target_ids: torch.Tensor,
    temperature: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logprob of target, entropy) per position, in float32.

    logits: [..., V]; target_ids: [...]. Entropy = lse - sum(p * logit).
    """
    logits = logits.float()
    if temperature != 1.0:
        logits = logits / temperature
    lse = torch.logsumexp(logits, dim=-1)
    target_logit = logits.gather(-1, target_ids.long()[..., None])[..., 0]
    probs = torch.softmax(logits, dim=-1)
    entropy = lse - (probs * logits).sum(-1)
    return target_logit - lse, entropy


def token_logprobs_from_logits(
    logits: torch.Tensor, target_ids: torch.Tensor, temperature: float = 1.0
) -> torch.Tensor:
    """The logprob of ``target_ids`` in float32, on the logits' device."""
    return logprobs_and_entropy_from_logits(logits, target_ids, temperature)[0]


def fused_linear_logprobs_and_entropy(
    hidden: torch.Tensor,
    lm_head: torch.Tensor,
    target_ids: torch.Tensor,
    *,
    chunk_size: int = 256,
    temperature: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Logprob/entropy of ``target_ids`` under ``softmax(hidden @ lm_head)``.

    hidden: [B, S, D]; lm_head: [D, V] (or a ``QTensor``); target_ids:
    [B, S]. Runs over S in chunks of ``chunk_size`` (one chunk when S does
    not divide evenly); the logits are an fp32 product of fp32 copies of the
    operands, as the JAX einsum with an fp32 result type.
    """
    from rlinf_tpu_torch.models.llm.quant import QTensor, mm

    S = hidden.shape[1]
    if S % chunk_size != 0:
        chunk_size = S

    def chunk_fn(h, ids):
        if isinstance(lm_head, QTensor):
            logits = mm(h, lm_head).float()
        else:
            logits = h.float() @ lm_head.float()
        return logprobs_and_entropy_from_logits(logits, ids, temperature)

    lps, ents = [], []
    for h, ids in zip(hidden.split(chunk_size, 1), target_ids.split(chunk_size, 1)):
        if torch.is_grad_enabled():
            lp, ent = checkpoint(chunk_fn, h, ids, use_reentrant=False)
        else:
            lp, ent = chunk_fn(h, ids)
        lps.append(lp)
        ents.append(ent)
    return torch.cat(lps, 1), torch.cat(ents, 1)


def linear_logprobs_and_entropy(
    params,
    cfg,
    hidden: torch.Tensor,
    target_ids: torch.Tensor,
    *,
    chunk_size: int = 256,
    temperature: float = 1.0,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatching front-end for the lm-head logprob/entropy computation.

    impl="auto" picks the fused kernels K5/K6 for a CUDA tensor (the tied
    embedding [V, D] taken as it is, "vd"), and the chunked plain path on
    the CPU and for a quantized lm-head, as the JAX package does off TPU.
    impl="pallas" takes the fused path on any device (on the CPU its plain
    version runs).
    """
    from rlinf_tpu_torch.models.llm.model import lm_head_weight
    from rlinf_tpu_torch.models.llm.quant import QTensor

    if impl == "pallas" or (impl == "auto" and hidden.is_cuda):
        from rlinf_tpu_torch.ops.cuda.linear_ce import fused_linear_ce

        if "lm_head" in params and not isinstance(params["lm_head"], QTensor):
            return fused_linear_ce(hidden, params["lm_head"], target_ids,
                                   temperature=temperature, w_layout="dv")
        if "lm_head" not in params and not isinstance(params["embed"], QTensor):
            return fused_linear_ce(hidden, params["embed"], target_ids,
                                   temperature=temperature, w_layout="vd")
    w = lm_head_weight(params, cfg)
    return fused_linear_logprobs_and_entropy(
        hidden, w, target_ids, chunk_size=chunk_size, temperature=temperature)
