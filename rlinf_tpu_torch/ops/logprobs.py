"""Token logprob and entropy under the lm-head.

Port of ``rlinf_tpu/ops/logprobs.py``. All results are float32. The
chunked plain path never holds more than [B, chunk, V] logits and
recomputes each chunk in the backward (``torch.utils.checkpoint``, as
``jax.checkpoint`` there). On a CUDA device the dispatcher takes the fused
kernels K5/K6 (``ops/cuda/linear_ce.py``), which hold no [rows, V] logits
in the forward at all. Under a mesh the dispatcher gathers the
vocab-sharded lm head whole and launches the kernels on it, as the JAX
package runs its Pallas kernel on a gathered operand (a per-shard K5 whose
statistics merge across ranks is later work, ROADMAP.md §B).
``vocab_parallel_logprobs_and_entropy`` is the explicit tensor-parallel
form over a vocab-sharded head: per-shard max and sum of exponentials,
reduced over the tensor axis.
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
    from rlinf_tpu_torch.models.llm.model import full_output_params, lm_head_weight
    from rlinf_tpu_torch.models.llm.quant import QTensor

    params = full_output_params(params, cfg)
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


def vocab_parallel_logprobs_and_entropy(
    hidden: torch.Tensor,
    lm_head: torch.Tensor,
    target_ids: torch.Tensor,
    *,
    mesh,
    vocab_axis: str,
    temperature: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tensor-parallel logprob/entropy over a vocab-sharded lm head.

    hidden: [B, S, D] (the same on every rank of ``vocab_axis``); lm_head:
    this rank's [D, V/tp] block (columns [lo, lo + V/tp)); target_ids:
    [B, S]. Per-shard max and sum of exponentials are reduced across the
    axis (all-reduce MAX, then SUM: the JAX package's ``pmax``/``psum``),
    and the target logit comes from the shard that owns it. Forward only
    (no autograd through the reductions)."""
    from rlinf_tpu_torch.parallel import collectives as C

    group = mesh.get_group(vocab_axis)
    v_local = lm_head.shape[1]
    lo = mesh.axis_index(vocab_axis) * v_local
    logits = hidden.float() @ lm_head.float()
    if temperature != 1.0:
        logits = logits / temperature
    gmax = C.all_reduce_(logits.amax(dim=-1), "max", group)
    shifted = logits - gmax[..., None]
    e = torch.exp(shifted)
    ids = target_ids.long()
    in_shard = (ids >= lo) & (ids < lo + v_local)
    tgt = logits.gather(-1, (ids - lo).clamp(0, v_local - 1)[..., None])[..., 0]
    stats = torch.stack([e.sum(-1), torch.where(in_shard, tgt, 0.0), (e * logits).sum(-1)])
    gsumexp, target_logit, probs_sum = C.all_reduce_(stats, "sum", group).unbind(0)
    lse = torch.log(gsumexp) + gmax
    return target_logit - lse, lse - probs_sum / gsumexp
