"""Autoregressive generation: prefill + a decode loop on the packed KV cache.

Port of ``rlinf_tpu/models/llm/sampler.py``. Shapes depend only on the
prompt bucket P and ``max_new_tokens``; finished rows are masked, the
sampling logits are fp32. Rollout logprobs are computed under the
temperature-scaled full softmax: the behaviour policy.

Randomness: the caller's ``torch.Generator`` (on the CPU) gives one 32-bit
seed per sampled step, and the Gumbel noise for that step is the
counter-based Philox of ``ops/cuda/sampler_kernel.py`` keyed by (seed, row,
column). The fused kernel and the plain logits path therefore draw the same
noise from the same generator.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from rlinf_tpu_torch.models.llm import model as M
from rlinf_tpu_torch.models.llm.config import LLMConfig
from rlinf_tpu_torch.models.llm.quant import QTensor
from rlinf_tpu_torch.ops.cuda.decode_megakernel import _check_geometry, decode_step_mega
from rlinf_tpu_torch.ops.cuda.geometry import check_on_card
from rlinf_tpu_torch.ops.cuda.sampler_kernel import (
    fused_lmhead_sample_packed, gumbel_noise, pack_lm_head,
)
from rlinf_tpu_torch.ops.norm import rms_norm
from rlinf_tpu_torch.ops.rope import rope_frequencies
from rlinf_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    max_new_tokens: int = 128
    temperature: float = 1.0
    top_k: int = 0          # 0 = disabled
    top_p: float = 1.0      # 1.0 = disabled
    eos_token_id: int = -1  # -1 = never stop early
    pad_token_id: int = 0
    greedy: bool = False


class GenerateOutput(NamedTuple):
    response_ids: torch.Tensor       # [B, N] int32 (pad after eos)
    response_logprobs: torch.Tensor  # [B, N] fp32 (0 after eos)
    response_mask: torch.Tensor      # [B, N] bool, True for generated incl. eos
    response_lengths: torch.Tensor   # [B] int32


def _next_seed(generator: torch.Generator) -> int:
    return int(torch.randint(0, 2**32, (1,), generator=generator).item())


def _filter_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def _filter_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # Keep tokens until the cumulative prob exceeds p (always keep the argmax).
    cutoff_mask = cum - probs > p
    threshold = torch.where(
        cutoff_mask, sorted_logits, torch.full_like(sorted_logits, float("inf"))
    ).amin(dim=-1, keepdim=True)
    return torch.where(logits >= threshold, logits, float("-inf"))


def sample_from_logits(
    generator: torch.Generator,
    logits: torch.Tensor,
    sp: SamplingParams,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample token ids -> (ids [B] int32, logprob under temperature softmax).

    logits: [B, V]. Gumbel-max: argmax(scaled + G) ~ Categorical(softmax).
    The logprob is taken under the UNfiltered temperature softmax. One seed
    is drawn from ``generator`` per call, greedy or not.
    """
    seed = _next_seed(generator)
    logits = logits.float()
    if sp.greedy or sp.temperature == 0.0:
        tok = logits.argmax(dim=-1)
        lp = logits.gather(1, tok[:, None])[:, 0] - torch.logsumexp(logits, dim=-1)
        return tok.to(torch.int32), lp

    scaled = logits / sp.temperature
    filtered = scaled
    if sp.top_k > 0:
        filtered = _filter_top_k(filtered, sp.top_k)
    if sp.top_p < 1.0:
        filtered = _filter_top_p(filtered, sp.top_p)
    B, V = logits.shape
    g = gumbel_noise(seed, B, V, logits.device)
    tok = (filtered + g).argmax(dim=-1)
    lp = scaled.gather(1, tok[:, None])[:, 0] - torch.logsumexp(scaled, dim=-1)
    return tok.to(torch.int32), lp


def _fused_sampler_ok(dparams: M.Params, sp: SamplingParams, device) -> bool:
    """Fused lm-head sampling kernel eligibility: a CUDA device, an int8
    lm_head and plain temperature sampling (the serving configuration)."""
    return (
        torch.device(device).type == "cuda"
        and isinstance(dparams.get("lm_head"), QTensor)
        and sp.top_k == 0
        and sp.top_p >= 1.0
    )


def with_packed_lm_head(dparams: M.Params) -> M.Params:
    """Decode params with the int8 lm head also packed for the fused
    sampler (``lm_head_packed``, ops/cuda/sampler_kernel.py pack_lm_head).
    Called where the decode weights are made, once per set of weights; a
    dict that already holds the packed head is returned as it is."""
    if "lm_head_packed" in dparams:
        return dparams
    lm = dparams["lm_head"]
    return {**dparams, "lm_head_packed": pack_lm_head(lm.q, lm.scale)}


def _sample_hidden(
    dparams: M.Params,
    cfg: LLMConfig,
    generator: torch.Generator,
    hidden: torch.Tensor,      # [B, D]
    sp: SamplingParams,
    use_fused: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """hidden -> (token, behaviour logprob), via the fused lm-head sampler
    kernel (ops/cuda/sampler_kernel.py) on the head that
    ``with_packed_lm_head`` packed, or the plain logits path."""
    if use_fused:
        if "lm_head_packed" not in dparams:
            raise ValueError("the fused sampler reads the packed lm head: make the decode "
                             "params with with_packed_lm_head once, before the decode loop")
        return fused_lmhead_sample_packed(
            hidden.to(cfg.compute_dtype).contiguous(), dparams["lm_head_packed"],
            _next_seed(generator), temperature=sp.temperature, greedy=sp.greedy,
        )
    logits = M.lm_head_logits(dparams, cfg, hidden)
    return sample_from_logits(generator, logits, sp)


def generate(
    params: M.Params,
    cfg: LLMConfig,
    generator: torch.Generator,
    prompt_ids,               # [B, P] int, LEFT-padded (tensor or numpy)
    prompt_mask,              # [B, P] bool
    sp: SamplingParams,
    *,
    attn_impl: str = "xla",
    decode_params: Optional[M.Params] = None,
    decode_attn_impl: Optional[str] = None,
    kv_quant: str = "none",
    sampler_impl: Optional[str] = None,
    mega=None,
    device="cuda",
) -> GenerateOutput:
    """Batched generation on ``device`` (params must live there).

    decode_params: optional separate (e.g. int8-quantized) params for the
    decode loop; prefill always runs on ``params``. With the fused sampler
    their int8 lm head is packed once before the loop unless
    ``with_packed_lm_head`` already did it.
    kv_quant="int8": int8 KV cache, quantized on write.
    mega: optional (MegaPlan, MegaWeights) from
    ops/cuda/decode_megakernel.pack_decode_weights: the whole decode step
    runs as ONE kernel launch over all layers (requires kv_quant="int8").
    """
    device = resolve_device(device)
    use_mega = mega is not None and kv_quant == "int8"
    # on the card, refuse a model that a kernel of these paths does not take,
    # before the prompts are touched
    check_on_card(cfg, device, attn_impl=attn_impl, decode_attn_impl=None if use_mega else (
        decode_attn_impl or M.default_decode_attn_impl(device)))
    if use_mega and device.type == "cuda":
        _check_geometry(mega[0])
    if params["embed"].device.type != device.type:
        raise ValueError(
            f"params live on {params['embed'].device}, generate runs on {device}")
    prompt_ids = torch.as_tensor(prompt_ids, device=device).to(torch.int32)
    prompt_mask = torch.as_tensor(prompt_mask, device=device).bool()
    B, P = prompt_ids.shape
    N = sp.max_new_tokens
    S_max = P + N
    if use_mega:
        # the JAX package's cache length for this path (a multiple of 128);
        # the dead tail slots are never read: the kernel masks on [starts, wp)
        S_max = -(-S_max // 128) * 128
    dparams = decode_params if decode_params is not None else params

    prompt_lens = prompt_mask.to(torch.int32).sum(dim=-1, dtype=torch.int32)
    last_hidden, cache = M.prefill(
        params, cfg, prompt_ids, prompt_mask, S_max, attn_impl=attn_impl)
    kv_layers = M.packed_cache_from_stacked(cache)
    del cache
    if kv_quant == "int8":
        def _q8(kc, vc):
            kq, ks = M.quantize_packed_kv(kc)
            vq, vs = M.quantize_packed_kv(vc)
            return kq, vq, ks, vs

        kv_layers = tuple(_q8(kc, vc) for kc, vc in kv_layers)
    # Left-padded prompt: valid cache slots are the contiguous interval
    # [P - plen, P + t + 1), what the packed attention kernels take.
    starts = (P - prompt_lens).to(torch.int32)

    use_fused = (
        _fused_sampler_ok(dparams, sp, device) if sampler_impl is None
        else sampler_impl == "fused"
    )
    if use_fused:
        dparams = with_packed_lm_head(dparams)     # once, unless the caller packed it
    tok, lp = _sample_hidden(dparams, cfg, generator, last_hidden, sp, use_fused)
    if use_mega:
        # stack the per-layer q8 tuples into [L, B, S, ...] arrays for the
        # single-launch megakernel (ops/cuda/decode_megakernel.py)
        plan, mweights = mega
        kv_layers = tuple(
            torch.stack([layer[i] for layer in kv_layers]) for i in range(4))
        cos_tab, sin_tab = rope_frequencies(
            cfg.head_dim_, cfg.max_seq_len, cfg.rope_theta, device)
    decode_step = (
        M.decode_step_packed_q8 if kv_quant == "int8" else M.decode_step_packed
    )

    toks, lps = [tok], [lp]
    valids = [torch.ones((B,), dtype=torch.bool, device=device)]
    done = torch.zeros((B,), dtype=torch.bool, device=device)
    for t in range(N - 1):
        slot = P + t                 # cache slot of the previous token's kv
        pos = prompt_lens + t        # its rope position
        if use_mega:
            x0 = dparams["embed"][tok.long()].to(cfg.compute_dtype)
            hidden, *kv_layers = decode_step_mega(
                plan, mweights, x0, *kv_layers, slot, pos, starts, cos_tab, sin_tab)
            hidden = rms_norm(hidden, dparams["final_norm"], cfg.rms_eps)
        else:
            hidden, kv_layers = decode_step(
                dparams, cfg, tok, kv_layers, slot, pos, starts,
                torch.full((B,), slot + 1, dtype=torch.int32, device=device),
                attn_impl=decode_attn_impl,
            )
        new_tok, new_lp = _sample_hidden(dparams, cfg, generator, hidden, sp, use_fused)
        done = done | (tok == sp.eos_token_id)
        tok = torch.where(done, sp.pad_token_id, new_tok).to(torch.int32)
        lp = torch.where(done, 0.0, new_lp)
        toks.append(tok)
        lps.append(lp)
        valids.append(~done)

    response_mask = torch.stack(valids, dim=1)
    return GenerateOutput(
        response_ids=torch.stack(toks, dim=1).to(torch.int32),
        response_logprobs=torch.stack(lps, dim=1).float(),
        response_mask=response_mask,
        response_lengths=response_mask.to(torch.int32).sum(dim=-1, dtype=torch.int32),
    )
