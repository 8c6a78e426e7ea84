"""RolloutEngine: batched static generation with prompt-length bucketing.

Port of ``rlinf_tpu/rollout/engine.py``. Weight "sync" is the params
argument itself: the learner's params feed generation directly.
"""

from __future__ import annotations

from typing import Optional

import torch

from rlinf_tpu_torch.data.io_struct import RolloutRequest, RolloutResult
from rlinf_tpu_torch.models.llm import model as M
from rlinf_tpu_torch.models.llm.config import LLMConfig
from rlinf_tpu_torch.models.llm.quant import quantize_params
from rlinf_tpu_torch.models.llm.sampler import SamplingParams, generate
from rlinf_tpu_torch.ops.cuda.geometry import check_on_card
from rlinf_tpu_torch.utils.device import resolve_device


class RolloutEngine:
    def __init__(
        self,
        cfg: LLMConfig,
        sampling: SamplingParams,
        *,
        prompt_bucket: int = 64,
        attn_impl: str = "xla",
        decode_attn_impl: Optional[str] = None,
        weight_quant: str = "none",
        device="cuda",
    ):
        """weight_quant="int8": decode runs on int8 weight-only quantized
        params, quantized inside ``rollout`` on every call, so fresh learner
        params are re-quantized for each rollout. Prefill and the reported
        logprob semantics are unchanged."""
        if weight_quant not in ("none", "int8"):
            raise ValueError(f"unknown weight_quant {weight_quant!r}; use none | int8")
        self.cfg = cfg
        self.sampling = sampling
        self.prompt_bucket = prompt_bucket
        self.attn_impl = attn_impl
        self.decode_attn_impl = decode_attn_impl
        self.weight_quant = weight_quant
        self.device = resolve_device(device)
        # on the card, refuse a model that the kernels of these paths do not take
        check_on_card(cfg, self.device, attn_impl=attn_impl,
                      decode_attn_impl=decode_attn_impl or M.default_decode_attn_impl(self.device))

    @torch.inference_mode()
    def rollout(
        self,
        params: M.Params,
        request: RolloutRequest,
        generator: torch.Generator,
        *,
        mesh=None,
    ) -> RolloutResult:
        """Generate responses for a request batch on the engine's device."""
        if mesh is not None:
            raise NotImplementedError(
                "sharded rollout (mesh=...) comes with the port's parallel slice")
        prompt_ids, prompt_mask = request.left_padded(
            self.sampling.pad_token_id, bucket=self.prompt_bucket)
        dparams = quantize_params(params) if self.weight_quant == "int8" else None
        out = generate(
            params, self.cfg, generator, prompt_ids, prompt_mask, self.sampling,
            attn_impl=self.attn_impl, decode_params=dparams,
            decode_attn_impl=self.decode_attn_impl, device=self.device,
        )
        return RolloutResult(
            prompt_ids=prompt_ids,
            prompt_mask=prompt_mask,
            response_ids=out.response_ids.cpu().numpy(),
            response_mask=out.response_mask.cpu().numpy(),
            response_logprobs=out.response_logprobs.cpu().numpy(),
            answers=request.answers,
        )
