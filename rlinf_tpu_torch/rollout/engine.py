"""RolloutEngine: batched static generation with prompt-length bucketing.

Port of ``rlinf_tpu/rollout/engine.py``. Weight "sync" is the params
argument itself: the learner's params feed generation directly.

Under ``rollout(mesh=)`` every rank pads the global request alike, keeps
its rows (its block along data x fsdp), generates them with the mesh
active (tensor-parallel blocks at this rank's heads, the weights gathered
over fsdp and the lm head whole: ``model.rollout_params``) and gathers the
results, so every rank returns the global result. The ranks of one batch
block sample with the same generator: one seed drawn from the caller's
(the same draw on every rank) and offset by the block's index. An MoE
layer's capacity, slot order and statistics count the whole batch in
prefill and in every decode step (``ops.moe.rows_split_over`` over the
batch axes), as the JAX engine's one program does; every rank runs every
decode step, so the layers' collectives meet.
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
        """Generate responses for a request batch on the engine's device
        (under ``mesh``, this rank's rows; every rank gets the global result)."""
        prompt_ids, prompt_mask = request.left_padded(
            self.sampling.pad_token_id, bucket=self.prompt_bucket)
        if mesh is not None:
            return self._rollout_sharded(params, request, generator, mesh,
                                         prompt_ids, prompt_mask)
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

    def _rollout_sharded(self, params, request, generator, mesh, prompt_ids, prompt_mask):
        from rlinf_tpu_torch.models.llm.sampler import _next_seed
        from rlinf_tpu_torch.ops.moe import rows_split_over
        from rlinf_tpu_torch.parallel.distributed import fetch_global, shard_rows_for_process
        from rlinf_tpu_torch.parallel.mesh import AxisNames as Ax, use_mesh

        M.check_mesh(self.cfg, mesh)
        rows = shard_rows_for_process(prompt_ids.shape[0], mesh)
        block_gen = torch.Generator().manual_seed(
            (_next_seed(generator) + 1_000_003 * mesh.axis_index(Ax.BATCH)) % 2**63)
        with use_mesh(mesh), rows_split_over(mesh, Ax.BATCH):
            rparams = M.rollout_params(params, self.cfg)
            dparams = quantize_params(rparams) if self.weight_quant == "int8" else None
            out = generate(
                rparams, self.cfg, block_gen, prompt_ids[rows], prompt_mask[rows],
                self.sampling, attn_impl=self.attn_impl, decode_params=dparams,
                decode_attn_impl=self.decode_attn_impl, device=self.device,
            )
            got = [fetch_global(t, mesh).cpu().numpy() for t in (
                out.response_ids, out.response_mask.to(torch.int32), out.response_logprobs)]
        return RolloutResult(
            prompt_ids=prompt_ids,
            prompt_mask=prompt_mask,
            response_ids=got[0],
            response_mask=got[1].astype(bool),
            response_logprobs=got[2],
            answers=request.answers,
        )
