"""Vision-language reasoning model: ViT prefix + causal LM, free-form text.

Port of ``rlinf_tpu/models/vlm/reasoning.py`` (reference analog: the VLM
GRPO e2e configs and the VLM SFT worker
rlinf/workers/sft/megatron_vlm_sft_worker.py). The model consumes [image |
question] and generates a free-text answer that a VQA-style reward grades:

  * ViT patch encoder (``models/embodiment/vit.py``) + a two-layer GELU
    projector into the decoder's embedding space (prismatic layout), both
    f32 whatever the decoder's dtype;
  * the causal decoder (``models/llm``) prefilled on the multimodal prefix
    through ``inputs_embeds``, then autoregressive free-vocab decode on the
    unpacked KV cache (``decode_step``) with the framework sampler
    (Gumbel-max, temperature/top-k/top-p, eos), one seed a step from a
    ``torch.Generator``;
  * teacher-forced ``forward`` for PPO ratios (f32 logprobs + entropy over
    the response tokens only).

Every step runs the plain PyTorch versions, as the JAX package runs XLA
here: the ViT's and the decoder's attention, the decode attention over the
unpacked cache and the f32 lm-head logprobs reach no hand-written kernel.

A quirk of the reference is kept: ``generate`` prefills with positions
``arange(Np)`` for every row, while ``forward`` passes none, so the decoder
takes ``cumsum(mask) - 1``. With left-padded prompts of different lengths
the behaviour and the training logprobs see different rope positions
(ROADMAP.md §C).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from rlinf_tpu_torch.models.embodiment.base_policy import tree_from_numpy
from rlinf_tpu_torch.models.embodiment.mlp_policy import _mlp_apply, _mlp_init
from rlinf_tpu_torch.models.embodiment.vit import ViTConfig, init_vit, vit_encode
from rlinf_tpu_torch.models.llm.config import LLMConfig
from rlinf_tpu_torch.models.llm.convert import params_from_numpy
from rlinf_tpu_torch.models.llm.model import (
    KVCache,
    decode_step,
    forward_hidden,
    init_params as init_llm,
    lm_head_weight,
)
from rlinf_tpu_torch.models.llm.sampler import SamplingParams, sample_from_logits
from rlinf_tpu_torch.utils.device import resolve_device

#: the projector's activation: ``jax.nn.gelu``'s default, the tanh approximation
_gelu = functools.partial(F.gelu, approximate="tanh")


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    image_key: str = "images"


class VLMReasoningModel:
    def __init__(
        self,
        vlm_cfg: Optional[LLMConfig] = None,
        vit_cfg: Optional[ViTConfig] = None,
        cfg: VLMConfig = VLMConfig(),
    ):
        self.cfg = cfg
        self.vlm_cfg = vlm_cfg or LLMConfig.tiny(vocab_size=260, max_seq_len=256)
        self.vit_cfg = vit_cfg or ViTConfig(
            image_size=32, patch_size=16, hidden=64, layers=2, heads=4
        )

    # ------------------------------------------------------------------
    def init(self, seed: int, device="cuda") -> Dict:
        """{"vit", "img_proj", "vlm"}: the tower and the projector drawn
        from a CPU ``torch.Generator`` seeded with ``seed``, the decoder by
        ``models.llm.init_params`` from a seed that generator draws."""
        device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        D = self.vlm_cfg.hidden_size
        return {
            "vit": init_vit(self.vit_cfg, g, device=device),
            "img_proj": _mlp_init(g, (self.vit_cfg.hidden, D, D), scale_last=None,
                                  device=device),
            "vlm": init_llm(self.vlm_cfg, int(torch.randint(0, 2**31, (1,), generator=g)),
                            device=device),
        }

    def _prefix(self, params, images, prompt_ids, prompt_mask
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[image patches | question tokens] -> (embeds [B,Np,D] f32, valid)."""
        img = vit_encode(params["vit"], self.vit_cfg, images)
        if self.vit_cfg.cls_token:
            img = img[:, 1:]
        img = _mlp_apply(params["img_proj"], img, activation=_gelu)
        B, Ni = img.shape[:2]
        txt = params["vlm"]["embed"][prompt_ids.long()].to(img.dtype)
        embeds = torch.cat([img, txt], dim=1)
        valid = torch.cat([torch.ones((B, Ni), dtype=torch.bool, device=img.device),
                           prompt_mask.bool()], dim=1)
        return embeds, valid

    # ------------------------------------------------------------------
    @torch.no_grad()
    def generate(self, params, generator: torch.Generator, images, prompt_ids,
                 prompt_mask, sp: SamplingParams) -> Dict[str, torch.Tensor]:
        """Prefill the multimodal prefix, decode ``sp.max_new_tokens``.

        Returns response_ids/logprobs/mask [B, N] and lengths [B]; the mask
        goes False after eos (eos itself included), the logprobs are the
        behaviour logprobs under the temperature softmax (reference rollout
        semantics). One sampling seed a step is drawn from ``generator``.
        The last token's decode step, whose hidden state nothing reads, is
        not run.
        """
        v = self.vlm_cfg
        embeds, valid = self._prefix(params, images, prompt_ids, prompt_mask)
        B, Np, _ = embeds.shape
        N = sp.max_new_tokens
        dev = embeds.device
        positions = torch.arange(Np, device=dev).expand(B, Np)
        hidden, kv = forward_hidden(
            params["vlm"], v, None,
            positions=positions, attention_mask=valid,
            inputs_embeds=embeds, return_kv=True,
        )
        cache = KVCache(k=F.pad(kv.k, (0, 0, 0, 0, 0, N)),
                        v=F.pad(kv.v, (0, 0, 0, 0, 0, N)))
        del kv
        w = lm_head_weight(params["vlm"], v).float()
        h = hidden[:, -1, :]
        steps = torch.arange(N, device=dev)
        alive = torch.ones((B,), dtype=torch.bool, device=dev)
        toks, lps, emitted = [], [], []
        for j in range(N):
            logits = h.float() @ w
            tok, lp = sample_from_logits(generator, logits, sp)
            tok = torch.where(alive, tok, sp.pad_token_id)
            lp = torch.where(alive, lp, 0.0)
            toks.append(tok)
            lps.append(lp)
            emitted.append(alive)
            alive = alive & (tok != sp.eos_token_id)
            if j == N - 1:
                break
            kv_valid = torch.cat([valid, (steps <= j).expand(B, N)], dim=1)
            h, cache = decode_step(
                params["vlm"], v, tok, cache,
                cache_index=Np + j,
                positions=torch.full((B,), Np + j, dtype=torch.int32, device=dev),
                kv_valid=kv_valid,
            )
        mask = torch.stack(emitted, dim=1)
        return {
            "response_ids": torch.stack(toks, dim=1).to(torch.int32),   # [B, N]
            "response_logprobs": torch.stack(lps, dim=1).float(),
            "response_mask": mask,
            "response_lengths": mask.sum(dim=1).to(torch.int32),
        }

    # ------------------------------------------------------------------
    def forward(self, params, images, prompt_ids, prompt_mask, response_ids,
                response_mask, *, temperature: float = 1.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced f32 (logprobs, entropy) of the response tokens
        [B, N] given the multimodal prefix: the PPO-ratio forward."""
        v = self.vlm_cfg
        embeds, valid = self._prefix(params, images, prompt_ids, prompt_mask)
        Np = embeds.shape[1]
        N = response_ids.shape[1]
        resp_emb = params["vlm"]["embed"][response_ids.long()].to(embeds.dtype)
        seq = torch.cat([embeds, resp_emb], dim=1)
        seq_valid = torch.cat([valid, response_mask.bool()], dim=1)
        hidden, _ = forward_hidden(
            params["vlm"], v, None, inputs_embeds=seq, attention_mask=seq_valid,
        )
        w = lm_head_weight(params["vlm"], v)
        pred_h = hidden[:, Np - 1: Np - 1 + N, :]
        logits = (pred_h.float() @ w.float()) / temperature
        lp_all = torch.log_softmax(logits, dim=-1)
        lp = lp_all.gather(-1, response_ids.long()[..., None])[..., 0]
        entropy = -(lp_all.exp() * lp_all).sum(dim=-1)
        return lp, entropy


def vlm_params_from_numpy(tree: dict, vlm_cfg: LLMConfig, device="cuda") -> Dict:
    """The JAX package's VLM params as numpy arrays ({"vit": dict,
    "img_proj": list of {"w", "b"}, "vlm": the decoder's tree}) -> the
    port's tree of tensors on ``device``."""
    device = resolve_device(device)
    return {"vit": tree_from_numpy(tree["vit"], device),
            "img_proj": tree_from_numpy(tree["img_proj"], device),
            "vlm": params_from_numpy(tree["vlm"], vlm_cfg, device=device)}
