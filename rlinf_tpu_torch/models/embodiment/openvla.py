"""OpenVLA policy: prismatic-style VLM backbone + discrete action-bin tokens.

Port of ``rlinf_tpu/models/embodiment/openvla.py`` (reference analog: the
openvla family, rlinf/models/embodiment/openvla, and its prismatic
backbone):

  * Backbone: ViT patch features -> 2-layer MLP projector (exact erf GELU)
    -> causal decoder LM over prismatic's [image | instruction] prefix.
    ``vit2_cfg`` fuses a second tower (prismatic's SigLIP + DINOv2
    ``fused_featurizer``): both encode the image and their patch features
    concatenate along channels before the projector.
  * Actions are ``action_dim`` DISCRETE tokens: the last ``action_bins``
    entries of the LM vocabulary are uniform bins over [-1, 1].
  * Rollout: prefill the multimodal prefix once (``forward_hidden(...,
    return_kv=True)``), then decode ``action_dim`` bin tokens on the
    unpacked KV cache with ``decode_step``. The slot index is a Python int
    and the sampling noise is made on the device from a seed drawn from the
    CPU generator (``gumbel_noise``), so an action step reads nothing back
    to the host and a rollout stage's policy runs behind the host's env
    steps of another stage. The last token's decode step, whose hidden
    state nothing reads, is not run.
  * RL: per-dimension categorical logprob/entropy over the bin slice (f32),
    teacher-forced recompute in ``default_forward`` for PPO ratios, value
    head on the pooled prefix.

The ``actions`` wire format is the BIN INDICES (float-cast), so the learner
teacher-forces exactly what was sampled; ``env_actions`` maps bins to
continuous bin centers (optionally de-normalized by per-dim (low, high)).

A quirk of the reference is kept: ``predict_action_batch`` prefills with
positions ``arange(Np)`` for every row, while ``default_forward`` and
``value`` pass none, so the decoder takes ``cumsum(mask) - 1``. Where an
instruction mask holds padding the behaviour and the training logprobs see
different rope positions (the VLM's quirk, ROADMAP.md §C).

Every step runs the plain PyTorch versions, as the JAX package runs XLA
here: the towers' and the decoder's attention (``impl="xla"``), the decode
attention over the unpacked cache and the f32 bin logprobs reach no
hand-written kernel.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from rlinf_tpu_torch.models.embodiment.base_policy import Policy, PolicyOutput, tree_from_numpy
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
from rlinf_tpu_torch.models.llm.quant import QTensor
from rlinf_tpu_torch.models.llm.sampler import _next_seed
from rlinf_tpu_torch.ops.cuda.sampler_kernel import gumbel_noise
from rlinf_tpu_torch.utils.device import resolve_device

#: the projector's activation: exact erf GELU, torch prismatic's
_gelu_exact = functools.partial(F.gelu, approximate="none")


@dataclasses.dataclass(frozen=True)
class OpenVLAConfig:
    action_dim: int = 7
    action_bins: int = 256
    image_key: str = "images"
    text_key: str = "instruction_ids"
    text_mask_key: str = "instruction_mask"
    # optional de-normalization: env_action = low + (center+1)/2 * (high-low)
    action_low: Optional[Tuple[float, ...]] = None
    action_high: Optional[Tuple[float, ...]] = None


class OpenVLAPolicy(Policy):
    def __init__(
        self,
        cfg: OpenVLAConfig = OpenVLAConfig(),
        vlm_cfg: Optional[LLMConfig] = None,
        vit_cfg: Optional[ViTConfig] = None,
        vit2_cfg: Optional[ViTConfig] = None,
    ):
        """``vit2_cfg`` enables the fused dual-tower backbone: both towers
        must give the same patch grid."""
        self.cfg = cfg
        self.vlm_cfg = vlm_cfg or LLMConfig.tiny(vocab_size=512, max_seq_len=256)
        self.vit_cfg = vit_cfg or ViTConfig(
            image_size=32, patch_size=16, hidden=64, layers=1, heads=4
        )
        self.vit2_cfg = vit2_cfg
        if vit2_cfg is not None and vit2_cfg.num_patches != self.vit_cfg.num_patches:
            raise ValueError("fused towers must produce the same patch grid")
        if not self.vlm_cfg.vocab_size > cfg.action_bins:
            raise ValueError(f"vocab_size {self.vlm_cfg.vocab_size} must exceed "
                             f"action_bins {cfg.action_bins}")
        self.action_dim = cfg.action_dim

    @property
    def _bin_base(self) -> int:
        return self.vlm_cfg.vocab_size - self.cfg.action_bins

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator, device="cuda") -> Dict:
        """Towers, projector and value head drawn from ``generator`` (CPU);
        the decoder by ``models.llm.init_params`` from a seed drawn from it."""
        device = resolve_device(device)
        D = self.vlm_cfg.hidden_size
        feat = self.vit_cfg.hidden + (self.vit2_cfg.hidden if self.vit2_cfg else 0)
        params = {
            "vit": init_vit(self.vit_cfg, generator, device=device),
            "img_proj": _mlp_init(generator, (feat, D, D), scale_last=None, device=device),
            "vlm": init_llm(self.vlm_cfg, int(torch.randint(0, 2**31, (1,), generator=generator)),
                            device=device),
            "value_head": _mlp_init(generator, (D, 1), scale_last=1.0, device=device),
        }
        if self.vit2_cfg is not None:
            params["vit2"] = init_vit(self.vit2_cfg, generator, device=device)
        return params

    def params_from_numpy(self, tree, device="cuda") -> Dict:
        """The JAX package's OpenVLA params as numpy arrays -> the port's
        tree; the decoder's subtree through ``models.llm.params_from_numpy``
        (int8 ``QTensor`` leaves included)."""
        device = resolve_device(device)
        out = {k: tree_from_numpy(v, device) for k, v in tree.items() if k != "vlm"}
        out["vlm"] = params_from_numpy(tree["vlm"], self.vlm_cfg, device=device)
        return out

    # ------------------------------------------------------------------
    def _prefix(self, params, obs):
        """-> (embeds [B,Np,D] f32, valid [B,Np])."""
        c = self.cfg
        img = vit_encode(params["vit"], self.vit_cfg, obs[c.image_key])
        if self.vit_cfg.cls_token:
            img = img[:, 1:]
        if self.vit2_cfg is not None:
            img2 = vit_encode(params["vit2"], self.vit2_cfg, obs[c.image_key])
            if self.vit2_cfg.cls_token:
                img2 = img2[:, 1:]
            img = torch.cat([img, img2], dim=-1)
        img = _mlp_apply(params["img_proj"], img, activation=_gelu_exact)
        B, Ni = img.shape[:2]
        toks = [img]
        valid = [torch.ones((B, Ni), dtype=torch.bool, device=img.device)]
        if c.text_key in obs:
            txt_ids = obs[c.text_key].long()
            toks.append(params["vlm"]["embed"][txt_ids].float())
            mask = obs.get(c.text_mask_key)
            valid.append(torch.ones(txt_ids.shape, dtype=torch.bool, device=img.device)
                         if mask is None else mask.bool())
        return torch.cat(toks, dim=1), torch.cat(valid, dim=1)

    def _bin_logprobs(self, hidden: torch.Tensor, params) -> torch.Tensor:
        """f32 log-softmax over the bin slice of the vocab. hidden [..., D]."""
        w = lm_head_weight(params["vlm"], self.vlm_cfg)
        base = self._bin_base
        if isinstance(w, QTensor):
            # int8 serving trunk: dequantize only the bin slice of the vocab
            w = w.q[:, base:].float() * w.scale[:, base:].float()
        else:
            w = w[:, base:].float()
        return torch.log_softmax(hidden.float() @ w, dim=-1)

    @staticmethod
    def _pooled(hidden, valid):
        """Mean of the hidden states over the valid prefix positions, f32."""
        return (hidden.float() * valid[..., None]).sum(dim=1) / (
            valid.sum(dim=1)[:, None].clamp_min(1))

    # ------------------------------------------------------------------
    def value(self, params, obs):
        embeds, valid = self._prefix(params, obs)
        hidden, _ = forward_hidden(
            params["vlm"], self.vlm_cfg, None, inputs_embeds=embeds, attention_mask=valid,
        )
        return _mlp_apply(params["value_head"], self._pooled(hidden, valid))[..., 0]

    # Policy interface ---------------------------------------------------
    def default_forward(self, params, obs, actions) -> Dict[str, torch.Tensor]:
        """actions: [B, action_dim] BIN indices (float or int)."""
        c = self.cfg
        bins = actions.to(torch.int32).clamp(0, c.action_bins - 1).long()
        embeds, valid = self._prefix(params, obs)
        B, Np, _ = embeds.shape
        act_emb = params["vlm"]["embed"][self._bin_base + bins].to(embeds.dtype)
        seq = torch.cat([embeds, act_emb], dim=1)
        seq_valid = torch.cat(
            [valid, torch.ones((B, c.action_dim), dtype=torch.bool, device=valid.device)],
            dim=1)
        hidden, _ = forward_hidden(
            params["vlm"], self.vlm_cfg, None, inputs_embeds=seq, attention_mask=seq_valid,
        )
        # hidden at index Np-1+j predicts action token j
        lp_all = self._bin_logprobs(hidden[:, Np - 1: Np - 1 + c.action_dim, :], params)
        lp = lp_all.gather(-1, bins[..., None])[..., 0]
        entropy = -(lp_all.exp() * lp_all).sum(dim=-1)          # [B, A]
        return {
            "logprobs": lp,
            "entropy": entropy,
            "values": _mlp_apply(params["value_head"],
                                 self._pooled(hidden[:, :Np], valid))[..., 0],
        }

    def predict_action_batch(
        self, params, generator, obs, *, deterministic: bool = False
    ) -> PolicyOutput:
        """Bins by Gumbel-max over the bin slice (``argmax`` when
        ``deterministic``): one seed a bin drawn from ``generator``."""
        c, v = self.cfg, self.vlm_cfg
        embeds, valid = self._prefix(params, obs)
        B, Np, _ = embeds.shape
        dev = embeds.device
        positions = torch.arange(Np, device=dev).expand(B, Np)
        hidden, kv = forward_hidden(
            params["vlm"], v, None,
            positions=positions, attention_mask=valid,
            inputs_embeds=embeds, return_kv=True,
        )
        pad = c.action_dim
        cache = KVCache(k=F.pad(kv.k, (0, 0, 0, 0, 0, pad)),
                        v=F.pad(kv.v, (0, 0, 0, 0, 0, pad)))
        del kv
        values = _mlp_apply(params["value_head"], self._pooled(hidden, valid))[..., 0]

        h = hidden[:, -1, :]
        steps = torch.arange(c.action_dim, device=dev)
        bins, lps = [], []
        for j in range(c.action_dim):
            lp_all = self._bin_logprobs(h, params)  # [B, bins]
            if deterministic:
                b = lp_all.argmax(dim=-1)
            else:
                g = gumbel_noise(_next_seed(generator), B, c.action_bins, dev)
                b = (lp_all + g).argmax(dim=-1)
            bins.append(b)
            lps.append(lp_all.gather(-1, b[:, None])[:, 0])
            if j == c.action_dim - 1:
                break
            kv_valid = torch.cat([valid, (steps <= j).expand(B, c.action_dim)], dim=1)
            h, cache = decode_step(
                params["vlm"], v, self._bin_base + b, cache,
                cache_index=Np + j,
                positions=torch.full((B,), Np + j, dtype=torch.int32, device=dev),
                kv_valid=kv_valid,
            )
        return PolicyOutput(
            actions=torch.stack(bins, dim=1).float(),
            logprobs=torch.stack(lps, dim=1),
            values=values,
        )

    def env_actions(self, policy_actions: torch.Tensor) -> torch.Tensor:
        """Bin indices -> continuous actions (bin centers in [-1,1], then
        optional per-dim (low, high) de-normalization)."""
        c = self.cfg
        bins = policy_actions.float()
        centers = -1.0 + (bins + 0.5) * (2.0 / c.action_bins)
        if c.action_low is not None and c.action_high is not None:
            low = torch.as_tensor(c.action_low, dtype=torch.float32, device=bins.device)
            high = torch.as_tensor(c.action_high, dtype=torch.float32, device=bins.device)
            return low + (centers + 1.0) * 0.5 * (high - low)
        return centers
