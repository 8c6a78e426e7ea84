"""Value-model critics: RECAP categorical critic + STEAM stride critic.

Port of ``rlinf_tpu/models/embodiment/value_critic.py``:

* ``ValueCriticPolicy``: RECAP's "expert forward mode" (reference
  rlinf/models/embodiment/value_model/recap/modeling_critic.py:129). The
  VLM prefix (images + language) is encoded once, a small value expert
  attends over the cached prefix K/V with one learned [CLS] suffix token,
  and the [CLS] hidden state projects to a CATEGORICAL value distribution
  over ``num_bins`` atoms in [v_min, v_max]. Training uses the Dirac
  two-bin projection cross-entropy (modeling_critic.py:473) with the
  reference's acc_best / acc_neighbor / mae metrics. It is a ``Pi0Policy``
  and reuses its ``_suffix_hidden``.

* ``SteamCritic``: STEAM's pairwise temporal-stride classifier (reference
  value_model/steam): given an (earlier, later) frame pair, classify the
  SIGNED stride into an even number of bins (2: the binary progressive /
  regressive mode); an ENSEMBLE of heads over a shared ViT backbone gives
  per-member logits whose mean probability is the progress estimate. The
  JAX package vmaps over stacked heads; here the heads' leaves are stacked
  [E, ...] and each layer is one batched product over the members.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from rlinf_tpu_torch.models.embodiment.base_policy import tree_from_numpy
from rlinf_tpu_torch.models.embodiment.mlp_policy import _mlp_apply, _mlp_init
from rlinf_tpu_torch.models.embodiment.openpi import Pi0Config, Pi0Policy, _normal
from rlinf_tpu_torch.models.embodiment.vit import ViTConfig, init_vit, vit_encode
from rlinf_tpu_torch.models.llm.config import LLMConfig
from rlinf_tpu_torch.utils.device import resolve_device


# ---------------------------------------------------------------------------
# Categorical (distributional) value loss -- reference modeling_critic.py:473
# ---------------------------------------------------------------------------


def categorical_value_loss(
    logits: torch.Tensor,          # [B, num_bins]
    target_values: torch.Tensor,   # [B]
    *,
    v_min: float,
    v_max: float,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Dirac two-bin projection cross-entropy + the reference's metrics.

    Targets are clamped to [v_min, v_max] and projected onto the two
    neighboring atoms with linear weights; loss is -sum(p_target *
    log_softmax(logits)) per row."""
    B, num_bins = logits.shape
    delta_z = (v_max - v_min) / (num_bins - 1)
    t = target_values.float().clamp(v_min, v_max)
    b = (t - v_min) / delta_z
    lo = b.floor().to(torch.int64).clamp(0, num_bins - 1)
    hi = b.ceil().to(torch.int64).clamp(0, num_bins - 1)
    same = lo == hi
    d_to_l = torch.where(same, 0.0, b - lo.float())
    d_to_u = torch.where(same, 1.0, hi.float() - b)
    target_probs = (F.one_hot(lo, num_bins) * d_to_u[:, None]
                    + F.one_hot(hi, num_bins) * d_to_l[:, None])
    loss = -(target_probs * torch.log_softmax(logits.float(), dim=-1)).sum(dim=-1)

    pred_bin = logits.argmax(dim=-1)
    best = torch.where(d_to_u >= d_to_l, lo, hi)
    acc_best = (pred_bin == best).float().mean()
    acc_neighbor = ((pred_bin == lo) | (pred_bin == hi)).float().mean()
    min_dist = torch.minimum((pred_bin - lo).abs(), (pred_bin - hi).abs()).float()
    mae = (min_dist * delta_z).mean()
    return loss, {"critic/acc_best": acc_best,
                  "critic/acc_neighbor": acc_neighbor,
                  "critic/mae": mae}


def value_atoms(num_bins: int, v_min: float, v_max: float, device="cuda") -> torch.Tensor:
    return torch.linspace(v_min, v_max, num_bins, device=resolve_device(device))


# ---------------------------------------------------------------------------
# RECAP critic
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ValueCriticConfig:
    num_bins: int = 64
    v_min: float = -1.0     # reference configuration.py:246 defaults
    v_max: float = 0.0
    expert_hidden: int = 64
    expert_ffn: int = 128


class ValueCriticPolicy(Pi0Policy):
    """RECAP critic: VLM prefix + value expert + [CLS] -> categorical value.

    Reference call stack analog: ValueCriticModel.forward ->
    embed_prefix / embed_suffix([CLS]) / _forward_expert ->
    _compute_value_from_hidden (modeling_critic.py:311-472)."""

    def __init__(self, vcfg: ValueCriticConfig = ValueCriticConfig(),
                 vlm_cfg: Optional[LLMConfig] = None,
                 vit_cfg: Optional[ViTConfig] = None, **kw):
        super().__init__(
            Pi0Config(action_chunk=1, expert_hidden=vcfg.expert_hidden,
                      expert_ffn=vcfg.expert_ffn),
            vlm_cfg=vlm_cfg, vit_cfg=vit_cfg, **kw)
        self.vcfg = vcfg

    def init(self, generator: torch.Generator, device="cuda") -> Dict:
        device = resolve_device(device)
        params = super().init(generator, device=device)
        params["cls_embed"] = _normal(generator, (self.vcfg.expert_hidden,), device)
        params["value_logits"] = _mlp_init(generator, (self.vcfg.expert_hidden,
                                                       self.vcfg.num_bins),
                                           scale_last=0.01, device=device)
        return params

    def value_logits(self, params, obs) -> torch.Tensor:
        """obs (images + instruction) -> [B, num_bins] logits."""
        pk, pv, pvalid, plen, _ = self.encode_prefix(params, obs)
        B = pk.shape[1]
        x = params["cls_embed"][None, None, :].expand(B, 1, self.vcfg.expert_hidden).float()
        block = torch.ones((1,), dtype=torch.int32, device=x.device)  # [CLS]: its own block
        h = self._suffix_hidden(params, pk, pv, pvalid, plen, x, block)
        return _mlp_apply(params["value_logits"], h[:, 0])

    def predict_value(self, params, obs) -> torch.Tensor:
        """Expected value under the categorical distribution [B]."""
        logits = self.value_logits(params, obs)
        atoms = value_atoms(self.vcfg.num_bins, self.vcfg.v_min, self.vcfg.v_max,
                            device=logits.device)
        return (torch.softmax(logits, dim=-1) * atoms[None, :]).sum(dim=-1)

    def loss(self, params, obs, target_values):
        loss, metrics = categorical_value_loss(
            self.value_logits(params, obs), target_values,
            v_min=self.vcfg.v_min, v_max=self.vcfg.v_max)
        return loss.mean(), metrics


# ---------------------------------------------------------------------------
# STEAM critic
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SteamConfig:
    #: even; 2 == legacy binary progressive/regressive mode
    #: (reference steam/configuration.py:83-95)
    num_bins: int = 2
    #: max pair stride K; signed strides in [-K, K] \ {0} discretize into
    #: num_bins (first half regressive, second half progressive)
    max_stride: int = 8
    ensemble_size: int = 4
    feature_dim: int = 128

    def __post_init__(self):
        if self.num_bins < 2 or self.num_bins % 2:
            raise ValueError(
                f"num_bins must be >= 2 and even, got {self.num_bins}")


class SteamCritic:
    """Pairwise temporal-stride ensemble critic."""

    def __init__(self, cfg: SteamConfig = SteamConfig(),
                 vit_cfg: Optional[ViTConfig] = None):
        self.cfg = cfg
        self.vit_cfg = vit_cfg or ViTConfig(
            image_size=32, patch_size=16, hidden=64, layers=1, heads=4)

    def init(self, generator: torch.Generator, device="cuda") -> Dict:
        """The ViT and ``ensemble_size`` heads, each layer's leaves stacked
        [E, ...] (the JAX package's vmapped init)."""
        device = resolve_device(device)
        c = self.cfg
        sizes = (2 * self.vit_cfg.hidden, c.feature_dim, c.num_bins)
        members = [_mlp_init(generator, sizes, scale_last=0.01, device=device)
                   for _ in range(c.ensemble_size)]
        heads = [{k: torch.stack([m[i][k] for m in members]) for k in ("w", "b")}
                 for i in range(len(sizes) - 1)]
        return {"vit": init_vit(self.vit_cfg, generator, device=device), "heads": heads}

    def params_from_numpy(self, tree, device="cuda") -> Dict:
        """The JAX package's params as numpy arrays -> the port's tree."""
        return tree_from_numpy(tree, resolve_device(device))

    def _pair_features(self, params, frames_a, frames_b):
        fa = vit_encode(params["vit"], self.vit_cfg, frames_a).mean(dim=1)
        fb = vit_encode(params["vit"], self.vit_cfg, frames_b).mean(dim=1)
        return torch.cat([fa, fb], dim=-1)  # [B, 2D]

    def stride_logits(self, params, frames_a, frames_b) -> torch.Tensor:
        """-> [E, B, num_bins] per-member logits (ensemble axis leading,
        reference ensemble_modeling_critic.py:65): each layer one batched
        product over the members, tanh between layers."""
        x = self._pair_features(params, frames_a, frames_b)
        heads = params["heads"]
        for i, layer in enumerate(heads):
            eq = "bi,eio->ebo" if i == 0 else "ebi,eio->ebo"
            x = torch.einsum(eq, x, layer["w"]) + layer["b"][:, None, :]
            if i < len(heads) - 1:
                x = torch.tanh(x)
        return x

    def stride_to_bin(self, strides: torch.Tensor) -> torch.Tensor:
        """Signed strides in [-K, K] \\ {0} -> bin ids [0, num_bins)."""
        c = self.cfg
        if c.num_bins == 2:
            return (strides > 0).to(torch.int32)
        half = c.num_bins // 2
        mag = strides.abs().clamp(1, c.max_stride)
        sub = torch.ceil(mag * half / c.max_stride).to(torch.int32) - 1
        return torch.where(strides > 0, half + sub, half - 1 - sub)

    def loss(self, params, frames_a, frames_b, strides):
        """Mean cross-entropy over ensemble members + accuracy metric."""
        logits = self.stride_logits(params, frames_a, frames_b)  # [E, B, nb]
        bins = self.stride_to_bin(strides).long()                # [B]
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, bins[None, :, None].expand(logp.shape[0], -1, 1))[..., 0]
        probs = torch.softmax(logits, dim=-1).mean(0)            # [B, nb]
        acc = (probs.argmax(dim=-1) == bins).float().mean()
        return nll.mean(), {"critic/stride_acc": acc}

    def progress_score(self, params, frames_a, frames_b) -> torch.Tensor:
        """Mean ensemble probability mass on the progressive half [B]:
        STEAM's progress/value signal."""
        probs = torch.softmax(self.stride_logits(params, frames_a, frames_b), dim=-1).mean(0)
        return probs[:, self.cfg.num_bins // 2:].sum(dim=-1)

    def ensemble_disagreement(self, params, frames_a, frames_b) -> torch.Tensor:
        """Std of the per-member progressive mass [B] (epistemic signal)."""
        probs = torch.softmax(self.stride_logits(params, frames_a, frames_b), dim=-1)
        prog = probs[..., self.cfg.num_bins // 2:].sum(dim=-1)   # [E, B]
        return prog.std(dim=0, correction=0)
