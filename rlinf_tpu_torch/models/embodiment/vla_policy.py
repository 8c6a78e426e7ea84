"""VLA policy: ViT vision tower + transformer trunk + continuous action-chunk
head (OpenVLA-OFT-style).

Port of ``rlinf_tpu/models/embodiment/vla_policy.py`` (reference analog:
the openvla / openvla_oft policy families: vision backbone -> LLM trunk ->
parallel-decoded continuous action chunks, trained with PPO over per-chunk
Gaussian logprobs).

Sequence layout per step: [img patches ... , proprio token, K action queries]
with bidirectional attention (parallel decoding, not autoregressive: the OFT
speedup). Each action query emits ``action_dim`` means; one state-independent
logstd vector covers the chunk. The tower and the trunk run the plain
``causal_attention`` (``impl="xla"``) with every position 0, as the JAX
package does, so no hand-written kernel is on this path. Params are f32 and
keep the JAX package's keys and [L, ...] stacked layouts; inits draw from
an explicit CPU ``torch.Generator``.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch
import torch.nn.functional as F

from rlinf_tpu_torch.models.embodiment.base_policy import Policy, PolicyOutput, normal_noise
from rlinf_tpu_torch.models.embodiment.mlp_policy import (
    _mlp_apply,
    _mlp_init,
    gaussian_entropy,
    gaussian_logprob,
)
from rlinf_tpu_torch.models.embodiment.vit import ViTConfig, init_vit, vit_encode
from rlinf_tpu_torch.ops.attention import causal_attention
from rlinf_tpu_torch.ops.norm import rms_norm
from rlinf_tpu_torch.utils.device import resolve_device

#: ``jax.nn.gelu``'s default, the tanh approximation
_gelu = functools.partial(F.gelu, approximate="tanh")


class VLAPolicy(Policy):
    def __init__(
        self,
        *,
        image_size: int = 96,
        patch_size: int = 16,
        action_dim: int = 7,
        action_chunk: int = 8,
        proprio_dim: int = 0,
        hidden: int = 128,
        trunk_layers: int = 2,
        vit_layers: int = 2,
        heads: int = 4,
        image_key: str = "images",
        proprio_key: str = "states",
        init_logstd: float = -1.0,
    ):
        self.vit_cfg = ViTConfig(
            image_size=image_size, patch_size=patch_size, hidden=hidden,
            layers=vit_layers, heads=heads,
        )
        self.action_dim = action_dim
        self.action_chunk = action_chunk
        self.proprio_dim = proprio_dim
        self.hidden = hidden
        self.trunk_layers = trunk_layers
        self.heads = heads
        self.image_key = image_key
        self.proprio_key = proprio_key
        self.init_logstd = init_logstd

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator, device="cuda") -> Dict:
        device = resolve_device(device)
        D, L, Fd = self.hidden, self.trunk_layers, self.hidden * 4

        def normal(*shape):
            return (torch.randn(shape, generator=generator) * 0.02).to(device)

        params = {
            "vit": init_vit(self.vit_cfg, generator, device=device),
            "action_queries": normal(self.action_chunk, D),
            "trunk": {
                "norm1": torch.ones((L, D), device=device),
                "wqkv": normal(L, D, 3 * D),
                "wo": normal(L, D, D),
                "norm2": torch.ones((L, D), device=device),
                "w1": normal(L, D, Fd),
                "w2": normal(L, Fd, D),
            },
            "action_head": _mlp_init(generator, (D, self.action_dim), scale_last=0.01,
                                     device=device),
            "actor_logstd": torch.full((self.action_chunk, self.action_dim),
                                       float(self.init_logstd), device=device),
            "value_head": _mlp_init(generator, (D, 1), scale_last=1.0, device=device),
        }
        if self.proprio_dim:
            params["proprio_proj"] = _mlp_init(generator, (self.proprio_dim, D),
                                               scale_last=None, device=device)
        return params

    # ------------------------------------------------------------------
    def _trunk(self, params, obs):
        """-> (action_feats [B, K, D], pooled [B, D])."""
        feats = vit_encode(params["vit"], self.vit_cfg, obs[self.image_key])
        B = feats.shape[0]
        toks = [feats]
        if self.proprio_dim:
            proprio = _mlp_apply([params["proprio_proj"][0]], obs[self.proprio_key].float())
            toks.append(proprio[:, None, :])
        toks.append(params["action_queries"][None].expand(B, self.action_chunk, self.hidden))
        x = torch.cat(toks, dim=1)
        N, D, Hd = x.shape[1], self.hidden, self.hidden // self.heads
        pos = torch.zeros((B, N), dtype=torch.int32, device=x.device)  # bidirectional

        cols = {k: w.unbind(0) for k, w in params["trunk"].items()}
        for i in range(self.trunk_layers):
            layer = {k: c[i] for k, c in cols.items()}
            h = rms_norm(x, layer["norm1"])
            q, k, v = (t.reshape(B, N, self.heads, Hd)
                       for t in (h @ layer["wqkv"]).chunk(3, dim=-1))
            attn = causal_attention(q, k, v, positions_q=pos, positions_kv=pos)
            x = x + attn.reshape(B, N, D) @ layer["wo"]
            h = rms_norm(x, layer["norm2"])
            x = x + _gelu(h @ layer["w1"]) @ layer["w2"]
        return x[:, -self.action_chunk:, :], x.mean(dim=1)

    def _dist(self, params, obs):
        action_feats, pooled = self._trunk(params, obs)
        mean = _mlp_apply(params["action_head"], action_feats)  # [B, K, A]
        logstd = params["actor_logstd"].expand(mean.shape)
        return mean, logstd, pooled

    def value(self, params, obs):
        _, pooled = self._trunk(params, obs)
        return _mlp_apply(params["value_head"], pooled)[..., 0]

    # Policy interface ---------------------------------------------------
    def default_forward(self, params, obs, actions) -> Dict[str, torch.Tensor]:
        """actions: [B, K*A] (flattened chunk) or [B, K, A]."""
        mean, logstd, pooled = self._dist(params, obs)
        a = actions.float().reshape(mean.shape)
        B = mean.shape[0]
        return {
            "logprobs": gaussian_logprob(mean, logstd, a).reshape(B, -1),
            "entropy": gaussian_entropy(logstd).reshape(B, -1),
            "values": _mlp_apply(params["value_head"], pooled)[..., 0],
        }

    def predict_action_batch(
        self, params, generator, obs, *, deterministic: bool = False
    ) -> PolicyOutput:
        """The noise is drawn from ``generator`` (a CPU generator)."""
        mean, logstd, pooled = self._dist(params, obs)
        if deterministic:
            act = mean
        else:
            act = mean + torch.exp(logstd) * normal_noise(generator, mean.shape, mean.device)
        B = mean.shape[0]
        return PolicyOutput(
            actions=act.reshape(B, -1),
            logprobs=gaussian_logprob(mean, logstd, act).reshape(B, -1),
            values=_mlp_apply(params["value_head"], pooled)[..., 0],
        )
