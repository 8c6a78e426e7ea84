"""GR00T-style policy: VLM features + flow-matching DiT action head.

Port of ``rlinf_tpu/models/embodiment/gr00t.py`` (reference analog: the
gr00t N1.5/N1.6/N1.7 family, rlinf/models/embodiment/gr00t): a backbone
gives vision(-language) tokens; a diffusion transformer (DiT) head denoises
an action CHUNK conditioned on those tokens, the proprioceptive state and a
per-EMBODIMENT embedding.

  * Backbone: ViT patch tokens (+ optional instruction token embeds from a
    small table), projected to the DiT width; computed once per
    observation, every denoising step runs only the DiT head.
  * State encoder: MLP(state) + the embodiment-category embedding.
  * DiT head: blocks of [adaLN self-attention over (state tok | K action
    toks)] -> [cross-attention to the backbone tokens] -> [adaLN MLP], with
    per-layer adaLN modulation (shift / scale / gate) from the flow time.
  * Training: conditional flow matching (BC); RL: the flow-SDE denoising
    MDP with exact chain logprobs (``flow_utils``).

starvla's flow-matching action head is the same DiT without the
embodiment embedding (``num_embodiments=1``). Attention is the plain
PyTorch version (``impl="xla"``), as the JAX policy's: no hand-written
kernel is on this path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from rlinf_tpu_torch.models.embodiment.base_policy import Policy, PolicyOutput
from rlinf_tpu_torch.models.embodiment.flow_utils import (
    chain_entropy_like,
    chain_logprobs,
    flow_matching_loss,
    sample_ode,
    sample_sde,
    time_embed,
)
from rlinf_tpu_torch.models.embodiment.mlp_policy import _mlp_apply, _mlp_init
from rlinf_tpu_torch.models.embodiment.openpi import _normal
from rlinf_tpu_torch.models.embodiment.vit import ViTConfig, init_vit, vit_encode
from rlinf_tpu_torch.ops.attention import causal_attention
from rlinf_tpu_torch.ops.norm import rms_norm
from rlinf_tpu_torch.utils.device import resolve_device

#: the DiT's per-layer leaves, stacked [L, ...]
DIT_LAYER_KEYS = ("norm1", "wqkv", "wo", "xnorm", "xq", "xkv", "xo", "norm2", "w1", "w2",
                  "ada")


@dataclasses.dataclass(frozen=True)
class GR00TConfig:
    action_dim: int = 7
    action_chunk: int = 8          # N1.5 denoises 16-step chunks
    state_dim: int = 8
    num_embodiments: int = 4       # GR00T embodiment categories
    hidden: int = 64               # DiT width (N1.5: 1024)
    layers: int = 2                # DiT depth (N1.5: 16)
    heads: int = 4
    mlp_ratio: int = 4
    text_vocab: int = 0            # 0 => vision-only conditioning
    time_embed_dim: int = 32
    num_flow_steps: int = 8
    sde_noise_scale: float = 0.5
    image_key: str = "images"
    text_key: str = "instruction_ids"
    state_key: str = "states"
    embodiment_key: str = "embodiment_id"


class GR00TPolicy(Policy):
    def __init__(self, cfg: GR00TConfig = GR00TConfig(),
                 vit_cfg: Optional[ViTConfig] = None):
        self.cfg = cfg
        self.vit_cfg = vit_cfg or ViTConfig(
            image_size=32, patch_size=16, hidden=64, layers=1, heads=4
        )
        self.action_dim = cfg.action_dim * cfg.action_chunk

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator, device="cuda") -> Dict:
        device = resolve_device(device)
        c = self.cfg
        D, L, Fd = c.hidden, c.layers, c.hidden * c.mlp_ratio
        normal = lambda *shape: _normal(generator, shape, device)
        ones = lambda *shape: torch.ones(shape, device=device)
        params = {
            "vit": init_vit(self.vit_cfg, generator, device=device),
            "img_proj": _mlp_init(generator, (self.vit_cfg.hidden, D), scale_last=None,
                                  device=device),
            "state_enc": _mlp_init(generator, (c.state_dim, D, D), scale_last=None,
                                   device=device),
            "embodiment_embed": normal(c.num_embodiments, D),
            "action_in": _mlp_init(generator, (c.action_dim, D), scale_last=None,
                                   device=device),
            "action_pos": normal(c.action_chunk, D),
            "dit": {
                "norm1": ones(L, D),
                "wqkv": normal(L, D, 3 * D),
                "wo": normal(L, D, D),
                "xnorm": ones(L, D),
                "xq": normal(L, D, D),
                "xkv": normal(L, D, 2 * D),
                "xo": normal(L, D, D),
                "norm2": ones(L, D),
                "w1": normal(L, D, Fd),
                "w2": normal(L, Fd, D),
                # adaLN: 6 chunks (shift/scale/gate for attn + mlp); small
                # random init (not adaLN-zero) so gates pass signal at init
                "ada": normal(L, c.time_embed_dim, 6 * D),
            },
            "final_norm": ones(D),
            "action_out": _mlp_init(generator, (D, c.action_dim), scale_last=0.01,
                                    device=device),
            "value_head": _mlp_init(generator, (D, 1), scale_last=1.0, device=device),
        }
        if c.text_vocab:
            params["text_embed"] = normal(c.text_vocab, D)
        return params

    # ------------------------------------------------------------------
    def encode_backbone(self, params, obs):
        """-> (cond tokens [B, N, D], pooled [B, D])."""
        c = self.cfg
        img = vit_encode(params["vit"], self.vit_cfg, obs[c.image_key])
        feats = _mlp_apply(params["img_proj"], img)
        if c.text_vocab and c.text_key in obs:
            feats = torch.cat([feats, params["text_embed"][obs[c.text_key].long()]], dim=1)
        return feats, feats.mean(dim=1)

    def _dit_pass(self, params, cond, state_tok, x_t, t):
        """x_t [B, K, A], t [B] -> velocity [B, K, A]."""
        c = self.cfg
        B = x_t.shape[0]
        D, Hn = c.hidden, c.heads
        Hd = D // Hn
        act = _mlp_apply(params["action_in"], x_t.float()) + params["action_pos"][None]
        x = torch.cat([state_tok[:, None, :], act], dim=1)  # [B, 1+K, D]
        Ns, Nc = x.shape[1], cond.shape[1]
        temb = time_embed(t.float(), c.time_embed_dim)  # [B, Te]
        zero_pos = torch.zeros((B, Ns), dtype=torch.int32, device=x.device)  # full attention
        zero_pos_c = torch.zeros((B, Nc), dtype=torch.int32, device=x.device)
        heads = lambda a, n: a.reshape(B, n, Hn, Hd)

        dit = params["dit"]
        for (norm1, wqkv, wo, xnorm, xq, xkv, xo, norm2, w1, w2, ada) in zip(
                *(dit[k].unbind(0) for k in DIT_LAYER_KEYS)):
            s1, g1, gate1, s2, g2, gate2 = (temb @ ada).chunk(6, dim=-1)
            # modulated self-attention over [state | action] tokens
            h = rms_norm(x, norm1) * (1 + g1[:, None]) + s1[:, None]
            q, k, v = (h @ wqkv).chunk(3, dim=-1)
            attn = causal_attention(heads(q, Ns), heads(k, Ns), heads(v, Ns),
                                    positions_q=zero_pos, positions_kv=zero_pos)
            x = x + gate1[:, None] * (attn.reshape(B, Ns, D) @ wo)
            # cross-attention to the backbone tokens
            h = rms_norm(x, xnorm)
            kc, vc = (cond @ xkv).chunk(2, dim=-1)
            attn = causal_attention(heads(h @ xq, Ns), heads(kc, Nc), heads(vc, Nc),
                                    positions_q=zero_pos, positions_kv=zero_pos_c)
            x = x + attn.reshape(B, Ns, D) @ xo
            # modulated MLP
            h = rms_norm(x, norm2) * (1 + g2[:, None]) + s2[:, None]
            x = x + gate2[:, None] * (F.gelu(h @ w1, approximate="tanh") @ w2)
        x = rms_norm(x, params["final_norm"])
        return _mlp_apply(params["action_out"], x[:, 1:, :])

    def _velocity_fn(self, params, obs):
        c = self.cfg
        cond, pooled = self.encode_backbone(params, obs)
        state_tok = _mlp_apply(params["state_enc"], obs[c.state_key].float(),
                               activation=F.silu)
        B = state_tok.shape[0]
        emb_id = obs.get(c.embodiment_key)
        if emb_id is None:
            emb_id = torch.zeros((B,), dtype=torch.int32, device=state_tok.device)
        state_tok = state_tok + params["embodiment_embed"][emb_id.long()]
        fn = lambda x_t, t: self._dit_pass(params, cond, state_tok, x_t, t)
        return fn, pooled

    # ------------------------------------------------------------------
    def value(self, params, obs):
        _, pooled = self.encode_backbone(params, obs)
        return _mlp_apply(params["value_head"], pooled)[..., 0]

    def flow_matching_loss(self, params, generator, obs, target_actions, *, x0=None, t=None):
        c = self.cfg
        target = target_actions.reshape(-1, c.action_chunk, c.action_dim)
        fn, _ = self._velocity_fn(params, obs)
        return flow_matching_loss(fn, generator, target, x0=x0, t=t)

    def _shape(self, obs):
        c = self.cfg
        return (obs[c.image_key].shape[0], c.action_chunk, c.action_dim)

    # Policy interface ---------------------------------------------------
    def default_forward(self, params, obs, actions) -> Dict[str, torch.Tensor]:
        c = self.cfg
        B = actions.shape[0]
        chain = actions.float().reshape(B, -1, c.action_chunk, c.action_dim)
        fn, pooled = self._velocity_fn(params, obs)
        lp = chain_logprobs(fn, chain, noise_scale=c.sde_noise_scale)
        return {
            "logprobs": lp,
            "entropy": chain_entropy_like(lp, c.action_chunk * c.action_dim,
                                          chain.shape[1] - 1, c.sde_noise_scale),
            "values": _mlp_apply(params["value_head"], pooled)[..., 0],
        }

    def predict_action_batch(
        self, params, generator, obs, *, deterministic: bool = False,
        x0=None, eps=None,
    ) -> PolicyOutput:
        c = self.cfg
        fn, pooled = self._velocity_fn(params, obs)
        values = _mlp_apply(params["value_head"], pooled)[..., 0]
        shape = self._shape(obs)
        B, dev = shape[0], pooled.device
        if deterministic:
            x1 = sample_ode(fn, generator, shape, steps=c.num_flow_steps, x0=x0, device=dev)
            return PolicyOutput(actions=x1.reshape(B, -1),
                                logprobs=torch.zeros((B, 1), device=dev), values=values)
        out = sample_sde(fn, generator, shape, steps=c.num_flow_steps,
                         noise_scale=c.sde_noise_scale, x0=x0, eps=eps, device=dev)
        return PolicyOutput(actions=out.chain.reshape(B, -1), logprobs=out.logprobs,
                            values=values)

    def env_actions(self, policy_actions: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        B = policy_actions.shape[0]
        return policy_actions.reshape(B, -1, c.action_chunk, c.action_dim)[:, -1].reshape(B, -1)
