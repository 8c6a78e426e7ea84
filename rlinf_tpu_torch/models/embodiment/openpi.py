"""pi0 / pi0.5 policy family: PaliGemma-style VLM prefix + flow-matching
action expert.

Port of ``rlinf_tpu/models/embodiment/openpi.py`` (reference analog: the
openpi family, rlinf/models/embodiment/openpi and openpi_pytorch):

  prefix  = [image patch embeds | instruction token embeds]   (VLM weights)
  suffix  = [state token | K noisy-action tokens]             (expert weights)

  * Block-causal attention over blocks [prefix | state | actions]: full
    attention within a block, causal across blocks, expressed through the
    position-based mask (``mask_positions`` = block ids: prefix 0, state 1,
    actions 2).
  * The action expert is a second, narrower set of transformer weights that
    shares the VLM's head space (num_heads / num_kv_heads / head_dim): per
    layer, suffix tokens project q/k/v with expert weights and attend over
    [prefix KV | suffix KV].
  * The prefix is encoded once (``encode_prefix``: the port's
    ``vit_encode`` and ``forward_hidden(inputs_embeds=, mask_positions=,
    return_kv=True)``, bidirectional over ``positions = arange(Np)``) and
    its per-layer K/V is reused by every denoising step; only the
    (K+1)-token suffix runs per step.
  * RL: the flow-SDE denoising MDP with exact chain logprobs
    (``flow_utils.sample_sde`` / ``chain_logprobs``).

pi0.5 (``discrete_state=True``): the proprioceptive state enters the
PREFIX as discretized bin tokens (own embedding table) instead of a
continuous suffix token, and the expert MLP gets adaptive time conditioning.

A quirk of the reference is kept: the suffix's rope positions start at
``prefix_len = sum(prefix_valid)``, where the prefix's own positions are
``arange(Np)``; on a padded instruction the two differ (as the VLM's
positions quirk, ROADMAP.md §C.3).

``remat`` recomputes the trunk's and the tower's layers and each flow
step's expert pass in the backward; ``unroll_layers`` is accepted for the
JAX signature (the port's layers are a Python loop). Every step runs the
plain PyTorch attention (``impl="xla"``), as the JAX policy does: no
hand-written kernel is on this path. The trunk runs in its config's dtype;
the tower, projector, expert and heads in f32, as the JAX init makes them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from rlinf_tpu_torch.models.embodiment.base_policy import Policy, PolicyOutput, tree_from_numpy
from rlinf_tpu_torch.models.embodiment.flow_utils import (
    chain_entropy_like,
    chain_logprobs,
    flow_matching_loss,
    sample_ode,
    sample_sde,
    time_embed,
)
from rlinf_tpu_torch.models.embodiment.mlp_policy import _mlp_apply, _mlp_init
from rlinf_tpu_torch.models.embodiment.vit import ViTConfig, init_vit, vit_encode
from rlinf_tpu_torch.models.llm.config import LLMConfig
from rlinf_tpu_torch.models.llm.convert import params_from_numpy
from rlinf_tpu_torch.models.llm.model import forward_hidden, init_params as init_llm
from rlinf_tpu_torch.ops.attention import causal_attention
from rlinf_tpu_torch.ops.norm import rms_norm
from rlinf_tpu_torch.ops.rope import apply_rope, rope_frequencies
from rlinf_tpu_torch.utils.device import resolve_device

#: the expert's per-layer leaves, stacked [L, ...]
EXPERT_LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "gate", "up", "down")


@dataclasses.dataclass(frozen=True)
class Pi0Config:
    action_dim: int = 7
    action_chunk: int = 8          # pi0 uses a 50-step chunk at 50Hz; scaled
    state_dim: int = 8
    expert_hidden: int = 64        # pi0: 1024 (Gemma-300M width)
    expert_ffn: int = 128          # pi0: 4096
    time_embed_dim: int = 32
    num_flow_steps: int = 8        # pi0 uses 10
    sde_noise_scale: float = 0.5
    discrete_state: bool = False   # True => pi0.5
    state_bins: int = 32           # pi0.5 state discretization
    image_key: str = "images"
    text_key: str = "instruction_ids"
    text_mask_key: str = "instruction_mask"
    state_key: str = "states"

    @staticmethod
    def pi0_full() -> "Pi0Config":
        """Published pi0 geometry (action expert 1024/4096, 10 flow steps,
        50-step action chunks at action_dim 32)."""
        return Pi0Config(
            action_dim=32, action_chunk=50, state_dim=32,
            expert_hidden=1024, expert_ffn=4096, num_flow_steps=10,
        )


def _normal(generator, shape, device):
    """N(0, 0.02^2) f32 draws from ``generator`` (on its device) on ``device``."""
    return (torch.randn(shape, generator=generator, device=generator.device) * 0.02).to(device)


class Pi0Policy(Policy):
    """pi0/pi0.5 with the port's LLM as the VLM trunk.

    ``vlm_cfg`` sets the prefix trunk (PaliGemma's Gemma-2B in the real
    model; any LLMConfig here). The expert shares num_heads / num_kv_heads
    / head_dim with the VLM.
    """

    def __init__(
        self,
        cfg: Pi0Config = Pi0Config(),
        vlm_cfg: Optional[LLMConfig] = None,
        vit_cfg: Optional[ViTConfig] = None,
        remat: bool = False,
        unroll_layers: bool = False,
    ):
        self.remat = remat
        self.unroll_layers = unroll_layers
        self.cfg = cfg
        self.vlm_cfg = vlm_cfg or LLMConfig.tiny(vocab_size=256, max_seq_len=512)
        self.vit_cfg = vit_cfg or ViTConfig(
            image_size=32, patch_size=16, hidden=64, layers=1, heads=4
        )
        self.action_dim = cfg.action_dim * cfg.action_chunk

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator, device="cuda") -> Dict:
        """Every leaf drawn from ``generator`` on its device: the tower,
        projector, expert and heads f32, the trunk by
        ``models.llm.init_params(generator=)`` in its dtype."""
        device = resolve_device(device)
        c, v = self.cfg, self.vlm_cfg
        De, Fe, L = c.expert_hidden, c.expert_ffn, v.num_layers
        normal = lambda *shape: _normal(generator, shape, device)
        ones = lambda *shape: torch.ones(shape, device=device)
        params = {
            "vit": init_vit(self.vit_cfg, generator, device=device),
            "img_proj": _mlp_init(generator, (self.vit_cfg.hidden, v.hidden_size),
                                  scale_last=None, device=device),
            "vlm": init_llm(v, 0, device=device, generator=generator),
            "expert": {
                "attn_norm": ones(L, De),
                "wq": normal(L, De, v.q_dim),
                "wk": normal(L, De, v.kv_dim),
                "wv": normal(L, De, v.kv_dim),
                "wo": normal(L, v.q_dim, De),
                "mlp_norm": ones(L, De),
                "gate": normal(L, De, Fe),
                "up": normal(L, De, Fe),
                "down": normal(L, Fe, De),
                "final_norm": ones(De),
            },
            "action_in": _mlp_init(generator, (c.action_dim + c.time_embed_dim, De, De),
                                   scale_last=None, device=device),
            "action_out": _mlp_init(generator, (De, c.action_dim), scale_last=0.01,
                                    device=device),
            "value_head": _mlp_init(generator, (v.hidden_size, 1), scale_last=1.0,
                                    device=device),
        }
        if c.discrete_state:
            params["state_embed"] = normal(c.state_bins, v.hidden_size)
            params["time_ada"] = _mlp_init(generator, (c.time_embed_dim, De), scale_last=0.0,
                                           device=device)
        else:
            params["state_proj"] = _mlp_init(generator, (c.state_dim, De), scale_last=None,
                                             device=device)
        return params

    def params_from_numpy(self, tree, device="cuda") -> Dict:
        """The JAX package's params as numpy arrays -> the port's tree; the
        trunk's subtree through ``models.llm.params_from_numpy``."""
        device = resolve_device(device)
        out = {k: tree_from_numpy(v, device) for k, v in tree.items() if k != "vlm"}
        out["vlm"] = params_from_numpy(tree["vlm"], self.vlm_cfg, device=device)
        return out

    # ------------------------------------------------------------------
    # Prefix (VLM) encode -- once per observation
    # ------------------------------------------------------------------
    def encode_prefix(self, params, obs):
        """-> (prefix_k [L,B,Np,K,Hd], prefix_v, prefix_valid [B,Np],
        prefix_len [B], pooled [B,Dv] f32)."""
        c, v = self.cfg, self.vlm_cfg
        img = vit_encode(params["vit"], self.vit_cfg, obs[c.image_key], remat=self.remat)
        img = _mlp_apply([params["img_proj"][0]], img)  # [B, Ni, Dv]
        B, Ni = img.shape[:2]
        dev = img.device
        toks = [img]
        valid = [torch.ones((B, Ni), dtype=torch.bool, device=dev)]
        if c.text_key in obs:
            txt_ids = obs[c.text_key].long()
            toks.append(params["vlm"]["embed"][txt_ids].float())
            mask = obs.get(c.text_mask_key)
            valid.append(torch.ones(txt_ids.shape, dtype=torch.bool, device=dev)
                         if mask is None else mask.bool())
        if c.discrete_state:
            # pi0.5: state discretized into the prefix
            s = obs[c.state_key].float().clamp(-1.0, 1.0)
            bins = ((s + 1.0) * 0.5 * c.state_bins).to(torch.int32).clamp(0, c.state_bins - 1)
            toks.append(params["state_embed"][bins.long()])
            valid.append(torch.ones(bins.shape, dtype=torch.bool, device=dev))
        embeds = torch.cat(toks, dim=1)
        pvalid = torch.cat(valid, dim=1)
        Np = embeds.shape[1]
        hidden, kv = forward_hidden(
            params["vlm"], v, None,
            positions=torch.arange(Np, device=dev).expand(B, Np),
            attention_mask=pvalid,
            inputs_embeds=embeds,
            mask_positions=torch.zeros((B, Np), dtype=torch.int32, device=dev),  # bidirectional
            return_kv=True,
            remat=self.remat,
        )
        count = pvalid.sum(dim=1)
        pooled = (hidden.float() * pvalid[..., None]).sum(dim=1) / count[:, None].clamp_min(1)
        return kv.k, kv.v, pvalid, count.to(torch.int32), pooled

    # ------------------------------------------------------------------
    # Suffix (action expert) pass -- per flow step
    # ------------------------------------------------------------------
    def _suffix_tokens(self, params, obs, x_t, t):
        """Suffix token embeddings [B, Ns, De], block ids [Ns], t-embedding."""
        c = self.cfg
        B = x_t.shape[0]
        dev = x_t.device
        temb = time_embed(t.float(), c.time_embed_dim)  # [B, Te]
        act_in = torch.cat([x_t.float(),
                            temb[:, None, :].expand(B, c.action_chunk, c.time_embed_dim)],
                           dim=-1)
        act_tok = _mlp_apply(params["action_in"], act_in, activation=F.silu)  # [B, K, De]
        if c.discrete_state:
            return act_tok, torch.full((c.action_chunk,), 2, dtype=torch.int32, device=dev), temb
        state_tok = _mlp_apply([params["state_proj"][0]], obs[c.state_key].float())[:, None, :]
        block = torch.cat([torch.ones((1,), dtype=torch.int32, device=dev),
                           torch.full((c.action_chunk,), 2, dtype=torch.int32, device=dev)])
        return torch.cat([state_tok, act_tok], dim=1), block, temb

    def _expert_pass(self, params, prefix_k, prefix_v, prefix_valid,
                     prefix_len, obs, x_t, t):
        """Velocity v(x_t, t | prefix): the expert's suffix over the cached
        prefix K/V. x_t [B, K, A], t [B] -> [B, K, A]."""
        c = self.cfg
        x, block, temb = self._suffix_tokens(params, obs, x_t, t)
        ada = None
        if c.discrete_state:
            ada = 1.0 + _mlp_apply(params["time_ada"], temb)[:, None, :]
        x = self._suffix_hidden(params, prefix_k, prefix_v, prefix_valid, prefix_len,
                                x, block, ada)
        return _mlp_apply(params["action_out"], x[:, -c.action_chunk:, :])  # [B, K, A]

    def _suffix_hidden(self, params, prefix_k, prefix_v, prefix_valid,
                       prefix_len, x, block, ada=None):
        """Suffix tokens ``x`` [B, Ns, De] (block ids ``block`` [Ns]) through
        the expert layers over the cached prefix K/V; the final-norm hidden
        states [B, Ns, De]. Shared by the flow action expert and the RECAP
        value expert (``value_critic.py``)."""
        v = self.vlm_cfg
        ex = params["expert"]
        B, Ns, De = x.shape
        Np = prefix_k.shape[2]
        Hd = v.head_dim_
        dev = x.device

        cos, sin = rope_frequencies(Hd, v.max_seq_len, v.rope_theta, dev)
        pos = prefix_len[:, None] + torch.arange(Ns, device=dev)[None, :]  # [B, Ns]
        # block-causal mask coordinates: prefix block 0, suffix blocks 1/2
        mq = block[None].expand(B, Ns)
        mkv = torch.cat([torch.zeros((B, Np), dtype=torch.int32, device=dev), mq], dim=1)
        kvalid = torch.cat([prefix_valid, torch.ones((B, Ns), dtype=torch.bool, device=dev)],
                           dim=1)
        layers = zip(zip(*(ex[k].unbind(0) for k in EXPERT_LAYER_KEYS)), prefix_k.unbind(0),
                     prefix_v.unbind(0))
        for (attn_norm, wq, wk, wv, wo, mlp_norm, gate, up, down), pk, pv in layers:
            h = rms_norm(x, attn_norm, v.rms_eps)
            q = (h @ wq).reshape(B, Ns, v.num_heads, Hd)
            k = (h @ wk).reshape(B, Ns, v.num_kv_heads, Hd)
            vv = (h @ wv).reshape(B, Ns, v.num_kv_heads, Hd)
            q, k = apply_rope(q, k, cos, sin, pos)
            attn = causal_attention(
                q, torch.cat([pk.to(k.dtype), k], dim=1), torch.cat([pv.to(vv.dtype), vv], dim=1),
                positions_q=mq, positions_kv=mkv, kv_valid_mask=kvalid)
            x = x + attn.reshape(B, Ns, v.q_dim) @ wo
            h = rms_norm(x, mlp_norm, v.rms_eps)
            if ada is not None:
                h = h * ada  # pi0.5 adaptive time conditioning
            x = x + (F.silu(h @ gate) * (h @ up)) @ down
        return rms_norm(x, ex["final_norm"], v.rms_eps)

    def _velocity_fn(self, params, obs):
        """Closure (x_t, t) -> v with the prefix encoded ONCE."""
        pk, pv, pvalid, plen, pooled = self.encode_prefix(params, obs)
        fn = lambda x_t, t: self._expert_pass(params, pk, pv, pvalid, plen, obs, x_t, t)
        return fn, pooled

    # ------------------------------------------------------------------
    def value(self, params, obs):
        pooled = self.encode_prefix(params, obs)[-1]
        return _mlp_apply(params["value_head"], pooled)[..., 0]

    def flow_matching_loss(self, params, generator, obs, target_actions, *, x0=None, t=None):
        """BC/SFT loss; target_actions [B, K, A] or [B, K*A]."""
        c = self.cfg
        target = target_actions.reshape(-1, c.action_chunk, c.action_dim)
        fn, _ = self._velocity_fn(params, obs)
        return flow_matching_loss(fn, generator, target, x0=x0, t=t)

    def _shape(self, obs):
        c = self.cfg
        return (obs[c.image_key].shape[0], c.action_chunk, c.action_dim)

    def sample_ode(self, params, generator, obs, *, steps: Optional[int] = None, x0=None):
        fn, _ = self._velocity_fn(params, obs)
        return sample_ode(fn, generator, self._shape(obs), steps=steps or self.cfg.num_flow_steps,
                          x0=x0, device=obs[self.cfg.image_key].device)

    # Policy interface ---------------------------------------------------
    def default_forward(self, params, obs, actions) -> Dict[str, torch.Tensor]:
        """actions: flattened chain [B, (S+1)*K*A] (flow-SDE denoising MDP)."""
        c = self.cfg
        B = actions.shape[0]
        chain = actions.float().reshape(B, -1, c.action_chunk, c.action_dim)
        fn, pooled = self._velocity_fn(params, obs)
        lp = chain_logprobs(fn, chain, noise_scale=c.sde_noise_scale, remat=self.remat)
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
        """The chain from ``generator``'s draws (or the given ``x0`` and
        ``eps``); ``deterministic``: the ODE's x1."""
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
        # the chain rides along for training
        return PolicyOutput(actions=out.chain.reshape(B, -1), logprobs=out.logprobs,
                            values=values)

    def env_actions(self, policy_actions: torch.Tensor) -> torch.Tensor:
        """Extract x1 [B, K*A] from the flattened chain."""
        c = self.cfg
        B = policy_actions.shape[0]
        return policy_actions.reshape(B, -1, c.action_chunk, c.action_dim)[:, -1].reshape(B, -1)
