"""Minimal ViT image encoder (patchify + pre-norm transformer, NHWC).

Port of ``rlinf_tpu/models/embodiment/vit.py``: the backbone of the VLM
and the VLA policies (the in-tree analog of the reference's prismatic /
SigLIP vision towers). It runs the plain attention (``causal_attention``
with ``impl="xla"``, as the JAX package does) in bidirectional mode: every
position is 0, so no key is masked.

Two parameterizations:
  * default: RMSNorm, bias-free projections, tanh-approximate GELU;
  * ``timm_style=True``: LayerNorm with bias (biased variance, eps 1e-6),
    biased qkv/proj/mlp, exact erf GELU, optional class token, the layout
    of timm ``vision_transformer`` blocks.

Params are f32, layer weights stacked along a leading [L, ...] axis with
[D_in, D_out] matmul weights, the JAX package's keys and layouts. Inits draw
from an explicit CPU ``torch.Generator`` and move to the device.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from rlinf_tpu_torch.ops.attention import causal_attention
from rlinf_tpu_torch.ops.norm import rms_norm
from rlinf_tpu_torch.utils.device import resolve_device


def _linear_init(generator, fan_in, fan_out, scale=None, device="cuda"):
    scale = scale or (1.0 / math.sqrt(fan_in))
    w = torch.empty((fan_in, fan_out), device=generator.device).uniform_(
        -scale, scale, generator=generator)
    return {"w": w.to(device), "b": torch.zeros((fan_out,), device=device)}


class ViTConfig:
    def __init__(
        self,
        image_size: int = 96,
        patch_size: int = 16,
        hidden: int = 128,
        layers: int = 4,
        heads: int = 4,
        mlp_ratio: int = 4,
        channels: int = 3,
        timm_style: bool = False,
        cls_token: bool = False,
    ):
        if image_size % patch_size:
            raise ValueError(f"image_size {image_size} is not a multiple of "
                             f"patch_size {patch_size}")
        self.image_size = image_size
        self.patch_size = patch_size
        self.hidden = hidden
        self.layers = layers
        self.heads = heads
        self.mlp_ratio = mlp_ratio
        self.channels = channels
        self.timm_style = timm_style
        self.cls_token = cls_token and timm_style
        self.num_patches = (image_size // patch_size) ** 2
        self.patch_dim = patch_size * patch_size * channels

    @property
    def num_tokens(self) -> int:
        return self.num_patches + (1 if self.cls_token else 0)


def init_vit(cfg: ViTConfig, generator: torch.Generator, device="cuda") -> Dict:
    """Random f32 params: normal(0.02) matrices and position embeddings,
    uniform fan-in patch projection, ones/zeros norms and biases."""
    device = resolve_device(device)
    L, D = cfg.layers, cfg.hidden
    Fd = D * cfg.mlp_ratio

    def normal(*shape):
        return (torch.randn(shape, generator=generator, device=generator.device)
                * 0.02).to(device)

    def ones(*shape):
        return torch.ones(shape, device=device)

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    params = {
        "patch_proj": _linear_init(generator, cfg.patch_dim, D, device=device),
        "pos_embed": normal(cfg.num_tokens, D),
        "blocks": {
            "norm1": ones(L, D),
            "wqkv": normal(L, D, 3 * D),
            "wo": normal(L, D, D),
            "norm2": ones(L, D),
            "w1": normal(L, D, Fd),
            "w2": normal(L, Fd, D),
        },
        "final_norm": ones(D),
    }
    if cfg.timm_style:
        params["blocks"].update({
            "norm1_b": zeros(L, D),
            "bqkv": zeros(L, 3 * D),
            "bo": zeros(L, D),
            "norm2_b": zeros(L, D),
            "b1": zeros(L, Fd),
            "b2": zeros(L, D),
        })
        params["final_norm_b"] = zeros(D)
        if cfg.cls_token:
            params["cls_token"] = zeros(D)
    return params


def _layer_norm(x, w, b, eps=1e-6):
    """LayerNorm with the biased variance (``jnp.var``), eps 1e-6."""
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, N, patch*patch*C]."""
    B, H, W, C = images.shape
    images = images.reshape(B, H // patch, patch, W // patch, patch, C)
    return images.permute(0, 1, 3, 2, 4, 5).reshape(
        B, (H // patch) * (W // patch), patch * patch * C
    )


def vit_encode(
    params: Dict, cfg: ViTConfig, images: torch.Tensor, *, remat: bool = False,
    unroll: bool = False,
) -> torch.Tensor:
    """[B, H, W, C] (uint8 or float) -> [B, N, D] patch features, f32.

    With ``cfg.cls_token`` the class token is prepended (position 0) and kept
    in the output: callers that want patch features slice ``[:, 1:]``.
    ``remat`` recomputes each block in the backward
    (``torch.utils.checkpoint``, non-reentrant) as ``jax.checkpoint`` does;
    ``unroll`` is accepted for the JAX signature: the layers always run as
    a Python loop.
    """
    del unroll
    if images.dtype == torch.uint8:
        images = images.float() / 255.0 - 0.5
    x = patchify(images.float(), cfg.patch_size)
    x = x @ params["patch_proj"]["w"] + params["patch_proj"]["b"]
    if cfg.cls_token:
        cls = params["cls_token"].expand(x.shape[0], 1, cfg.hidden)
        x = torch.cat([cls, x], dim=1)
    x = x + params["pos_embed"]
    B, N, D = x.shape
    Hd = D // cfg.heads
    # bidirectional attention: equal positions disable the causal mask
    pos = torch.zeros((B, N), dtype=torch.int32, device=x.device)
    timm = cfg.timm_style

    def norm(x, layer, name):
        if timm:
            return _layer_norm(x, layer[name], layer[f"{name}_b"])
        return rms_norm(x, layer[name])

    def block(x, layer):
        h = norm(x, layer, "norm1")
        qkv = h @ layer["wqkv"]
        if timm:
            qkv = qkv + layer["bqkv"]
        q, k, v = (t.reshape(B, N, cfg.heads, Hd) for t in qkv.chunk(3, dim=-1))
        attn = causal_attention(q, k, v, positions_q=pos, positions_kv=pos)
        o = attn.reshape(B, N, D) @ layer["wo"]
        if timm:
            o = o + layer["bo"]
        x = x + o
        h = norm(x, layer, "norm2")
        h = h @ layer["w1"]
        if timm:
            h = h + layer["b1"]
        # timm uses exact erf-GELU (torch nn.GELU default); the from-scratch
        # towers keep the tanh approximation (jax.nn.gelu's default)
        h = F.gelu(h, approximate="none" if timm else "tanh") @ layer["w2"]
        if timm:
            h = h + layer["b2"]
        return x + h

    cols = {k: w.unbind(0) for k, w in params["blocks"].items()}
    for i in range(cfg.layers):
        layer = {k: c[i] for k, c in cols.items()}
        if remat and torch.is_grad_enabled():
            x = checkpoint(block, x, layer, use_reentrant=False)
        else:
            x = block(x, layer)
    if timm:
        return _layer_norm(x, params["final_norm"], params["final_norm_b"])
    return rms_norm(x, params["final_norm"])
