"""VLA checkpoint import/export: prismatic-style HF state dicts <-> the
port's param trees.

Port of ``rlinf_tpu/models/embodiment/hf_import.py`` (reference analog: the
pretrained OpenVLA / OpenVLA-OFT checkpoints and the converters under
rlinf/utils/ckpt_convertor/). Two vision-tower namings are handled:

  * **real prismatic/timm naming**: ``vision_backbone.featurizer.*`` (and
    ``vision_backbone.fused_featurizer.*`` for the fused SigLIP+DINOv2
    backbone) with timm ``vision_transformer`` keys: ``patch_embed.proj``
    (a conv kernel), ``cls_token``, ``pos_embed`` [1, N(+1), D], per-block
    ``norm1/norm2``, ``attn.qkv``, ``attn.proj``, ``mlp.fc1/fc2`` with their
    biases, the final ``norm``. The policy's ViT must be ``timm_style``.
  * **the repo's export format**: ``vision_backbone.patch_proj.*`` and
    bias-free blocks (what ``vla_params_to_state_dict`` writes for RMSNorm
    towers).

The projector (``projector.fc{i}.*``) and the language model
(``language_model.model.*``) are shared by both; the language model goes
through the port's ``models/llm/hf_import.py``. Files are read and written
by ``models/llm/hf_files.py`` (no safetensors package): single or sharded
safetensors and ``pytorch_model.bin``. Tensors are f32 on the CPU in a
state dict; the towers and the projector import as f32, the language model
in its config's dtype.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from rlinf_tpu_torch.models.llm.hf_files import load_state_dict, write_safetensors
from rlinf_tpu_torch.models.llm.hf_import import (
    params_from_hf_state_dict,
    params_to_hf_state_dict,
)
from rlinf_tpu_torch.utils.device import resolve_device


def _f32(t) -> torch.Tensor:
    """A tensor or array as an f32 CPU tensor."""
    return torch.as_tensor(np.asarray(t) if not torch.is_tensor(t) else t).detach().to(
        "cpu", torch.float32)


# ---------------------------------------------------------------------------
# state dict <-> param tree
# ---------------------------------------------------------------------------

def _tower_reader(sd, prefix, vit_cfg, device):
    def g(name):
        return sd[prefix + name].to(device)

    def stack(fmt, transpose=False):
        mats = [sd[prefix + fmt.format(i=i)] for i in range(vit_cfg.layers)]
        return torch.stack([m.T if transpose else m for m in mats]).contiguous().to(device)

    return g, stack


def _import_tower_repo(sd, prefix, vit_cfg, device):
    """The repo's export format: ``{prefix}patch_proj.*`` + bias-free blocks."""
    g, stack = _tower_reader(sd, prefix, vit_cfg, device)
    return {
        "patch_proj": {"w": g("patch_proj.weight").T.contiguous(), "b": g("patch_proj.bias")},
        "pos_embed": g("pos_embed"),
        "blocks": {
            "norm1": stack("blocks.{i}.norm1.weight"),
            "wqkv": stack("blocks.{i}.attn.qkv.weight", transpose=True),
            "wo": stack("blocks.{i}.attn.proj.weight", transpose=True),
            "norm2": stack("blocks.{i}.norm2.weight"),
            "w1": stack("blocks.{i}.mlp.fc1.weight", transpose=True),
            "w2": stack("blocks.{i}.mlp.fc2.weight", transpose=True),
        },
        "final_norm": g("norm.weight"),
    }


def _conv_patch_to_linear(w: torch.Tensor) -> torch.Tensor:
    """timm conv patch embed [D, C, p, p] -> [p*p*C, D] matching
    ``vit.patchify``'s (ph, pw, C) flatten."""
    return w.permute(2, 3, 1, 0).reshape(-1, w.shape[0]).contiguous()


def _import_tower_timm(sd, prefix, vit_cfg, device):
    """Real timm ``vision_transformer`` naming under ``{prefix}`` (e.g.
    ``vision_backbone.featurizer.``). Needs ``vit_cfg.timm_style``."""
    if not vit_cfg.timm_style:
        raise ValueError(
            f"checkpoint uses timm naming under {prefix!r} but the policy's "
            "ViT is not timm_style — build it with "
            "ViTConfig(..., timm_style=True)"
        )
    g, stack = _tower_reader(sd, prefix, vit_cfg, device)
    pe = g("pos_embed")
    if pe.ndim == 3:                      # timm stores [1, N(+cls), D]
        pe = pe[0]
    has_cls = prefix + "cls_token" in sd
    if has_cls and not vit_cfg.cls_token:
        raise ValueError(
            f"{prefix}cls_token present but ViTConfig(cls_token=False); the "
            "class-token row of pos_embed would be silently dropped"
        )
    tower = {
        "patch_proj": {"w": _conv_patch_to_linear(g("patch_embed.proj.weight")),
                       "b": g("patch_embed.proj.bias")},
        "pos_embed": pe,
        "blocks": {
            "norm1": stack("blocks.{i}.norm1.weight"),
            "norm1_b": stack("blocks.{i}.norm1.bias"),
            "wqkv": stack("blocks.{i}.attn.qkv.weight", transpose=True),
            "bqkv": stack("blocks.{i}.attn.qkv.bias"),
            "wo": stack("blocks.{i}.attn.proj.weight", transpose=True),
            "bo": stack("blocks.{i}.attn.proj.bias"),
            "norm2": stack("blocks.{i}.norm2.weight"),
            "norm2_b": stack("blocks.{i}.norm2.bias"),
            "w1": stack("blocks.{i}.mlp.fc1.weight", transpose=True),
            "b1": stack("blocks.{i}.mlp.fc1.bias"),
            "w2": stack("blocks.{i}.mlp.fc2.weight", transpose=True),
            "b2": stack("blocks.{i}.mlp.fc2.bias"),
        },
        "final_norm": g("norm.weight"),
        "final_norm_b": g("norm.bias"),
    }
    if has_cls:
        tower["cls_token"] = g("cls_token").reshape(-1)
    return tower


def vla_params_from_state_dict(state_dict: Mapping[str, object], policy, device="cuda"):
    """Prismatic-named state dict (tensors or arrays) -> OpenVLAPolicy param
    tree on ``device``.

    The vision-tower naming is detected per tower; a
    ``vision_backbone.fused_featurizer.*`` tower maps to ``params["vit2"]``
    (the policy must have a matching ``vit2_cfg``). Missing RL-only heads
    (``value_head``) stay absent: callers merge over a fresh init
    (``load_vla_pretrained``)."""
    device = resolve_device(device)
    sd = {k: _f32(v) for k, v in state_dict.items()}
    vit_cfg = policy.vit_cfg

    if any(k.startswith("vision_backbone.featurizer.") for k in sd):
        vit = _import_tower_timm(sd, "vision_backbone.featurizer.", vit_cfg, device)
    else:
        vit = _import_tower_repo(sd, "vision_backbone.", vit_cfg, device)

    out = {"vit": vit}
    if any(k.startswith("vision_backbone.fused_featurizer.") for k in sd):
        vit2_cfg = getattr(policy, "vit2_cfg", None)
        if vit2_cfg is None:
            raise ValueError(
                "checkpoint has a fused vision backbone "
                "(vision_backbone.fused_featurizer.*) but the policy has no "
                "vit2_cfg — build OpenVLAPolicy with fused=True"
            )
        out["vit2"] = _import_tower_timm(sd, "vision_backbone.fused_featurizer.", vit2_cfg,
                                         device)

    img_proj = []
    for i in range(1, 100):
        wk = f"projector.fc{i}.weight"
        if wk not in sd:
            break
        img_proj.append({"w": sd[wk].T.contiguous().to(device),
                         "b": sd[f"projector.fc{i}.bias"].to(device)})
    out["img_proj"] = img_proj

    lm_sd = {k.removeprefix("language_model."): v
             for k, v in sd.items() if k.startswith("language_model.")}
    out["vlm"] = params_from_hf_state_dict(lm_sd, policy.vlm_cfg, device=device)
    return out


def _export_tower_repo(out, prefix, tower, vit_cfg):
    out[prefix + "patch_proj.weight"] = _f32(tower["patch_proj"]["w"]).T.contiguous()
    out[prefix + "patch_proj.bias"] = _f32(tower["patch_proj"]["b"])
    out[prefix + "pos_embed"] = _f32(tower["pos_embed"])
    out[prefix + "norm.weight"] = _f32(tower["final_norm"])
    b = {k: _f32(v) for k, v in tower["blocks"].items()}
    for i in range(vit_cfg.layers):
        p = f"{prefix}blocks.{i}."
        out[p + "norm1.weight"] = b["norm1"][i]
        out[p + "attn.qkv.weight"] = b["wqkv"][i].T.contiguous()
        out[p + "attn.proj.weight"] = b["wo"][i].T.contiguous()
        out[p + "norm2.weight"] = b["norm2"][i]
        out[p + "mlp.fc1.weight"] = b["w1"][i].T.contiguous()
        out[p + "mlp.fc2.weight"] = b["w2"][i].T.contiguous()


def _export_tower_timm(out, prefix, tower, vit_cfg):
    """Inverse of ``_import_tower_timm`` (true timm key names)."""
    w = _f32(tower["patch_proj"]["w"])            # [p*p*C, D]
    p_, C, D = vit_cfg.patch_size, vit_cfg.channels, vit_cfg.hidden
    out[prefix + "patch_embed.proj.weight"] = w.reshape(p_, p_, C, D).permute(3, 2, 0, 1) \
        .contiguous()
    out[prefix + "patch_embed.proj.bias"] = _f32(tower["patch_proj"]["b"])
    out[prefix + "pos_embed"] = _f32(tower["pos_embed"])[None]
    if "cls_token" in tower:
        out[prefix + "cls_token"] = _f32(tower["cls_token"]).reshape(1, 1, -1)
    out[prefix + "norm.weight"] = _f32(tower["final_norm"])
    out[prefix + "norm.bias"] = _f32(tower["final_norm_b"])
    b = {k: _f32(v) for k, v in tower["blocks"].items()}
    names = (("norm1.weight", "norm1", False), ("norm1.bias", "norm1_b", False),
             ("attn.qkv.weight", "wqkv", True), ("attn.qkv.bias", "bqkv", False),
             ("attn.proj.weight", "wo", True), ("attn.proj.bias", "bo", False),
             ("norm2.weight", "norm2", False), ("norm2.bias", "norm2_b", False),
             ("mlp.fc1.weight", "w1", True), ("mlp.fc1.bias", "b1", False),
             ("mlp.fc2.weight", "w2", True), ("mlp.fc2.bias", "b2", False))
    for i in range(vit_cfg.layers):
        for name, key, transpose in names:
            t = b[key][i]
            out[f"{prefix}blocks.{i}.{name}"] = t.T.contiguous() if transpose else t


def vla_params_to_state_dict(params, policy) -> Dict[str, torch.Tensor]:
    """Inverse relayout (export half), f32 CPU tensors. timm-style towers
    export under real ``vision_backbone.featurizer.*`` timm naming; RMSNorm
    towers under the repo's ``vision_backbone.*`` scheme."""
    out: Dict[str, torch.Tensor] = {}
    if policy.vit_cfg.timm_style:
        _export_tower_timm(out, "vision_backbone.featurizer.", params["vit"], policy.vit_cfg)
    else:
        _export_tower_repo(out, "vision_backbone.", params["vit"], policy.vit_cfg)
    if "vit2" in params:
        _export_tower_timm(out, "vision_backbone.fused_featurizer.", params["vit2"],
                           policy.vit2_cfg)
    for i, layer in enumerate(params["img_proj"], start=1):
        out[f"projector.fc{i}.weight"] = _f32(layer["w"]).T.contiguous()
        out[f"projector.fc{i}.bias"] = _f32(layer["b"])
    for k, v in params_to_hf_state_dict(params["vlm"], policy.vlm_cfg).items():
        out["language_model." + k] = v
    return out


# ---------------------------------------------------------------------------
# checkpoint directory IO
# ---------------------------------------------------------------------------

def read_checkpoint_dir(path: str) -> Dict[str, torch.Tensor]:
    """An HF checkpoint dir's state dict (CPU tensors in the files' dtypes):
    sharded or single safetensors, or a torch ``.bin``."""
    return load_state_dict(path)


def save_checkpoint_dir(state_dict: Mapping[str, object], path: str):
    """Write a single-file safetensors checkpoint (HF layout) of tensors or
    arrays, each in its own dtype."""
    os.makedirs(path, exist_ok=True)
    write_safetensors(os.path.join(path, "model.safetensors"),
                      {k: v if torch.is_tensor(v) else torch.as_tensor(np.ascontiguousarray(v))
                       for k, v in state_dict.items()})


def load_vla_pretrained(path: str, policy, generator: Optional[torch.Generator] = None,
                        device="cuda"):
    """Checkpoint dir -> full param tree on ``device`` (pretrained weights
    merged over a fresh init from ``generator``, so RL-only heads like
    value_head are present)."""
    device = resolve_device(device)
    pre = vla_params_from_state_dict(read_checkpoint_dir(path), policy, device=device)
    full = policy.init(generator if generator is not None else torch.Generator().manual_seed(0),
                       device=device)
    full.update(pre)
    return full
