"""Decoder-only transformer (Qwen2/Qwen3/Llama family, dense or MoE), plain
functions on tensors.

Port of ``rlinf_tpu/models/llm/model.py``: the differentiable forward of
training (with per-block rematerialization, and a multimodal prefix through
``inputs_embeds``), prefill, the unpacked KV-cache decode steps of the VLM
(``decode_step``, ``decode_step_ragged``, ``decode_step_layered``) and the
packed (bf16 and int8) ones. Parameters are a dict of
tensors with the JAX package's key names and layouts: layer weights are
stacked along a leading [L, ...] axis and matmul weights are [D_in, D_out]
(``convert.params_from_numpy`` turns a JAX param tree into this dict).
Layers run as a Python loop where JAX used ``lax.scan``. All matmuls run in
the config compute dtype with fp32 softmax/norm statistics.

Under an active mesh (``parallel.mesh.use_mesh``) each leaf is this rank's
block under ``partition_rules()`` and the forward is Megatron's: the
column-parallel ``wq/wk/wv/gate/up`` give the rank's heads and columns
(``local_config``), the row-parallel ``wo/down`` are followed by an
all-reduce over the tensor axis, and the vocab-sharded ``embed`` is looked
up with a mask and summed. An fsdp-sharded leaf is gathered one layer at a
time before use, and its gradient reduce-scattered (``_gather_layer``);
which dims a leaf's block splits is read from ``param_layout``.
The lm-head kernels take the whole operand (``full_output_params``). An
MoE layer keeps its router whole and splits each expert's columns over the
tensor axis (``moe_gate``/``moe_up`` column-parallel, ``moe_down``
row-parallel), with one all-reduce after ``down``, for the capacity and
the dropless dispatch alike.

Under ``attn_impl="ring"`` on a mesh whose context axis has more than one
rank, ``forward_hidden`` takes whole rows, computes the positions on them
(``cumsum(mask) - 1`` on a chunk would be wrong) and runs every layer on
this rank's contiguous chunk of the sequence (``sharding.context_chunk``),
attention by ``ops/ring_attention.py``; it returns the chunk's hidden
states and K/V. ``prefill`` gathers them whole over the context group, so
that decoding reads the whole cache on every context rank, as JAX's decode
reads the cache XLA regathers. An MoE layer there counts its capacity,
slots and statistics over the whole [B, S] batch (``ops.moe``'s row split
gains the context axis).

Under an expert axis (``mesh.expert > 1``) the expert stacks are split on
E (``P(None, expert, fsdp, tensor)``) while the rows are split over the
batch axes only, as the JAX package's rules put them: every expert rank
sees the same rows, routes them alike with the whole router, computes the
pairs routed to its own experts, and the output is all-reduced over the
expert x tensor group (``ops.moe``). The rollout takes the expert stacks
gathered whole (``rollout_params``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from rlinf_tpu_torch.models.llm.config import LLMConfig
from rlinf_tpu_torch.models.llm.quant import QTensor, mm
from rlinf_tpu_torch.ops.attention import causal_attention, decode_attention
from rlinf_tpu_torch.ops.cuda.decode_attention import (
    decode_attention_packed,
    decode_attention_packed_q8,
    decode_attention_packed_q8_xla,
    decode_attention_packed_xla,
    quantize_kv_token,
)
from rlinf_tpu_torch.ops.moe import moe_layer, row_split, rows_split_over
from rlinf_tpu_torch.ops.norm import rms_norm
from rlinf_tpu_torch.ops.rope import apply_rope, rope_frequencies
from rlinf_tpu_torch.parallel import collectives as C
from rlinf_tpu_torch.parallel.mesh import AxisNames as Ax, current_mesh, use_mesh
from rlinf_tpu_torch.parallel.sharding import P, Layout, context_chunk, sharded_axes
from rlinf_tpu_torch.utils.device import resolve_device

Params = Dict[str, object]


# ---------------------------------------------------------------------------
# Partition rules and the mesh
# ---------------------------------------------------------------------------

def partition_rules():
    """Megatron-style TP + fsdp sharding for the stacked-layer layout (the
    JAX package's table)."""
    t, f = Ax.TENSOR, Ax.FSDP
    return [
        (r"embed", P(t, f)),                 # vocab-sharded embedding table
        (r"blocks/wq", P(None, f, t)),       # column parallel [L, D, H*Hd]
        (r"blocks/wk", P(None, f, t)),
        (r"blocks/wv", P(None, f, t)),
        (r"blocks/bq", P(None, t)),
        (r"blocks/bk", P(None, t)),
        (r"blocks/bv", P(None, t)),
        (r"blocks/wo", P(None, t, f)),       # row parallel [L, H*Hd, D]
        (r"blocks/gate", P(None, f, t)),
        (r"blocks/up", P(None, f, t)),
        (r"blocks/down", P(None, t, f)),
        (r"blocks/moe_router", P(None, f, None)),
        (r"blocks/moe_gate", P(None, Ax.EXPERT, f, t)),
        (r"blocks/moe_up", P(None, Ax.EXPERT, f, t)),
        (r"blocks/moe_down", P(None, Ax.EXPERT, t, f)),
        (r"blocks/attn_norm", P(None, None)),
        (r"blocks/mlp_norm", P(None, None)),
        (r"blocks/(q|k)_norm", P(None, None)),
        (r"final_norm", P()),
        (r"lm_head", P(f, t)),               # [D, V] vocab-sharded output
    ]


def check_mesh(cfg: LLMConfig, mesh) -> None:
    """Raise unless the port's sharded forward takes ``cfg`` on ``mesh``:
    the tensor axis must divide the heads, the kv heads and the MLP width
    (the blocks are split by whole heads and columns), and an expert axis
    needs experts that it divides (the JAX config's checks)."""
    if mesh is None:
        return
    ep = mesh.size(Ax.EXPERT)
    if ep > 1:
        if not cfg.is_moe:
            raise ValueError(f"mesh.{Ax.EXPERT} > 1 but the model has no experts "
                             "(model.num_experts == 0); set mesh.expert=1")
        if cfg.num_experts % ep:
            raise ValueError(f"model.num_experts ({cfg.num_experts}) not divisible by "
                             f"mesh.{Ax.EXPERT} ({ep})")
    tp = mesh.size(Ax.TENSOR)
    for name in ("num_heads", "num_kv_heads", "intermediate_size"):
        if getattr(cfg, name) % tp:
            raise ValueError(f"model.{name} ({getattr(cfg, name)}) not divisible by "
                             f"mesh.tensor ({tp})")


def local_config(cfg: LLMConfig, mesh=None) -> LLMConfig:
    """The config of this rank's shard: heads, kv heads and MLP width over
    the tensor axis (``cfg`` itself without one)."""
    tp = mesh.size(Ax.TENSOR) if mesh is not None else 1
    if tp == 1:
        return cfg
    check_mesh(cfg, mesh)
    return dataclasses.replace(
        cfg, num_heads=cfg.num_heads // tp, num_kv_heads=cfg.num_kv_heads // tp,
        head_dim=cfg.head_dim_, intermediate_size=cfg.intermediate_size // tp)


def _groups():
    """(mesh, tensor group, fsdp group) of the active mesh, or Nones."""
    mesh = current_mesh()
    if mesh is None:
        return None, None, None
    return mesh, mesh.get_group(Ax.TENSOR), mesh.get_group(Ax.FSDP)


@functools.lru_cache(maxsize=16)
def param_layout(cfg: LLMConfig, mesh) -> Layout:
    """The layout of ``cfg``'s params on ``mesh``: each leaf's spec under
    ``partition_rules()``, resolved against the full shapes (made on the
    meta device). The sharded forward reads from it which dims of a leaf's
    block to gather; the train step and the checkpoints resolve the same
    rules (``training.sharded_step.model_layout``)."""
    return Layout.from_rules(mesh, partition_rules(), init_params(cfg, 0, device="meta"))


def _split_dims(cfg: LLMConfig, mesh, path: str, w, axis: str, lead: int = 0):
    """The dims of ``w`` that ``axis`` splits, where ``w`` is this rank's
    block of the leaf at ``path`` with its first ``lead`` dims taken off
    (a layer of a stacked leaf: ``lead=1``); none where ``w`` is not that
    block (a leaf already gathered, a quantized weight)."""
    lay = param_layout(cfg, mesh)
    if not torch.is_tensor(w) or path not in lay.specs or \
            tuple(w.shape) != lay.local_shapes[path][lead:]:
        return ()
    return tuple(d - lead for d, a in enumerate(lay.specs[path])
                 if a is not None and axis in sharded_axes((a,)) and d >= lead)


def _gather_layer(layer: Params, cfg: LLMConfig, mesh, fsdp) -> Params:
    """One layer's fsdp-sharded leaves gathered whole (their gradient is
    reduce-scattered back over fsdp)."""
    if fsdp is None:
        return layer
    out = dict(layer)
    for k, w in layer.items():
        for d in _split_dims(cfg, mesh, f"blocks/{k}", w, Ax.FSDP, lead=1):
            out[k] = C.all_gather(out[k], d, fsdp, backward="reduce_scatter")
    return out


def ring_mesh(attn_impl: str):
    """The active mesh where ``attn_impl`` is "ring" and its context axis
    has more than one rank (the sequence is then split over it), else
    None."""
    if attn_impl != "ring":
        return None
    mesh = current_mesh()
    if mesh is None or mesh.size(Ax.CONTEXT) == 1:
        return None
    return mesh


def context_chunks(batch: Dict[str, torch.Tensor], attn_impl: str) -> Dict[str, torch.Tensor]:
    """This rank's sequence chunk of every per-token [B, T, ...] tensor of
    ``batch`` where ``attn_impl`` splits the sequence over the context axis
    (``ring_mesh``); ``batch`` itself otherwise. The loss's inputs
    (targets, masks, advantages) line up with ``forward_hidden``'s chunk."""
    mesh = ring_mesh(attn_impl)
    if mesh is None:
        return batch
    return {k: context_chunk(v, mesh) if torch.is_tensor(v) and v.dim() >= 2 else v
            for k, v in batch.items()}


def gather_sequence(hidden: torch.Tensor, cache: Optional["KVCache"], attn_impl: str):
    """``forward_hidden``'s chunk of the hidden states [B, S/cp, D] and of
    its KVCache [L, B, S/cp, K, D] gathered whole over the context group
    where ``attn_impl`` split the sequence (``ring_mesh``); as they are
    otherwise."""
    mesh = ring_mesh(attn_impl)
    if mesh is None:
        return hidden, cache
    g = mesh.get_group(Ax.CONTEXT)
    hidden = C.gather_tensor(hidden, 1, g)
    if cache is not None:
        cache = KVCache(k=C.gather_tensor(cache.k, 2, g), v=C.gather_tensor(cache.v, 2, g))
    return hidden, cache


def embed_tokens(params: Params, cfg: LLMConfig, ids: torch.Tensor) -> torch.Tensor:
    """Token embeddings in the compute dtype. A vocab-sharded table (this
    rank holds rows [lo, lo + V/tp)) is looked up with a mask and summed
    over the tensor axis; an fsdp-sharded one is gathered first."""
    w = params["embed"]
    mesh, tp, fsdp = _groups()
    ids = ids.long()
    if mesh is None:
        return w[ids].to(cfg.compute_dtype)
    vocab_split = _split_dims(cfg, mesh, "embed", w, Ax.TENSOR)
    for d in _split_dims(cfg, mesh, "embed", w, Ax.FSDP):
        w = C.all_gather(w, d, fsdp, backward="reduce_scatter")
    if not vocab_split:
        return w[ids].to(cfg.compute_dtype)
    v_local = w.shape[0]
    local = ids - mesh.axis_index(Ax.TENSOR) * v_local
    inside = (local >= 0) & (local < v_local)
    x = w[local.clamp(0, v_local - 1)] * inside[..., None].to(w.dtype)
    return C.all_reduce(x, tp).to(cfg.compute_dtype)


def _gather_whole(w, cfg: LLMConfig, mesh, path: str, autograd: bool):
    """The leaf at ``path`` gathered whole from this rank's block: with
    autograd, its gradient is reduce-scattered over fsdp (the ranks' rows
    are different terms of the loss) and sliced over the tensor axis
    (every tensor rank computes the same loss)."""
    fsdp_dims = _split_dims(cfg, mesh, path, w, Ax.FSDP)
    tp_dims = _split_dims(cfg, mesh, path, w, Ax.TENSOR)
    for d in fsdp_dims:
        g = mesh.get_group(Ax.FSDP)
        w = (C.all_gather(w, d, g, backward="reduce_scatter") if autograd
             else C.gather_tensor(w, d, g))
    for d in tp_dims:
        g = mesh.get_group(Ax.TENSOR)
        w = C.all_gather(w, d, g, backward="split") if autograd else C.gather_tensor(w, d, g)
    return w


def full_output_params(params: Params, cfg: LLMConfig) -> Params:
    """``params`` with the lm head (``lm_head``, or the tied ``embed``)
    gathered whole, for the kernels that take the whole operand (K4, K5,
    K6)."""
    mesh = current_mesh()
    if mesh is None:
        return params
    key = "lm_head" if "lm_head" in params else "embed"
    return {**params, key: _gather_whole(params[key], cfg, mesh, key, autograd=True)}


def rollout_params(params: Params, cfg: LLMConfig) -> Params:
    """The weights generation reads under the active mesh: the block
    weights gathered over fsdp and the expert stacks over the expert axis
    (tensor-parallel blocks stay this rank's), the embedding and the lm
    head whole (K4 samples from the whole head). Without a mesh, ``params``
    itself. Gathering the experts once a rollout moves L x 3 x E x D x F
    elements (of which this rank held 1/ep) where decoding with the split
    experts would all-reduce the MoE output of every layer in every decode
    step."""
    mesh, _, fsdp = _groups()
    if mesh is None:
        return params
    with torch.no_grad():
        out = dict(params)
        for key in ("embed", "lm_head"):
            if key in out:
                out[key] = _gather_whole(out[key], cfg, mesh, key, autograd=False)
        blocks = dict(params["blocks"])
        for k, w in params["blocks"].items():
            split = [(d, a) for a in (Ax.FSDP, Ax.EXPERT)
                     for d in _split_dims(cfg, mesh, f"blocks/{k}", w, a)]
            for d, a in split:
                blocks[k] = C.gather_tensor(blocks[k], d, mesh.get_group(a))
        out["blocks"] = blocks
    return out


def shard_params_from_numpy(tree, cfg: LLMConfig, mesh, device="cuda") -> Params:
    """The JAX package's params as numpy (``jax.device_get``) -> this
    rank's blocks under ``partition_rules()``, on ``device``: both
    packages then compute from the same weights."""
    from rlinf_tpu_torch.models.llm.convert import params_from_numpy
    from rlinf_tpu_torch.parallel.sharding import match_partition_rules, shard_pytree

    full = params_from_numpy(tree, cfg, device=device)
    if mesh is None:
        return full
    check_mesh(cfg, mesh)
    return shard_pytree(full, match_partition_rules(partition_rules(), full), mesh)


class KVCache(NamedTuple):
    """Decode cache: k/v of [L, B, S_max, K, D]."""

    k: torch.Tensor
    v: torch.Tensor


def init_params(cfg: LLMConfig, seed: int, device="cuda") -> Params:
    """Random init matching the HF Qwen2 scheme (normal(0.02), ones norms),
    drawn with numpy from ``seed`` so that it does not depend on the device.
    An MoE config draws the router and expert stacks (``moe_router`` [L, D,
    E], ``moe_gate``/``moe_up`` [L, E, D, F], ``moe_down`` [L, E, F, D]) where
    a dense one draws ``gate``/``up``/``down``."""
    device = resolve_device(device)
    dt = cfg.compute_dtype
    d, f, l = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    qd, kvd = cfg.q_dim, cfg.kv_dim
    rng = np.random.default_rng(seed)

    def normal(shape):
        if device.type == "meta":       # shapes only (the sharding layout)
            return torch.empty(shape, dtype=dt, device=device)
        a = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
        return a.to(device=device).to(dt) * 0.02

    def ones(shape):
        return torch.ones(shape, dtype=dt, device=device)

    def zeros(shape):
        return torch.zeros(shape, dtype=dt, device=device)

    blocks = {
        "attn_norm": ones((l, d)),
        "wq": normal((l, d, qd)),
        "wk": normal((l, d, kvd)),
        "wv": normal((l, d, kvd)),
        "wo": normal((l, qd, d)),
        "mlp_norm": ones((l, d)),
    }
    if cfg.is_moe:
        e = cfg.num_experts
        blocks["moe_router"] = normal((l, d, e))
        blocks["moe_gate"] = normal((l, e, d, f))
        blocks["moe_up"] = normal((l, e, d, f))
        blocks["moe_down"] = normal((l, e, f, d))
    else:
        blocks["gate"] = normal((l, d, f))
        blocks["up"] = normal((l, d, f))
        blocks["down"] = normal((l, f, d))
    params: Params = {
        "embed": normal((cfg.vocab_size, d)),
        "blocks": blocks,
        "final_norm": ones((d,)),
    }
    if cfg.qkv_bias:
        blocks["bq"] = zeros((l, qd))
        blocks["bk"] = zeros((l, kvd))
        blocks["bv"] = zeros((l, kvd))
    if cfg.qk_norm:
        blocks["q_norm"] = ones((l, cfg.head_dim_))
        blocks["k_norm"] = ones((l, cfg.head_dim_))
    if not cfg.tie_word_embeddings:
        params["lm_head"] = normal((d, cfg.vocab_size))
    return params


def _layers(blocks: Params, n: int):
    """Every layer of the stacked block params, as views (no copies) from
    one ``unbind`` per leaf: under autograd the gradients of all layers are
    stacked once, where one index per layer would add an [L, ...] buffer
    per layer."""
    cols = {
        k: ([QTensor(q, s) for q, s in zip(w.q.unbind(0), w.scale.unbind(0))]
            if isinstance(w, QTensor) else w.unbind(0))
        for k, w in blocks.items()
    }
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _project_qkv(cfg: LLMConfig, layer: Params, h: torch.Tensor, B: int, S: int):
    """qkv projection + bias + head reshape + optional Qwen3 qk-norm.
    h: [B, S, D] -> q [B,S,H,Hd], k/v [B,S,K,Hd] (pre-RoPE)."""
    Hd = cfg.head_dim_
    if "wqkv" in layer:
        # fused decode weights (quantize_params(fuse=True)): one matmul
        qkv = mm(h, layer["wqkv"])
        qd, kd = cfg.q_dim, cfg.kv_dim
        q, k, v = qkv[..., :qd], qkv[..., qd:qd + kd], qkv[..., qd + kd:]
    else:
        q = mm(h, layer["wq"])
        k = mm(h, layer["wk"])
        v = mm(h, layer["wv"])
    if cfg.qkv_bias:
        q = q + layer["bq"]
        k = k + layer["bk"]
        v = v + layer["bv"]
    q = q.reshape(B, S, cfg.num_heads, Hd)
    k = k.reshape(B, S, cfg.num_kv_heads, Hd)
    v = v.reshape(B, S, cfg.num_kv_heads, Hd)
    if cfg.qk_norm:
        q = rms_norm(q, layer["q_norm"], cfg.rms_eps)
        k = rms_norm(k, layer["k_norm"], cfg.rms_eps)
    return q, k, v


def _mlp_or_moe(cfg: LLMConfig, x: torch.Tensor, layer: Params, tp=None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Dense SwiGLU MLP or MoE block, residual included. Returns (x, aux):
    the MoE layer's auxiliary loss, None for a dense MLP (the JAX package's
    zero, not made on the device in every layer). ``tp``: the tensor
    group, whose ranks hold the MLP's columns (the down projection's rows)."""
    h = rms_norm(x, layer["mlp_norm"], cfg.rms_eps)
    if cfg.is_moe:
        moe_params = {
            "router": layer["moe_router"],
            "gate": layer["moe_gate"],
            "up": layer["moe_up"],
            "down": layer["moe_down"],
        }
        mesh = current_mesh()
        ep = None
        if mesh is not None and layer["moe_gate"].shape[0] < cfg.num_experts:
            # this rank's block of the experts: the others' outputs come
            # from the all-reduce over the expert x tensor group
            ep, tp = mesh.get_group(Ax.EXPERT), mesh.get_group((Ax.EXPERT, Ax.TENSOR))
        out, aux = moe_layer(moe_params, h, cfg.moe_config, tp, ep)
        return x + C.all_reduce(out, tp).to(x.dtype), aux
    h = C.copy_to(h, tp)
    if "wgu" in layer:
        gu = mm(h, layer["wgu"])
        f = gu.shape[-1] // 2
        gated = F.silu(gu[..., :f]) * gu[..., f:]
    else:
        gated = F.silu(mm(h, layer["gate"])) * mm(h, layer["up"])
    return x + C.all_reduce(mm(gated, layer["down"]), tp), None


def _block(
    cfg: LLMConfig,
    x: torch.Tensor,
    layer: Params,
    cos: torch.Tensor,
    sin: torch.Tensor,
    positions: torch.Tensor,
    kv_valid_mask: Optional[torch.Tensor],
    attn_impl: str,
    mask_positions: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor], Optional[torch.Tensor]]:
    """One transformer block. Returns (x_out, (k, v), moe aux or None) with
    k/v [B,S,K,D] (this rank's kv heads under a tensor axis).

    mask_positions: optional [B, S] ints used for the causality test in
    place of ``positions`` (RoPE still uses ``positions``): tokens that
    share a mask position attend to each other both ways (prefix-LM and
    block-causal masks)."""
    B, S, _ = x.shape
    mesh, tp, fsdp = _groups()
    lc = local_config(cfg, mesh)
    layer = _gather_layer(layer, cfg, mesh, fsdp)
    h = C.copy_to(rms_norm(x, layer["attn_norm"], cfg.rms_eps), tp)
    q, k, v = _project_qkv(lc, layer, h, B, S)
    q, k = apply_rope(q, k, cos, sin, positions)
    mpos = positions if mask_positions is None else mask_positions
    attn = causal_attention(
        q, k, v,
        positions_q=mpos,
        positions_kv=mpos,
        kv_valid_mask=kv_valid_mask,
        impl=attn_impl,
    )
    x = x + C.all_reduce(mm(attn.reshape(B, S, lc.q_dim), layer["wo"]), tp)
    x, aux = _mlp_or_moe(cfg, x, layer, tp)
    return x, (k, v), aux


#: the products remat="dots" keeps: plain matrix products (the projections,
#: [B*S, D] x [D, out] after matmul's reshape); batched products (bmm, the
#: plain attention's scores) are recomputed
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _SAVED_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_save_dots_contexts = functools.partial(create_selective_checkpoint_contexts, _dots_policy)


def forward_hidden(
    params: Params,
    cfg: LLMConfig,
    input_ids: Optional[torch.Tensor],
    positions: Optional[torch.Tensor] = None,
    attention_mask: Optional[torch.Tensor] = None,
    *,
    inputs_embeds: Optional[torch.Tensor] = None,
    mask_positions: Optional[torch.Tensor] = None,
    attn_impl: str = "xla",
    return_kv: bool = False,
    remat=False,
    return_aux: bool = False,
    unroll_layers: bool = False,
):
    """Token ids [B, S] -> (final hidden states [B, S, D] (pre-lm_head),
    KVCache or None), and with ``return_aux`` the MoE auxiliary loss summed
    over layers (f32 scalar, 0 for a dense model) as a third item.

    attention_mask: [B, S] bool, False = padding (left or right).
    inputs_embeds: [B, S, D] in place of the embedding lookup (``input_ids``
      None): multimodal prefixes, image patch embeddings spliced before the
      text. Cast to the compute dtype.
    mask_positions: [B, S] ints for the causality test only (see
      ``_block``): prefix-LM and block-causal attention.
    remat: True or "full" recomputes each block in the backward
      (``torch.utils.checkpoint``, non-reentrant), as ``jax.checkpoint``
      does; "dots" keeps the outputs of the projections (``aten.mm`` and
      ``aten.addmm``, products with no batch dims) and recomputes the rest
      (norms, rope, activations, attention), as
      ``dots_with_no_batch_dims_saveable`` does. The attention kernels
      launch inside an autograd Function that the dispatcher does not see
      into, so they are recomputed under either form.
    unroll_layers: accepted for the JAX signature; the port always runs the
      layers as a Python loop.

    Under ``attn_impl="ring"`` on a mesh with a context axis > 1 the inputs
    are whole rows (S divisible by the context axis) and the hidden states
    and K/V returned are this rank's chunk of the sequence, [B, S/cp, ...]
    (``gather_sequence`` makes them whole). Under remat the backward
    replays each block's forward, ring shifts included: every rank replays
    the same blocks in the same order, so the shifts meet.
    """
    del unroll_layers
    if remat not in (False, True, "full", "dots"):
        raise ValueError(f"remat must be False, True, 'full' or 'dots', got {remat!r}")
    B, S = (input_ids if inputs_embeds is None else inputs_embeds).shape[:2]
    dev = (input_ids if inputs_embeds is None else inputs_embeds).device
    if positions is None:
        if attention_mask is not None:
            positions = (attention_mask.to(torch.int32).cumsum(dim=-1) - 1).clamp_min(0)
        else:
            positions = torch.arange(S, device=dev).expand(B, S)
    ring = ring_mesh(attn_impl)
    if ring is not None:
        # the positions come from the whole row; every layer runs on the chunk
        cut = lambda t: None if t is None else context_chunk(t, ring)
        input_ids, inputs_embeds = cut(input_ids), cut(inputs_embeds)
        positions, attention_mask = cut(positions), cut(attention_mask)
        mask_positions = cut(mask_positions)

    cos, sin = rope_frequencies(cfg.head_dim_, cfg.max_seq_len, cfg.rope_theta, dev)
    if inputs_embeds is None:
        x = embed_tokens(params, cfg, input_ids)
    else:
        x = inputs_embeds.to(cfg.compute_dtype)

    # the active mesh and MoE row split, set again around each block: remat
    # recomputes a block in the backward, which on the card runs in the
    # autograd engine's own thread, where the caller's context is not set
    mesh, (rows_mesh, rows, real_rows) = current_mesh(), row_split()
    if ring is not None and Ax.CONTEXT not in rows:
        # the MoE layers see the chunk: their batch is split over context too
        rows_mesh, rows = ring, tuple(rows) + (Ax.CONTEXT,)

    def block_fn(x, layer):
        with use_mesh(mesh), rows_split_over(rows_mesh, rows, real_rows):
            return _block(cfg, x, layer, cos, sin, positions, attention_mask, attn_impl,
                          mask_positions)

    ks, vs = [], []
    aux_sum = None
    for layer in _layers(params["blocks"], cfg.num_layers):
        if remat == "dots" and torch.is_grad_enabled():
            x, (k, v), aux = checkpoint(block_fn, x, layer, use_reentrant=False,
                                        context_fn=_save_dots_contexts)
        elif remat and torch.is_grad_enabled():
            x, (k, v), aux = checkpoint(block_fn, x, layer, use_reentrant=False)
        else:
            x, (k, v), aux = block_fn(x, layer)
        if aux is not None:
            aux_sum = aux if aux_sum is None else aux_sum + aux
        if return_kv:
            ks.append(k)
            vs.append(v)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    cache = KVCache(k=torch.stack(ks), v=torch.stack(vs)) if return_kv else None
    if return_aux:
        if aux_sum is None:
            aux_sum = torch.zeros((), dtype=torch.float32, device=dev)
        return x, cache, aux_sum
    return x, cache


def lm_head_weight(params: Params, cfg: LLMConfig):
    params = full_output_params(params, cfg)
    if "lm_head" in params:
        return params["lm_head"]
    return params["embed"].T


def lm_head_logits(params: Params, cfg: LLMConfig, hidden: torch.Tensor) -> torch.Tensor:
    """hidden [..., D] -> fp32 logits [..., V]; handles a QTensor lm_head.

    A plain lm_head is applied in fp32 on exact fp32 copies of the operands:
    the JAX package's einsum with an fp32 result type."""
    w = lm_head_weight(params, cfg)
    if isinstance(w, QTensor):
        return mm(hidden, w).float()
    return hidden.float() @ w.float()


def forward_logits(
    params: Params,
    cfg: LLMConfig,
    input_ids: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
    attention_mask: Optional[torch.Tensor] = None,
    **kw,
) -> torch.Tensor:
    """Full-vocab fp32 logits [B, S, V]. Prefer the fused logprob ops for
    training: this materializes the logits tensor."""
    hidden, _ = forward_hidden(params, cfg, input_ids, positions, attention_mask, **kw)
    return lm_head_logits(params, cfg, hidden)


# ---------------------------------------------------------------------------
# Decode path (KV cache)
# ---------------------------------------------------------------------------

def prefill(
    params: Params,
    cfg: LLMConfig,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    max_cache_len: int,
    *,
    attn_impl: str = "xla",
) -> Tuple[torch.Tensor, KVCache]:
    """Run the prompt through the model, returning the last-position hidden
    state [B, D] and a KV cache padded to ``max_cache_len``.

    Prompts are LEFT-padded so every sequence's last token sits at index
    S-1; cache slots [0, S) are the (masked) prompt, decode appends at S.
    """
    B, S = input_ids.shape
    if max_cache_len < S:
        raise ValueError(f"max_cache_len {max_cache_len} < prompt length {S}")
    hidden, kv = forward_hidden(
        params, cfg, input_ids, attention_mask=attention_mask,
        attn_impl=attn_impl, return_kv=True,
    )
    hidden, kv = gather_sequence(hidden, kv, attn_impl)
    pad = max_cache_len - S
    k = F.pad(kv.k, (0, 0, 0, 0, 0, pad))
    v = F.pad(kv.v, (0, 0, 0, 0, 0, pad))
    return hidden[:, -1, :], KVCache(k=k, v=v)


# ---------------------------------------------------------------------------
# Unpacked decode path: the [L, B, S_max, Kv, Hd] cache of the VLM and the
# VLA policies, attention by the plain ``decode_attention`` as in the JAX
# package (no kernel reads this layout). The steps write the new token's
# k/v into the cache IN PLACE and return the same buffers, where the JAX
# package returns new ones: a caller must not keep the old cache.
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: LLMConfig, batch: int, max_len: int, device="cuda") -> KVCache:
    """Zeros of [L, B, S_max, Kv, Hd] in the compute dtype (this rank's kv
    heads under a tensor axis)."""
    device = resolve_device(device)
    shape = (cfg.num_layers, batch, max_len, local_config(cfg, current_mesh()).num_kv_heads,
             cfg.head_dim_)
    return KVCache(k=torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
                   v=torch.zeros(shape, dtype=cfg.compute_dtype, device=device))


def _write_at(cache_index: int):
    """buf[:, i] = value for one slot ``cache_index`` of a [B, S, ...]
    buffer, with ``lax.dynamic_update_slice``'s index rule: a negative index
    counts from the end, then the index is clamped into [0, S - 1] (a write
    past the end lands on the last slot)."""
    i = int(cache_index)

    def write(buf: torch.Tensor, value: torch.Tensor) -> None:
        S = buf.shape[1]
        buf[:, min(max(i + S if i < 0 else i, 0), S - 1)] = value
    return write


def _write_rows(write_pos: torch.Tensor):
    """buf[b, write_pos[b]] = value[b] with ``x.at[rows, pos].set``'s rule:
    a negative position counts from the end, and a row whose position is
    still outside [0, S) is dropped (its slot keeps its old value)."""
    def write(buf: torch.Tensor, value: torch.Tensor) -> None:
        S = buf.shape[1]
        wp = write_pos.to(device=buf.device, dtype=torch.long)
        wp = torch.where(wp < 0, wp + S, wp)
        inside = (wp >= 0) & (wp < S)
        rows = torch.arange(buf.shape[0], device=buf.device)
        wp = wp.clamp(0, S - 1)
        keep = inside.view(-1, *([1] * (value.dim() - 1)))
        buf[rows, wp] = torch.where(keep, value.to(buf.dtype), buf[rows, wp])
    return write


def _decode_unpacked(params, cfg, token_ids, kv_layers, write, positions, kv_valid):
    """One decode step over per-layer (k, v) buffers [B, S_max, Kv, Hd];
    ``write(buf, value)`` puts this token's [B, Kv, Hd] into a buffer.
    Returns the [B, D] hidden state."""
    B = token_ids.shape[0]
    mesh, tp, fsdp = _groups()
    lc = local_config(cfg, mesh)
    cos, sin = rope_frequencies(cfg.head_dim_, cfg.max_seq_len, cfg.rope_theta,
                                token_ids.device)
    x = embed_tokens(params, cfg, token_ids)[:, None, :]
    pos = positions[:, None]
    for (kc, vc), layer in zip(kv_layers, _layers(params["blocks"], len(kv_layers))):
        layer = _gather_layer(layer, cfg, mesh, fsdp)
        h = rms_norm(x, layer["attn_norm"], cfg.rms_eps)
        q, k, v = _project_qkv(lc, layer, h, B, 1)
        q, k = apply_rope(q, k, cos, sin, pos)
        write(kc, k[:, 0])
        write(vc, v[:, 0])
        attn = decode_attention(q, kc, vc, kv_valid)
        x = x + C.all_reduce(mm(attn.reshape(B, 1, lc.q_dim), layer["wo"]), tp)
        x, _ = _mlp_or_moe(cfg, x, layer, tp)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return x[:, 0, :]


def decode_step(
    params: Params,
    cfg: LLMConfig,
    token_ids: torch.Tensor,   # [B] current input token
    cache: KVCache,
    cache_index: int,          # write slot (prompt_len + step); a scalar tensor is read
                               # to the host
    positions: torch.Tensor,   # [B] rope position of this token
    kv_valid: torch.Tensor,    # [B, S_max] bool, True incl. this token's slot
) -> Tuple[torch.Tensor, KVCache]:
    """One decode step for the whole batch, every row writing slot
    ``cache_index`` (clamped as ``lax.dynamic_update_slice`` clamps it).
    Returns ([B, D] hidden, cache): ``cache`` itself, written in place."""
    layers = layered_cache_from_stacked(cache)
    return _decode_unpacked(params, cfg, token_ids, layers, _write_at(cache_index),
                            positions, kv_valid), cache


def decode_step_ragged(
    params: Params,
    cfg: LLMConfig,
    token_ids: torch.Tensor,   # [B] current input token per slot
    cache: KVCache,
    write_pos: torch.Tensor,   # [B] PER-SLOT cache write index
    positions: torch.Tensor,   # [B] rope position of this token
    kv_valid: torch.Tensor,    # [B, S_max] bool incl. this token's slot
) -> Tuple[torch.Tensor, KVCache]:
    """Decode step where every row writes its k/v at its OWN cache index
    (continuous batching); a row whose index lies outside the cache writes
    nothing, as ``.at[rows, write_pos].set`` drops it. Returns ([B, D]
    hidden, cache): ``cache`` itself, written in place."""
    layers = layered_cache_from_stacked(cache)
    return _decode_unpacked(params, cfg, token_ids, layers, _write_rows(write_pos),
                            positions, kv_valid), cache


def layered_cache_from_stacked(cache: KVCache):
    """KVCache [L,B,S,K,D] -> tuple of (k_i, v_i) per layer: views of the
    stacked buffers, so a write into one is a write into the other."""
    return tuple(zip(cache.k.unbind(0), cache.v.unbind(0)))


def decode_step_layered(
    params: Params,
    cfg: LLMConfig,
    token_ids: torch.Tensor,   # [B]
    kv_layers,                 # tuple of (k [B,S,K,D], v [B,S,K,D])
    write_pos: torch.Tensor,   # [B] per-row cache write index
    positions: torch.Tensor,   # [B] rope position
    kv_valid: torch.Tensor,    # [B, S_max]
):
    """``decode_step_ragged`` on per-layer cache buffers. Returns ([B, D]
    hidden, kv_layers): the same buffers, written in place."""
    return _decode_unpacked(params, cfg, token_ids, kv_layers, _write_rows(write_pos),
                            positions, kv_valid), kv_layers


# ---------------------------------------------------------------------------
# Packed decode path
# ---------------------------------------------------------------------------
#
# Cache layout [B, S_max, Kv*Hd] per layer, read by the decode-attention
# kernels (ops/cuda/decode_attention.py). The decode steps write the new
# token's k/v into the layer buffers IN PLACE, where the JAX package
# returned new buffers from dynamic_update_slice / .at[].set (which XLA
# lowered to in-place updates of loop-carried buffers).

PackedKVLayers = Tuple[Tuple[torch.Tensor, torch.Tensor], ...]


def init_kv_cache_packed(cfg: LLMConfig, batch: int, max_len: int, device="cuda") -> PackedKVLayers:
    """Tuple of per-layer (k, v), each [B, S_max, Kv*Hd]."""
    device = resolve_device(device)
    shape = (batch, max_len, local_config(cfg, current_mesh()).kv_dim)
    dt = cfg.compute_dtype
    return tuple(
        (torch.zeros(shape, dtype=dt, device=device),
         torch.zeros(shape, dtype=dt, device=device))
        for _ in range(cfg.num_layers)
    )


def packed_cache_from_stacked(cache: KVCache) -> PackedKVLayers:
    """KVCache [L,B,S,K,D] -> per-layer packed (k, v) [B,S,K*D] (views)."""
    L, B, S = cache.k.shape[:3]
    kd = cache.k.shape[3] * cache.k.shape[4]
    return tuple(
        (cache.k[i].reshape(B, S, kd), cache.v[i].reshape(B, S, kd))
        for i in range(L)
    )


def default_decode_attn_impl(device) -> str:
    """The hand-written kernel on the card, the plain version elsewhere."""
    return "pallas" if torch.device(device).type == "cuda" else "xla"


def _packed_decode_attn(q, kc, vc, starts, lengths, num_kv, impl):
    if impl == "pallas":
        return decode_attention_packed(q, kc, vc, starts, lengths, num_kv=num_kv)
    return decode_attention_packed_xla(q, kc, vc, starts, lengths, num_kv=num_kv)


def _write_slot(buf: torch.Tensor, write_pos, rows, value: torch.Tensor) -> None:
    """buf[b, write_pos(b)] = value[b], in place; write_pos scalar or [B]."""
    if rows is None:
        buf[:, write_pos] = value
    else:
        buf[rows, write_pos] = value


def _decode_inputs(params, cfg, token_ids, write_pos):
    B = token_ids.shape[0]
    dev = token_ids.device
    cos, sin = rope_frequencies(cfg.head_dim_, cfg.max_seq_len, cfg.rope_theta, dev)
    x = embed_tokens(params, cfg, token_ids)[:, None, :]
    uniform_slot = not torch.is_tensor(write_pos) or write_pos.ndim == 0
    rows = None if uniform_slot else torch.arange(B, device=dev)
    if not uniform_slot:
        write_pos = write_pos.long()
    return x, cos, sin, rows, write_pos


def decode_step_packed(
    params: Params,
    cfg: LLMConfig,
    token_ids: torch.Tensor,    # [B] current input token per row
    kv_layers: PackedKVLayers,
    write_pos,                  # int or [B]: cache slot for this token's kv
    positions: torch.Tensor,    # [B] rope position of this token
    starts: torch.Tensor,       # [B] int32 first valid cache slot
    lengths: torch.Tensor,      # [B] int32 end of valid interval INCLUDING this slot
    *,
    attn_impl: Optional[str] = None,
) -> Tuple[torch.Tensor, PackedKVLayers]:
    """One decode step on the packed cache. Returns ([B, D] hidden, cache);
    the cache buffers are updated in place and returned.

    ``write_pos`` is one slot for every row (static engine) or a [B] vector
    (continuous batching: per-row slots).
    """
    B = token_ids.shape[0]
    impl = attn_impl or default_decode_attn_impl(token_ids.device)
    mesh, tp, fsdp = _groups()
    lc = local_config(cfg, mesh)
    kd = lc.kv_dim
    x, cos, sin, rows, write_pos = _decode_inputs(params, cfg, token_ids, write_pos)
    pos = positions[:, None]
    for (kc, vc), layer in zip(kv_layers, _layers(params["blocks"], len(kv_layers))):
        layer = _gather_layer(layer, cfg, mesh, fsdp)
        h = rms_norm(x, layer["attn_norm"], cfg.rms_eps)
        q, k, v = _project_qkv(lc, layer, h, B, 1)
        q, k = apply_rope(q, k, cos, sin, pos)
        _write_slot(kc, write_pos, rows, k.reshape(B, kd))
        _write_slot(vc, write_pos, rows, v.reshape(B, kd))
        attn = _packed_decode_attn(
            q.reshape(B, lc.num_heads, lc.head_dim_), kc, vc,
            starts, lengths, lc.num_kv_heads, impl,
        )
        x = x + C.all_reduce(mm(attn.reshape(B, 1, lc.q_dim), layer["wo"]), tp)
        x, _ = _mlp_or_moe(cfg, x, layer, tp)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return x[:, 0, :], kv_layers


# ---------------------------------------------------------------------------
# int8 KV cache decode (scales fold into the attention's score/prob rows)
# ---------------------------------------------------------------------------

PackedKVQ8Layers = Tuple[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], ...]


def init_kv_cache_packed_q8(cfg: LLMConfig, batch: int, max_len: int, device="cuda") -> PackedKVQ8Layers:
    """Per-layer (k int8 [B,S,KD], v int8, k_scale f32 [B,S], v_scale)."""
    device = resolve_device(device)
    shape = (batch, max_len, local_config(cfg, current_mesh()).kv_dim)
    return tuple(
        (torch.zeros(shape, dtype=torch.int8, device=device),
         torch.zeros(shape, dtype=torch.int8, device=device),
         torch.ones((batch, max_len), dtype=torch.float32, device=device),
         torch.ones((batch, max_len), dtype=torch.float32, device=device))
        for _ in range(cfg.num_layers)
    )


def quantize_packed_kv(k: torch.Tensor):
    """[..., KD] -> (int8, f32 scale [...]) per token (max-abs / 127)."""
    return quantize_kv_token(k)


def decode_step_packed_q8(
    params: Params,
    cfg: LLMConfig,
    token_ids: torch.Tensor,
    kv_layers: PackedKVQ8Layers,
    write_pos,
    positions: torch.Tensor,
    starts: torch.Tensor,
    lengths: torch.Tensor,
    *,
    attn_impl: Optional[str] = None,
) -> Tuple[torch.Tensor, PackedKVQ8Layers]:
    """decode_step_packed on an int8 KV cache: the new k/v are quantized on
    write (per-token max-abs scale) into the buffers in place, and attention
    folds the scales into score/prob rows (no wide dequantization)."""
    B = token_ids.shape[0]
    impl = attn_impl or default_decode_attn_impl(token_ids.device)
    mesh, tp, fsdp = _groups()
    lc = local_config(cfg, mesh)
    kd = lc.kv_dim
    x, cos, sin, rows, write_pos = _decode_inputs(params, cfg, token_ids, write_pos)
    pos = positions[:, None]
    for (kc, vc, ksc, vsc), layer in zip(kv_layers, _layers(params["blocks"], len(kv_layers))):
        layer = _gather_layer(layer, cfg, mesh, fsdp)
        h = rms_norm(x, layer["attn_norm"], cfg.rms_eps)
        q, k, v = _project_qkv(lc, layer, h, B, 1)
        q, k = apply_rope(q, k, cos, sin, pos)
        kq, ks = quantize_packed_kv(k.reshape(B, kd))
        vq, vs = quantize_packed_kv(v.reshape(B, kd))
        _write_slot(kc, write_pos, rows, kq)
        _write_slot(vc, write_pos, rows, vq)
        _write_slot(ksc, write_pos, rows, ks)
        _write_slot(vsc, write_pos, rows, vs)
        qh = q.reshape(B, lc.num_heads, lc.head_dim_)
        if impl == "pallas":
            attn = decode_attention_packed_q8(
                qh, kc, vc, ksc, vsc, starts, lengths, num_kv=lc.num_kv_heads)
        else:
            attn = decode_attention_packed_q8_xla(
                qh, kc, vc, ksc, vsc, starts, lengths, num_kv=lc.num_kv_heads)
        x = x + C.all_reduce(mm(attn.reshape(B, 1, lc.q_dim), layer["wo"]), tp)
        x, _ = _mlp_or_moe(cfg, x, layer, tp)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return x[:, 0, :], kv_layers
