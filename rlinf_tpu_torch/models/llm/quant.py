"""Weight-only int8 quantization for rollout decode.

Port of ``rlinf_tpu/models/llm/quant.py``. Per-output-channel symmetric
int8 weights with an fp32 scale; decode reads them through ``mm``.

Cost on the card: ``mm`` upcasts the int8 weight to the activation dtype
with ``q.to(x.dtype)`` before ``torch.matmul``. XLA folded that convert into
the matmul's operand load; eager PyTorch materialises a bf16 copy of every
weight on every call (PERF.md has the measured cost per decode step).

RL-correctness: quantized rollout is a slightly-off-policy behaviour policy;
rollout logprobs enter the loss only through the importance ratio, and the
recompute for training runs on the bf16 weights.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class QTensor(NamedTuple):
    """Per-output-channel symmetric int8 weight + fp32 scale.

    q: int8 [..., D_in, D_out]; scale: fp32 [..., 1, D_out].
    """

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.q.shape

    @property
    def ndim(self):
        return self.q.ndim


def quantize_tensor(w: torch.Tensor) -> QTensor:
    """Symmetric per-output-channel (last axis) int8 quantization.

    Both outputs are contiguous, also for a transposed view such as
    ``embed.T``: the sampler kernel reads ``q`` as a dense [D, V] array."""
    wf = w.float().contiguous()
    s = (wf.abs().amax(dim=-2, keepdim=True) / 127.0).clamp_min(1e-12)
    q = torch.round(wf / s).clamp(-127, 127).to(torch.int8)
    return QTensor(q=q, scale=s)


def dequantize(w: QTensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (w.q.float() * w.scale).to(dtype)


def mm(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for plain tensors or QTensor.

    The scale is per OUTPUT channel, so x @ (q * scale) == (x @ q) * scale;
    the order ``(x @ q.to(x.dtype)) * scale.to(x.dtype)`` is the JAX
    package's, so the int8 path rounds as it does."""
    if isinstance(w, QTensor):
        return (x @ w.q.to(x.dtype)) * w.scale.to(x.dtype)
    return x @ w


# Matmul weights of the LLM param tree (norms, biases and the embedding
# gather stay in the compute dtype).
_MATMUL_KEYS = ("wq", "wk", "wv", "wo", "gate", "up", "down", "lm_head")


def quantize_params(params: dict, *, fuse: bool = True) -> dict:
    """LLM params -> same tree with matmul weights as int8 QTensor leaves.

    For tied-embedding models a quantized ``lm_head`` is made from
    ``embed.T``, so decode never streams the bf16 embedding for the output
    projection. ``fuse`` (default) emits ``wqkv`` = concat(wq, wk, wv) and
    ``wgu`` = concat(gate, up) along the output axis in place of the parts;
    per-output-channel scales make the fusion exact.
    """
    out = dict(params)
    blocks = dict(params["blocks"])
    if fuse and all(k in blocks for k in ("wq", "wk", "wv")):
        blocks["wqkv"] = quantize_tensor(torch.cat(
            [blocks.pop("wq"), blocks.pop("wk"), blocks.pop("wv")], dim=-1))
    if fuse and "gate" in blocks and "up" in blocks:
        blocks["wgu"] = quantize_tensor(torch.cat(
            [blocks.pop("gate"), blocks.pop("up")], dim=-1))
    for k in list(blocks.keys()):
        if k in _MATMUL_KEYS:
            blocks[k] = quantize_tensor(blocks[k])
    out["blocks"] = blocks
    if "lm_head" in params:
        out["lm_head"] = quantize_tensor(params["lm_head"])
    else:
        out["lm_head"] = quantize_tensor(params["embed"].T)
    return out
