"""Plain PyTorch ops and, under ``cuda/``, the hand-written kernels.

The exports are the JAX package's (``rlinf_tpu/ops/__init__.py``).
"""

from rlinf_tpu_torch.ops.rope import apply_rope, rope_frequencies
from rlinf_tpu_torch.ops.norm import rms_norm
from rlinf_tpu_torch.ops.attention import causal_attention, decode_attention
from rlinf_tpu_torch.ops.logprobs import (
    logprobs_and_entropy_from_logits,
    token_logprobs_from_logits,
    vocab_parallel_logprobs_and_entropy,
)

__all__ = [
    "apply_rope",
    "rope_frequencies",
    "rms_norm",
    "causal_attention",
    "decode_attention",
    "logprobs_and_entropy_from_logits",
    "token_logprobs_from_logits",
    "vocab_parallel_logprobs_and_entropy",
]
