"""Config dataclasses of the port.

So far only ``RolloutConfig``, a copy of ``rlinf_tpu/config.py``
RolloutConfig with the same fields, so that one YAML group drives both
packages. The full ``TrainerConfig`` tree comes with the trainer slice; the
rollout entry points (``rollout.build_rollout_engine``) take any object with
``.model``, ``.sampling``, ``.rollout``, ``.attn_impl``,
``.data.max_prompt_len`` and ``.algorithm.recompute_logprobs``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RolloutConfig:
    """Rollout/serving engine selection.

    engine:
      auto        static under a mesh, continuous otherwise
      static      one generate() per (P, N) bucket
      continuous  slot-pool continuous batching (not ported yet)
      paged       continuous + paged KV pool (not ported yet)
    weight_quant: "auto" = int8 weight-only decode on a CUDA device, none
    on the CPU.
    """

    engine: str = "auto"             # auto | static | continuous | paged
    weight_quant: str = "auto"       # auto | none | int8
    kv_quant: str = "none"           # none | int8 (continuous engine only)
    num_slots: int = 32              # continuous/paged slot-pool size
    decode_chunk: int = 16           # decode steps per host round
    prompt_bucket: int = 64
    page_size: int = 16              # paged engine only
    decode_attn_impl: Optional[str] = None   # None = pallas on CUDA, xla off
