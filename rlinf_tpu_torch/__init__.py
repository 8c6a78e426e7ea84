"""PyTorch/CUDA port of ``rlinf_tpu`` for one NVIDIA Hopper card (H100).

The package keeps the JAX package's layout and names, so that each module's
counterpart is found at the same path under ``rlinf_tpu/``. Plain tensor code
is PyTorch; every Pallas TPU kernel on a ported path is a CUDA C++ kernel
under ``csrc/``, built with ``nvcc`` for ``sm_90a`` at first use
(``ops/cuda/_build.py``). The port imports neither ``jax`` nor ``rlinf_tpu``.

Ported so far: the static rollout serving path (prefill, packed bf16 and int8
KV-cache decode, fused lm-head sampling) — see ``rollout.RolloutEngine`` — and
one GRPO training step (advantages, PPO actor losses, the logprob recompute
and the update with its optimizer) — see ``training.learner``.
"""

__version__ = "0.1.0"
