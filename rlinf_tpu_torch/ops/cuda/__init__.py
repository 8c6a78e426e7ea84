"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their plain versions.

Each module here holds one or two kernels of ``rlinf_tpu_torch/csrc`` and,
beside each, a plain PyTorch version of the same function. A wrapper runs
the plain version for tensors on the CPU, and only there: for a CUDA tensor
it launches its kernel or raises. There is no fallback.

Implementation names are the JAX package's, so one config drives both
packages: ``"pallas"`` (and ``"flash"`` for prefill attention) selects the
port's hand-written kernel; ``"xla"`` selects its plain PyTorch version.

==========================  ===============================  ==============
Kernel                      Replaces (rlinf_tpu/ops/pallas)  Module
==========================  ===============================  ==============
K1 flash attention fwd      flash_attention.py _fwd_kernel   flash_attention
K2 decode attention bf16    decode_attention.py _kernel      decode_attention
K3 decode attention int8    decode_attention.py _kernel_q8   decode_attention
K4 fused lm-head sampler    sampler_kernel.py _sample_kernel sampler_kernel
K5 linear CE forward        linear_ce.py _ce_fwd_kernel      linear_ce
K6 linear CE backward       linear_ce.py _ce_bwd_kernel      linear_ce
K7 flash attention bwd dq   flash_attention.py _bwd_dq_...   flash_attention
K8 flash attention bwd dkv  flash_attention.py _bwd_dkv_...  flash_attention
K9 whole-step decode        decode_megakernel.py _mega_...   decode_megakernel
K10 paged decode attention  paged_attention.py _kernel       paged_attention
==========================  ===============================  ==============
"""

from rlinf_tpu_torch.ops.cuda._build import SOURCES, build  # noqa: F401


def kernels():
    """{name: CudaKernel} of every kernel of the port; each has ``launches``."""
    from rlinf_tpu_torch.ops.cuda import (
        decode_attention, decode_megakernel, flash_attention, linear_ce,
        paged_attention, sampler_kernel,
    )

    return {
        "flash_attention_fwd": flash_attention.KERNEL,
        "decode_attention_bf16": decode_attention.KERNEL_BF16,
        "decode_attention_q8": decode_attention.KERNEL_Q8,
        "fused_lmhead_sample": sampler_kernel.KERNEL,
        "linear_ce_fwd": linear_ce.KERNEL_FWD,
        "linear_ce_bwd": linear_ce.KERNEL_BWD,
        "flash_attention_bwd_dq": flash_attention.KERNEL_DQ,
        "flash_attention_bwd_dkv": flash_attention.KERNEL_DKV,
        "decode_megakernel": decode_megakernel.KERNEL,
        "paged_attention": paged_attention.KERNEL,
    }
