"""Device choice for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raise if it names CUDA and none exists.

    The entry points run on the card unless the caller asks for the CPU,
    where the kernels' plain PyTorch versions run instead.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available: rlinf_tpu_torch entry points run on "
            "the GPU by default; pass device='cpu' to run the plain PyTorch "
            "versions of the kernels on the CPU")
    return dev
