"""Waiting for the device before a host clock is read.

The port's analog of ``rlinf_tpu/utils/sync.py``. PyTorch returns from a
CUDA call when the work is queued, not done, so a host clock read after it
measures dispatch. ``synchronize(tree)`` waits for every CUDA device that
holds a tensor of ``tree``; ``host_sync(tree)`` also reads one scalar back,
as the JAX package's does.
"""

from __future__ import annotations

from typing import Iterator

import torch


def tensor_leaves(tree) -> Iterator[torch.Tensor]:
    """The tensors of a tree of dicts, lists and tuples (NamedTuples too)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensor_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensor_leaves(v)


def synchronize(tree) -> None:
    """Wait until the work queued on each CUDA device of ``tree``'s tensors
    is done (every stream of the device)."""
    for dev in {t.device for t in tensor_leaves(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


def host_sync(tree) -> None:
    """Wait for every computation ``tree`` depends on, and round-trip one
    scalar to the host."""
    leaves = list(tensor_leaves(tree))
    if not leaves:
        return
    synchronize(leaves)
    leaf = leaves[0]
    (leaf.reshape(-1)[0] if leaf.numel() else leaf.sum()).item()
