"""Dynamic token-budget microbatching with shape bucketing.

The port's own copy of ``rlinf_tpu/data/dynamic_batching.py``: rows are
partitioned best-fit-decreasing under ``max_tokens``, each microbatch
trimmed to its bucketed longest row and padded to a power-of-two row
count. The JAX package partitions in host C++ where it builds; the port
keeps only the Python version, which gives the same bins. Loss normalization by the GLOBAL valid token
count keeps the gradients of the packing equal to one big batch's.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def best_fit_decreasing(
    lengths: Sequence[int], max_tokens: int
) -> List[List[int]]:
    """Partition row indices into bins with sum(length) <= max_tokens each.

    Rows longer than max_tokens get singleton bins (they must still run).
    """
    # stable sort so tie order is deterministic
    order = np.argsort(lengths, kind="stable")[::-1]
    bins: List[Tuple[int, List[int]]] = []  # (used_tokens, indices)
    for i in order:
        L = int(lengths[i])
        best, best_left = None, None
        for b, (used, idx) in enumerate(bins):
            left = max_tokens - used - L
            if left >= 0 and (best_left is None or left < best_left):
                best, best_left = b, left
        if best is None:
            bins.append((L, [int(i)]))
        else:
            used, idx = bins[best]
            idx.append(int(i))
            bins[best] = (used + L, idx)
    return [idx for _, idx in bins]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _row_bucket(n: int) -> int:
    """Next power of two: bounds the distinct microbatch shapes to log2."""
    return 1 << int(np.ceil(np.log2(max(n, 1))))


def pack_microbatches(
    batch: Dict[str, np.ndarray],
    lengths: Sequence[int],
    max_tokens: int,
    *,
    seq_bucket: int = 128,
    length_key: str = "attention_mask",
) -> List[Dict[str, np.ndarray]]:
    """Split a [B, T] batch dict into token-budget microbatches.

    Each microbatch is trimmed to its own bucketed max length and padded to a
    power-of-two row count (padding rows have empty masks, contributing zero
    loss/grad under global-count normalization).
    """
    B, T = batch[length_key].shape
    bins = best_fit_decreasing(lengths, max_tokens)
    out = []
    for idx in bins:
        idx_arr = np.asarray(sorted(idx))
        rows = len(idx_arr)
        rows_b = _row_bucket(rows)
        max_len = int(max(lengths[i] for i in idx))
        T_b = min(_round_up(max_len, seq_bucket), T)
        mb = {}
        for k, v in batch.items():
            sliced = v[idx_arr][:, :T_b] if v.ndim >= 2 else v[idx_arr]
            if rows_b > rows:
                pad_shape = (rows_b - rows, *sliced.shape[1:])
                sliced = np.concatenate(
                    [sliced, np.zeros(pad_shape, sliced.dtype)], axis=0
                )
            mb[k] = sliced
        out.append(mb)
    return out
