"""Host-side page allocator + device-side paged KV cache ops.

Port of ``rlinf_tpu/rollout/paged_cache.py``, the management half of the
paged-KV design (kernel K10 in ``ops/cuda/paged_attention.py``): slots own
chains of fixed-size pages from a global pool; continuous batching allocates
on prefill, extends during decode, and frees the whole chain when a request
ends. All of it is O(pages) host work on numpy arrays, no device copies.

Page 0 is reserved as the NULL page: unused page-table entries point at it.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


class PagePool:
    """Allocator over ``num_pages`` pages of ``page_size`` tokens for up to
    ``num_slots`` concurrent sequences."""

    def __init__(self, num_pages: int, page_size: int, num_slots: int,
                 max_pages_per_slot: int):
        assert num_pages > 1, "page 0 is reserved"
        self.num_pages = num_pages
        self.page_size = page_size
        self.num_slots = num_slots
        self.max_pages_per_slot = max_pages_per_slot
        self._free: List[int] = list(range(num_pages - 1, 0, -1))  # stack
        self.page_table = np.zeros((num_slots, max_pages_per_slot), np.int32)
        self.lengths = np.zeros((num_slots,), np.int32)
        self._num_pages_used = np.zeros((num_slots,), np.int32)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_needed(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    def can_alloc(self, tokens: int) -> bool:
        return self.pages_needed(tokens) <= len(self._free)

    def alloc_slot(self, slot: int, tokens: int) -> None:
        """Claim pages for a fresh sequence of ``tokens`` (the prompt)."""
        assert self.lengths[slot] == 0, f"slot {slot} busy"
        n = self.pages_needed(tokens)
        assert n <= self.max_pages_per_slot, "sequence exceeds slot capacity"
        if n > len(self._free):
            raise MemoryError(
                f"page pool exhausted: need {n}, free {len(self._free)}")
        for i in range(n):
            self.page_table[slot, i] = self._free.pop()
        self.lengths[slot] = tokens
        self._num_pages_used[slot] = n

    def append_token(self, slot: int) -> Tuple[int, int]:
        """Extend slot by one token; returns (page_id, offset) of the new
        token's cache position. Allocates a page on boundary crossing."""
        pos = int(self.lengths[slot])
        page_idx, offset = divmod(pos, self.page_size)
        if page_idx >= self._num_pages_used[slot]:
            assert page_idx < self.max_pages_per_slot, "slot capacity"
            if not self._free:
                raise MemoryError("page pool exhausted on decode append")
            self.page_table[slot, page_idx] = self._free.pop()
            self._num_pages_used[slot] += 1
        self.lengths[slot] = pos + 1
        return int(self.page_table[slot, page_idx]), offset

    def append_tokens_chunk(self, active: np.ndarray, k_steps: int):
        """Chunk-ahead allocation: reserve ``k_steps`` token positions for
        every slot where ``active``. Returns (write_pages, write_offsets),
        each [K, num_slots] int32 (inactive columns 0). Equivalent to
        K x num_slots ``append_token`` calls."""
        K = k_steps
        P = self.page_size
        n = self.num_slots
        write_pages = np.zeros((K, n), np.int32)
        write_offsets = np.zeros((K, n), np.int32)
        act = np.nonzero(active)[0]
        if len(act) == 0:
            return write_pages, write_offsets
        base = self.lengths[act].astype(np.int64)               # [A]
        pos = base[None, :] + np.arange(K)[:, None]             # [K, A]
        page_idx = (pos // P).astype(np.int32)
        offs = (pos % P).astype(np.int32)
        need_pages = ((base + K + P - 1) // P).astype(np.int32)
        have = self._num_pages_used[act]
        # allocate the shortfall per slot from the free stack
        for j, s in enumerate(act):
            for i in range(int(have[j]), int(need_pages[j])):
                assert i < self.max_pages_per_slot, "slot capacity"
                if not self._free:
                    raise MemoryError("page pool exhausted on decode append")
                self.page_table[s, i] = self._free.pop()
            self._num_pages_used[s] = max(int(have[j]), int(need_pages[j]))
        # gather page ids for every (k, slot) in one indexing op
        write_pages[:, act] = np.take_along_axis(
            self.page_table[act], page_idx.T, axis=1).T
        write_offsets[:, act] = offs
        self.lengths[act] = (base + K).astype(np.int32)
        return write_pages, write_offsets

    def free_slot(self, slot: int) -> None:
        n = int(self._num_pages_used[slot])
        for i in range(n):
            self._free.append(int(self.page_table[slot, i]))
            self.page_table[slot, i] = 0
        self.lengths[slot] = 0
        self._num_pages_used[slot] = 0

    def arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """(page_table [S, max_pages] int32, lengths [S] int32) snapshots."""
        return self.page_table.copy(), self.lengths.copy()


def init_page_pool_cache(
    num_layers: int, num_pages: int, page_size: int, num_kv_heads: int,
    head_dim: int, dtype=torch.bfloat16, device="cpu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device page pools: (k_pages, v_pages) [L, num_pages, Kv, P, Hd]."""
    shape = (num_layers, num_pages, num_kv_heads, page_size, head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def paged_cache_write(
    k_pages_l: torch.Tensor,   # [num_pages, Kv, P, Hd] one layer's pool
    v_pages_l: torch.Tensor,
    k_new: torch.Tensor,       # [B, Kv, Hd] this step's k per slot
    v_new: torch.Tensor,
    page_ids: torch.Tensor,    # [B] physical page of each slot's write position
    offsets: torch.Tensor,     # [B] offset within the page
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter one decode step's k/v into the pool, IN PLACE (the JAX
    package returned new arrays from ``.at[].set``, which XLA updated in
    place under donation); the pools are returned for the same call shape.
    Rows that share a (page, offset), as unoccupied slots share (0, 0),
    leave one of their values there."""
    page_ids, offsets = page_ids.long(), offsets.long()
    k_pages_l[page_ids, :, offsets, :] = k_new.to(k_pages_l.dtype)
    v_pages_l[page_ids, :, offsets, :] = v_new.to(v_pages_l.dtype)
    return k_pages_l, v_pages_l
