"""Kernel K10: paged decode attention, and its plain version.

Port of ``rlinf_tpu/ops/pallas/paged_attention.py``. The KV cache is a
global pool of pages ``[num_pages, Kv, P, Hd]``; row ``b`` owns the pages
``page_table[b]`` and attends over the first ``lengths[b]`` token positions
of that chain. A row with ``lengths[b] == 0`` (an unoccupied slot) gives 0
in the kernel and in the plain version alike. The CUDA source is
``csrc/paged_attention.cu``: split-KV, each split a run of whole pages
(``split_plan``), then a merge of the splits, both in one call.
"""

from __future__ import annotations

from typing import Optional

import torch

from rlinf_tpu_torch.ops.cuda._build import (
    F, I, P, CudaKernel, check_cuda_tensor, sm_count, stream_handle,
)
from rlinf_tpu_torch.ops.cuda.decode_attention import _plain, split_plan
from rlinf_tpu_torch.ops.cuda.geometry import check_heads, check_page_size

KERNEL = CudaKernel(
    "paged_attention.cu", "paged_attention_bf16",
    [I, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, F, P],
)


def paged_attention_xla(
    q: torch.Tensor,           # [B, H, Hd]
    k_pages: torch.Tensor,     # [num_pages, Kv, P, Hd]
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [B, max_pages] int (unused entries 0)
    lengths: torch.Tensor,     # [B] int valid tokens per row (incl. current)
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version of K10: gather each row's pages into a dense
    [B, max_pages*P, Kv*Hd] view and run masked decode attention in fp32."""
    B = q.shape[0]
    _, Kv, Pg, Hd = k_pages.shape
    max_pages = page_table.shape[1]
    table = page_table.long()

    def dense(pages):
        g = pages[table]                                   # [B, max_pages, Kv, P, Hd]
        return g.permute(0, 1, 3, 2, 4).reshape(B, max_pages * Pg, Kv * Hd)

    starts = torch.zeros_like(lengths)
    return _plain(q, dense(k_pages), dense(v_pages), None, None, starts, lengths, Kv, scale)


def paged_attention(
    q: torch.Tensor,           # [B, H, Hd] bf16, one decode token per row
    k_pages: torch.Tensor,     # [num_pages, Kv, P, Hd] bf16 global page pool
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [B, max_pages] int32 (pad unused with 0)
    lengths: torch.Tensor,     # [B] int32
    scale: Optional[float] = None,
) -> torch.Tensor:
    """K10 -> [B, H, Hd] in q.dtype: the split kernel and the merge, one
    launch in the count. CPU tensors run the plain version."""
    if q.device.type == "cpu":
        return paged_attention_xla(q, k_pages, v_pages, page_table, lengths, scale=scale)
    B, H, Hd = q.shape
    num_pages, Kv, Pg, _ = k_pages.shape
    max_pages = page_table.shape[1]
    check_heads("paged_attention", H, Kv, Hd)
    check_page_size(Pg, Hd)
    check_cuda_tensor("q", q, torch.bfloat16, (B, H, Hd))
    check_cuda_tensor("k_pages", k_pages, torch.bfloat16, (num_pages, Kv, Pg, Hd))
    check_cuda_tensor("v_pages", v_pages, torch.bfloat16, (num_pages, Kv, Pg, Hd))
    check_cuda_tensor("page_table", page_table, torch.int32, (B, max_pages))
    check_cuda_tensor("lengths", lengths, torch.int32, (B,))
    pps, splits = split_plan(B * Kv, max_pages, sm_count(q.device.index))
    part_ml = torch.empty((B * Kv, splits, H // Kv, 2), dtype=torch.float32, device=q.device)
    part_o = torch.empty((B * Kv, splits, H // Kv, Hd), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    KERNEL(
        q.device.index, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), part_ml.data_ptr(), part_o.data_ptr(),
        out.data_ptr(), B, H, Kv, Pg, max_pages, Hd, pps, splits,
        float(Hd**-0.5 if scale is None else scale), stream_handle(),
    )
    return out
