"""Which model geometries the attention kernels take, in one place.

Every hand-written attention kernel serves head dims 64 and 128 and at most
a number of query heads per kv head (G); the paged kernel also bounds the
page size. Each wrapper checks its tensors against these limits at every
launch. ``check_kernel_geometry`` checks a model config against the kernels
of a path when an engine, ``generate`` or a train step is built on the card,
so that a model that no kernel of the path takes is refused before any
prompt or batch is touched. On the CPU the plain versions run any geometry,
and nothing is checked.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

import torch

if TYPE_CHECKING:
    from rlinf_tpu_torch.models.llm.config import LLMConfig

HEAD_DIMS = (64, 128)

#: kernel -> (head dims it takes, most query heads per kv head; None: any)
LIMITS = {
    "flash_attention": (HEAD_DIMS, None),   # K1, K7, K8
    "decode_attention_bf16": (HEAD_DIMS, 16),  # K2
    "decode_attention_q8": (HEAD_DIMS, 8),  # K3
    "decode_megakernel": (HEAD_DIMS, 8),    # K9
    "paged_attention": (HEAD_DIMS, 16),     # K10
}

#: path -> the attention kernels it runs
PATHS = {
    "flash": ("flash_attention",),          # attn_impl="pallas": prefill, recompute, train step
    "decode": ("decode_attention_bf16", "decode_attention_q8"),  # the per-layer decode step
    "mega": ("decode_megakernel",),         # generate(mega=), use_mega
    "paged": ("paged_attention",),          # the paged engine's decode
}

#: K10: a page holds a multiple of 8 tokens and at most this many elements
#: (page size x head dim) of one kv head
PAGE_MULTIPLE = 8
MAX_PAGE_ELEMS = 4096


def check_heads(kernel: str, H: int, Kv: int, Hd: int) -> None:
    """Raise unless ``kernel`` takes H query heads over Kv kv heads of dim Hd."""
    dims, max_g = LIMITS[kernel]
    if Kv <= 0 or H % Kv or Hd not in dims or (max_g is not None and H // Kv > max_g):
        g_text = "any number of" if max_g is None else f"at most {max_g}"
        raise ValueError(
            f"{kernel}: unsupported H={H} Kv={Kv} Hd={Hd}; the kernel takes head dims "
            f"{dims} and {g_text} query heads per kv head")


def check_page_size(page_size: int, Hd: int) -> None:
    """Raise unless K10 takes pages of ``page_size`` tokens at head dim Hd."""
    if page_size % PAGE_MULTIPLE or page_size * Hd > MAX_PAGE_ELEMS:
        raise ValueError(
            f"paged_attention: unsupported page size {page_size} at Hd={Hd}; the kernel takes "
            f"multiples of {PAGE_MULTIPLE} with page size x head dim <= {MAX_PAGE_ELEMS}")


def check_kernel_geometry(cfg: "LLMConfig", path: str, *, page_size: Optional[int] = None) -> None:
    """Return if every kernel of ``path`` (a key of PATHS) takes the model
    ``cfg``, else raise ValueError naming the kernel and its limits. The
    megakernel's path also checks its weight tiles' widths; the paged path
    the page size, where one is given."""
    if path not in PATHS:
        raise ValueError(f"unknown kernel path {path!r}; expected one of {sorted(PATHS)}")
    for kernel in PATHS[path]:
        check_heads(kernel, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_)
    if path == "mega":
        from rlinf_tpu_torch.ops.cuda.decode_megakernel import _check_geometry, make_plan

        _check_geometry(make_plan(cfg, max(2048, cfg.hidden_size)))
    if path == "paged" and page_size is not None:
        check_page_size(page_size, cfg.head_dim_)


def check_on_card(cfg: "LLMConfig", device, *, attn_impl: Optional[str] = None,
                  decode_attn_impl: Optional[str] = None) -> None:
    """Where ``device`` is the card: ``check_kernel_geometry`` for the
    prefill/training attention when ``attn_impl`` selects the kernels
    ("pallas" or "flash": K1, K7, K8) and for the per-layer decode when
    ``decode_attn_impl`` does ("pallas": K2 and K3, whichever cache the
    path holds)."""
    if torch.device(device).type != "cuda":
        return
    if attn_impl in ("pallas", "flash"):
        check_kernel_geometry(cfg, "flash")
    if decode_attn_impl == "pallas":
        check_kernel_geometry(cfg, "decode")
