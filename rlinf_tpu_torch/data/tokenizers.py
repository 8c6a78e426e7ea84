"""Tokenizer protocol and the byte tokenizer.

The port's own copy of ``rlinf_tpu/data/tokenizers.py``: any object with
``encode(str) -> List[int]`` and ``decode(List[int]) -> str`` works.
``ByteTokenizer`` is the dependency-free tokenizer of tests and toy tasks.
The Hugging Face and BPE tokenizers are not ported yet.
"""

from __future__ import annotations

from typing import List, Protocol


class Tokenizer(Protocol):
    def encode(self, text: str) -> List[int]: ...
    def decode(self, ids: List[int]) -> str: ...


class ByteTokenizer:
    """UTF-8 bytes + 2 specials. vocab: 0=pad, 1=eos, bytes shifted by 2."""

    vocab_size = 258
    pad_id = 0
    eos_id = 1

    def encode(self, text: str) -> List[int]:
        return [b + 2 for b in text.encode("utf-8")]

    def decode(self, ids: List[int]) -> str:
        return bytes(
            i - 2 for i in ids if 2 <= i < 258  # ids past the byte range
        ).decode("utf-8", errors="replace")  # (vocab padding) are skipped
