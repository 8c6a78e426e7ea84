"""Tokenizer protocol and adapters.

The port's own copy of ``rlinf_tpu/data/tokenizers.py``: any object with
``encode(str) -> List[int]`` and ``decode(List[int]) -> str`` works.
``ByteTokenizer`` is the dependency-free tokenizer of tests and toy tasks;
``BPETokenizer`` is byte-level BPE trained in-process, with the JAX
package's file format; ``HFTokenizer`` reads a Hugging Face tokenizer
directory itself (``data/hf_tokenizer.py``), without transformers.
"""

from __future__ import annotations

from typing import List, Optional, Protocol

from rlinf_tpu_torch.data.hf_tokenizer import HFTokenizer


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


class BPETokenizer:
    """Byte-level BPE trained in-process.

    vocab layout: 0=pad, 1=eos, 2..257=bytes, 258.. = merged pairs (by
    rank). ``train`` runs classic BPE on a corpus sample; ``encode`` applies
    merges in rank order (exact BPE segmentation). ``save``/``load`` use the
    JAX package's JSON file (``{"merges": [[a, b], ...]}``), so a file saved
    by one package loads in the other.
    """

    pad_id = 0
    eos_id = 1
    _BYTE0 = 2

    def __init__(self, merges: Optional[List[tuple]] = None):
        self.merges: List[tuple] = list(merges or [])
        self._rebuild()

    def _rebuild(self):
        self.vocab_size = 258 + len(self.merges)
        self._rank = {pair: 258 + i for i, pair in enumerate(self.merges)}
        self._bytes = {i: bytes([i - self._BYTE0]) for i in range(2, 258)}
        for i, (a, b) in enumerate(self.merges):
            self._bytes[258 + i] = self._bytes[a] + self._bytes[b]

    @classmethod
    def train(cls, texts: List[str], num_merges: int = 512,
              sample_chars: int = 200_000,
              merge_digits: bool = False) -> "BPETokenizer":
        """Greedy most-frequent-pair merges over a corpus sample.

        ``merge_digits=False`` (default) never merges tokens containing
        digit bytes, so numbers stay digit-atomic.
        """
        from collections import Counter

        corpus: List[List[int]] = []
        total = 0
        for t in texts:
            ids = [b + cls._BYTE0 for b in t.encode("utf-8")]
            corpus.append(ids)
            total += len(ids)
            if total >= sample_chars:
                break
        tok = cls()
        digit_bytes = set(range(ord("0") + cls._BYTE0, ord("9") + 1 + cls._BYTE0))

        for _ in range(num_merges):
            counts: Counter = Counter()
            for seq in corpus:
                counts.update(zip(seq, seq[1:]))
            if not merge_digits:
                # merged ids never contain digits
                counts = Counter({p: c for p, c in counts.items()
                                  if not (p[0] in digit_bytes or p[1] in digit_bytes)})
            if not counts:
                break
            pair, freq = counts.most_common(1)[0]
            if freq < 4:
                break
            new_id = 258 + len(tok.merges)
            tok.merges.append(pair)
            corpus = [_merge_pair(seq, pair, new_id) for seq in corpus]
        tok._rebuild()
        return tok

    def encode(self, text: str) -> List[int]:
        seq = [b + self._BYTE0 for b in text.encode("utf-8")]
        while len(seq) > 1:
            # lowest-rank (earliest-learned) applicable pair first
            best, best_rank = None, None
            for pair in zip(seq, seq[1:]):
                r = self._rank.get(pair)
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = pair, r
            if best is None:
                break
            seq = _merge_pair(seq, best, best_rank)
        return seq

    def decode(self, ids: List[int]) -> str:
        out = b"".join(self._bytes.get(i, b"") for i in ids if i >= self._BYTE0)
        return out.decode("utf-8", errors="replace")

    def save(self, path: str):
        import json

        with open(path, "w") as f:
            json.dump({"merges": self.merges}, f)

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        import json

        with open(path) as f:
            data = json.load(f)
        return cls(merges=[tuple(m) for m in data["merges"]])


def _merge_pair(seq: List[int], pair: tuple, new_id: int) -> List[int]:
    """``seq`` with every non-overlapping occurrence of ``pair``, left to
    right, replaced by ``new_id``."""
    a, b = pair
    out, i, n = [], 0, len(seq)
    while i < n:
        if i + 1 < n and seq[i] == a and seq[i + 1] == b:
            out.append(new_id)
            i += 2
        else:
            out.append(seq[i])
            i += 1
    return out
