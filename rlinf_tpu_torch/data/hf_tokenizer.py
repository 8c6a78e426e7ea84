"""Hugging Face byte-level BPE tokenizers, read from ``tokenizer.json`` and
``tokenizer_config.json`` without the ``tokenizers``, ``transformers`` or
``regex`` packages.

The scope is byte-level BPE as the Qwen2, Qwen2.5, Qwen3 and Llama-3
families ship it:

* normalizer: none or NFC;
* pre-tokenizer: ``Sequence[Split(regex, isolated), ByteLevel(use_regex=
  false)]`` or ``ByteLevel`` alone (GPT-2's split regex);
* the BPE model, with or without ``ignore_merges``;
* the ``ByteLevel`` decoder, and a ``ByteLevel``/``TemplateProcessing``
  post-processor;
* added tokens, matched (longest first) before pre-tokenization.

Anything else raises and names the feature. Ids, decodes, ``len``, the
special tokens and chat templates are those of ``transformers.AutoTokenizer``
on the same files (its fast tokenizer); ``tests/test_torch_tokenizers.py``
holds them to it.

The split regexes use Oniguruma's classes, which Python's ``re`` lacks or
reads differently: ``\\p{L}`` and ``\\p{N}`` become explicit ranges built
once from ``unicodedata`` (plus the code points Unicode 16.0, the version
of the ``tokenizers`` package's tables, assigns beyond Python's
``unicodedata``), ``\\s`` becomes Unicode White_Space (Python's ``\\s`` also
matches ``\\x1c``-``\\x1f``), and a case-insensitive group ``(?i:...)``
folds ASCII letters only, as Oniguruma does here (Python would also fold
``ſ`` to ``s``).
"""

from __future__ import annotations

import datetime
import functools
import heapq
import json
import os
import re
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte -> printable character table of the ByteLevel steps."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


BYTE_TO_CHAR = _bytes_to_unicode()
CHAR_TO_BYTE = {c: b for b, c in BYTE_TO_CHAR.items()}

#: GPT-2's split regex, which ByteLevel(use_regex=true) applies
GPT2_PATTERN = r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"

#: Unicode White_Space, Oniguruma's \s
_WHITE_SPACE = ("\\t\\n\\x0b\\x0c\\r \\x85\\xa0\\u1680\\u2000-\\u200a\\u2028\\u2029"
                "\\u202f\\u205f\\u3000")

#: code points that Unicode 16.0 assigns as letters (L*) and numbers (N*)
#: and Python 3.12's unicodedata (Unicode 15.0) leaves unassigned
_UNICODE16_EXTRA = {
    "L": ((0x1C89, 0x1C8A), (0xA7CB, 0xA7CD), (0xA7DA, 0xA7DC), (0x105C0, 0x105F3),
          (0x10D4A, 0x10D65), (0x10D6F, 0x10D85), (0x10EC2, 0x10EC4), (0x11380, 0x11389),
          (0x1138B, 0x1138B), (0x1138E, 0x1138E), (0x11390, 0x113B5), (0x113B7, 0x113B7),
          (0x113D1, 0x113D1), (0x113D3, 0x113D3), (0x11BC0, 0x11BE0), (0x13460, 0x143FA),
          (0x16100, 0x1611D), (0x16D40, 0x16D6C), (0x18CFF, 0x18CFF), (0x1E5D0, 0x1E5ED),
          (0x1E5F0, 0x1E5F0), (0x2EBF0, 0x2EE5D)),
    "N": ((0x10D40, 0x10D49), (0x116D0, 0x116E3), (0x11BF0, 0x11BF9), (0x16130, 0x16139),
          (0x16D70, 0x16D79), (0x1CCF0, 0x1CCF9), (0x1E5F1, 0x1E5FA)),
}


def _esc(cp: int) -> str:
    return f"\\U{cp:08X}" if cp > 0xFFFF else f"\\u{cp:04X}"


@functools.lru_cache(maxsize=None)
def _class_body(prop: str) -> str:
    """The ranges of Unicode general category ``prop`` ("L" or "N") as the
    body of a ``re`` character class."""
    cps = {cp for cp in range(0x110000) if unicodedata.category(chr(cp))[0] == prop}
    for a, b in _UNICODE16_EXTRA[prop]:
        cps.update(range(a, b + 1))
    ranges: List[List[int]] = []
    for cp in sorted(cps):
        if ranges and ranges[-1][1] == cp - 1:
            ranges[-1][1] = cp
        else:
            ranges.append([cp, cp])
    return "".join(_esc(a) if a == b else f"{_esc(a)}-{_esc(b)}" for a, b in ranges)


_GROUP_OPENERS = ("(?:", "(?=", "(?!", "(?<=", "(?<!", "(?>")


def translate_regex(pattern: str) -> str:
    """An Oniguruma pattern of a tokenizer's Split step as a ``re`` pattern
    that matches the same strings (see the module docstring). Raises on a
    construct it does not translate."""
    out: List[str] = []
    scopes: List[bool] = []     # the enclosing groups' case-insensitivity
    ci = False
    in_class = False
    i, n = 0, len(pattern)
    while i < n:
        c = pattern[i]
        if c == "\\":
            if i + 1 >= n:
                raise ValueError(f"tokenizer regex {pattern!r} ends with a backslash")
            e = pattern[i + 1]
            if e in "pP":
                m = re.match(r"\{(\w+)\}", pattern[i + 2:])
                prop, j = (m.group(1), i + 2 + m.end()) if m else (pattern[i + 2:i + 3], i + 3)
                if prop not in ("L", "N"):
                    raise ValueError(f"tokenizer regex class \\{e}{{{prop}}} is not supported")
                body = _class_body(prop)
                if in_class:
                    if e == "P":
                        raise ValueError("tokenizer regex: \\P{...} inside a class is not supported")
                    out.append(body)
                else:
                    out.append(("[" if e == "p" else "[^") + body + "]")
                i = j
                continue
            if e in "sS":
                if in_class:
                    if e == "S":
                        raise ValueError("tokenizer regex: \\S inside a class is not supported")
                    out.append(_WHITE_SPACE)
                else:
                    out.append(("[" if e == "s" else "[^") + _WHITE_SPACE + "]")
                i += 2
                continue
            if e.isalnum() and e not in "rntfvxu0":
                raise ValueError(f"tokenizer regex escape \\{e} is not supported")
            if e == "x" and pattern[i + 2:i + 3] == "{":
                end = pattern.index("}", i)
                out.append(_esc(int(pattern[i + 3:end], 16)))
                i = end + 1
                continue
            out.append(pattern[i:i + 2])
            i += 2
            continue
        if in_class:
            if c == "]":
                in_class = False
            elif c == "[":
                raise ValueError("tokenizer regex: nested character classes are not supported")
            elif ci and c.isalpha():
                raise ValueError("tokenizer regex: a class inside (?i:...) is not supported")
            out.append(c)
            i += 1
            continue
        if c == "[":
            in_class = True
            out.append("[")
            i += 1
            if pattern[i:i + 1] == "^":
                out.append("^")
                i += 1
            if pattern[i:i + 1] == "]":
                out.append("\\]")
                i += 1
            continue
        if c == "(":
            if pattern.startswith("(?i:", i):
                scopes.append(ci)
                ci = True
                out.append("(?:")
                i += 4
                continue
            opener = "("
            if pattern.startswith("(?", i):
                opener = next((g for g in _GROUP_OPENERS if pattern.startswith(g, i)), None)
                if opener is None:
                    raise ValueError(f"tokenizer regex group {pattern[i:i + 4]!r}... is not supported")
            scopes.append(ci)
            out.append(opener)
            i += len(opener)
            continue
        if c == ")":
            ci = scopes.pop() if scopes else False
            out.append(")")
            i += 1
            continue
        if ci and c.isalpha():
            if not c.isascii():
                raise ValueError(f"tokenizer regex: non-ASCII letter {c!r} in (?i:...)")
            out.append(f"[{c.lower()}{c.upper()}]")
            i += 1
            continue
        out.append(c)
        i += 1
    return "".join(out)


def _split_isolated(regex: "re.Pattern", text: str) -> List[str]:
    """Split ``text`` into the regex's matches and the gaps between them."""
    pieces, last = [], 0
    for m in regex.finditer(text):
        if m.start() == m.end():
            continue
        if m.start() > last:
            pieces.append(text[last:m.start()])
        pieces.append(m.group())
        last = m.end()
    if last < len(text):
        pieces.append(text[last:])
    return pieces


def _need(cond: bool, feature: str) -> None:
    if not cond:
        raise ValueError(f"tokenizer.json: {feature} is not supported")


def _normalizer(spec) -> bool:
    """True for NFC, False for none."""
    if spec is None:
        return False
    if spec.get("type") == "Sequence":
        steps = [_normalizer(s) for s in spec.get("normalizers", [])]
        return any(steps)
    _need(spec.get("type") == "NFC", f"normalizer {spec.get('type')!r}")
    return True


def _pre_tokenizer(spec) -> List["re.Pattern"]:
    """The split regexes, in order, of a supported pre-tokenizer (ByteLevel
    with ``use_regex`` adds GPT-2's)."""
    _need(spec is not None, "a tokenizer without a pre-tokenizer")
    steps = spec["pretokenizers"] if spec.get("type") == "Sequence" else [spec]
    splits = []
    for k, step in enumerate(steps):
        kind = step.get("type")
        if kind == "Split":
            _need(step.get("behavior") == "Isolated",
                  f"Split behavior {step.get('behavior')!r}")
            _need(not step.get("invert", False), "Split with invert=true")
            pat = step["pattern"]
            if "Regex" in pat:
                splits.append(re.compile(translate_regex(pat["Regex"])))
            else:
                splits.append(re.compile(re.escape(pat["String"])))
        elif kind == "ByteLevel":
            _need(k == len(steps) - 1, "a pre-tokenizer step after ByteLevel")
            _need(not step.get("add_prefix_space", False), "ByteLevel add_prefix_space=true")
            if step.get("use_regex", True):
                splits.append(re.compile(translate_regex(GPT2_PATTERN)))
            return splits
        else:
            _need(False, f"pre-tokenizer {kind!r}")
    raise ValueError("tokenizer.json: a pre-tokenizer without ByteLevel is not supported")


def _post_processor(spec) -> List[dict]:
    """The TemplateProcessing steps of a post-processor (ByteLevel adds no
    tokens)."""
    if spec is None:
        return []
    kind = spec.get("type")
    if kind == "Sequence":
        return [t for s in spec["processors"] for t in _post_processor(s)]
    if kind == "ByteLevel":
        return []
    _need(kind == "TemplateProcessing", f"post-processor {kind!r}")
    return [spec]


class _BPE:
    """The BPE model: merges applied lowest rank first, ties leftmost, as the
    ``tokenizers`` package's ``Word::merge_all`` applies them."""

    def __init__(self, spec: dict):
        _need(spec.get("type") == "BPE", f"model {spec.get('type')!r}")
        _need(spec.get("dropout") is None, "BPE dropout")
        _need(not spec.get("byte_fallback", False), "BPE byte_fallback")
        _need(not spec.get("fuse_unk", False), "BPE fuse_unk")
        _need(not spec.get("continuing_subword_prefix"), "BPE continuing_subword_prefix")
        _need(not spec.get("end_of_word_suffix"), "BPE end_of_word_suffix")
        self.vocab: Dict[str, int] = spec["vocab"]
        self.unk = self.vocab[spec["unk_token"]] if spec.get("unk_token") else None
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, m in enumerate(spec["merges"]):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            self.merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[a + b])
        self._cache: Dict[str, List[int]] = {}

    def tokenize(self, word: str) -> List[int]:
        got = self._cache.get(word)
        if got is None:
            got = self._cache[word] = self._merge(word)
        return got

    def _merge(self, word: str) -> List[int]:
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        sym = []
        for ch in word:
            i = self.vocab.get(ch, self.unk)
            if i is not None:
                sym.append(i)
        n = len(sym)
        if n < 2:
            return sym
        merges = self.merges
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        nxt[-1] = -1
        alive = [True] * n
        heap = []
        for p in range(n - 1):
            m = merges.get((sym[p], sym[p + 1]))
            if m is not None:
                heap.append((m[0], p, m[1]))
        heapq.heapify(heap)
        while heap:
            _, p, new = heapq.heappop(heap)
            q = nxt[p]
            if not alive[p] or q == -1:
                continue
            m = merges.get((sym[p], sym[q]))
            if m is None or m[1] != new:
                continue      # an expired entry
            sym[p] = new
            alive[q] = False
            nxt[p] = nxt[q]
            if nxt[q] != -1:
                prev[nxt[q]] = p
            if prev[p] != -1:
                m = merges.get((sym[prev[p]], new))
                if m is not None:
                    heapq.heappush(heap, (m[0], prev[p], m[1]))
            if nxt[p] != -1:
                m = merges.get((new, sym[nxt[p]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], p, m[1]))
        return [s for s, a in zip(sym, alive) if a]


#: transformers' defaults for special tokens a tokenizer_config.json leaves
#: out, by ``tokenizer_class``
_CLASS_DEFAULTS = {
    "PreTrainedTokenizerFast": {},
    "Qwen2Tokenizer": {"unk_token": "<|endoftext|>", "eos_token": "<|endoftext|>",
                       "pad_token": "<|endoftext|>"},
}
_CLASS_DEFAULTS["Qwen2TokenizerFast"] = _CLASS_DEFAULTS["Qwen2Tokenizer"]
_SPECIAL_ATTRS = ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token",
                  "cls_token", "mask_token")


def _content(tok) -> Optional[str]:
    return tok.get("content") if isinstance(tok, dict) else tok


def _read_json(path: str):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


class HFTokenizer:
    """A tokenizer directory's ``tokenizer.json`` and
    ``tokenizer_config.json`` (and ``special_tokens_map.json`` or
    ``chat_template.jinja`` where present).

    ``encode`` adds no special tokens unless ``add_special_tokens`` says so
    (its default is the constructor's ``add_special_tokens``: False is the
    JAX package's ``HFTokenizer``, True is ``AutoTokenizer.encode``);
    ``decode`` keeps special tokens unless asked to skip them, drops ids
    that name no token (ids past the vocabulary), and cleans up spaces
    where the config asks for it.
    """

    def __init__(self, path: str, *, add_special_tokens: bool = False):
        tk_path = os.path.join(path, "tokenizer.json")
        if not os.path.exists(tk_path):
            raise FileNotFoundError(f"{path}: no tokenizer.json")
        spec = _read_json(tk_path)
        cfg_path = os.path.join(path, "tokenizer_config.json")
        cfg = _read_json(cfg_path) if os.path.exists(cfg_path) else {}
        stm_path = os.path.join(path, "special_tokens_map.json")
        if os.path.exists(stm_path):
            cfg.update(_read_json(stm_path))
        self.add_special_tokens = add_special_tokens

        self._nfc = _normalizer(spec.get("normalizer"))
        self._splits = _pre_tokenizer(spec.get("pre_tokenizer"))
        self._templates = _post_processor(spec.get("post_processor"))
        dec = spec.get("decoder")
        _need(dec is not None and dec.get("type") == "ByteLevel",
              f"decoder {None if dec is None else dec.get('type')!r}")
        self._model = _BPE(spec["model"])
        self._id_to_token = {i: t for t, i in self._model.vocab.items()}

        # added tokens: id -> (content, special, normalized)
        self._added: Dict[int, Tuple[str, bool, bool]] = {}
        for t in spec.get("added_tokens", []):
            for flag in ("single_word", "lstrip", "rstrip"):
                _need(not t.get(flag, False), f"added token {t['content']!r} with {flag}=true")
            self._added[t["id"]] = (t["content"], bool(t["special"]), bool(t["normalized"]))

        cls = cfg.get("tokenizer_class", "PreTrainedTokenizerFast")
        if cls not in _CLASS_DEFAULTS:
            raise ValueError(f"tokenizer_class {cls!r} is not supported "
                             f"(supported: {sorted(_CLASS_DEFAULTS)})")
        defaults = _CLASS_DEFAULTS[cls]
        self.special_tokens: Dict[str, Optional[str]] = {
            a: _content(cfg[a]) if a in cfg else defaults.get(a) for a in _SPECIAL_ATTRS}
        self.additional_special_tokens = [
            _content(t) for t in cfg.get("additional_special_tokens") or []]
        # transformers registers every special token as a special added token
        contents = {c for c, _, _ in self._added.values()}
        for tok in [*self.special_tokens.values(), *self.additional_special_tokens]:
            if tok is not None and tok not in contents:
                i = self._model.vocab.get(tok)
                if i is None:
                    raise ValueError(f"special token {tok!r} is in neither the vocabulary "
                                     "nor the added tokens")
                self._added[i] = (tok, True, False)
                contents.add(tok)
        self._added_by_content = {c: i for i, (c, _, _) in self._added.items()}
        self._special_contents = {c for c, s, _ in self._added.values() if s}
        self._raw_added = self._added_regex(normalized=False)
        self._norm_added = self._added_regex(normalized=True)

        self.clean_up_tokenization_spaces = bool(cfg.get("clean_up_tokenization_spaces", False))
        self.chat_template = cfg.get("chat_template")
        jinja_path = os.path.join(path, "chat_template.jinja")
        if os.path.exists(jinja_path):
            with open(jinja_path, encoding="utf-8") as f:
                self.chat_template = f.read()
        if isinstance(self.chat_template, list):
            named = {t["name"]: t["template"] for t in self.chat_template}
            if "default" not in named:
                raise ValueError(f"{path}: no 'default' among the chat templates {sorted(named)}")
            self.chat_template = named["default"]

        vocab_strings = set(self._model.vocab) | set(self._added_by_content)
        self.vocab_size = len(vocab_strings)
        self.eos_token_id = self.token_to_id(self.special_tokens["eos_token"])
        self.pad_token_id = self.token_to_id(self.special_tokens["pad_token"])
        self.eos_id = self.eos_token_id
        self.pad_id = self.pad_token_id or self.eos_token_id

    def __len__(self) -> int:
        return self.vocab_size

    @property
    def special_tokens_map(self) -> Dict[str, object]:
        """transformers' ``special_tokens_map``: the set special tokens."""
        out: Dict[str, object] = {a: t for a, t in self.special_tokens.items() if t}
        if self.additional_special_tokens:
            out["additional_special_tokens"] = list(self.additional_special_tokens)
        return out

    def token_to_id(self, token: Optional[str]) -> Optional[int]:
        if token is None:
            return None
        i = self._added_by_content.get(token)
        return self._model.vocab.get(token) if i is None else i

    def _added_regex(self, normalized: bool) -> Optional["re.Pattern"]:
        toks = sorted((c for c, _, norm in self._added.values() if norm == normalized),
                      key=lambda c: (-len(c), c))
        return re.compile("|".join(map(re.escape, toks))) if toks else None

    # ------------------------------------------------------------------
    def _split_added(self, regex, text: str):
        """(piece, id or None) pairs: added tokens and the text between."""
        if regex is None:
            return [(text, None)] if text else []
        out, last = [], 0
        for m in regex.finditer(text):
            if m.start() > last:
                out.append((text[last:m.start()], None))
            out.append((m.group(), self._added_by_content[m.group()]))
            last = m.end()
        if last < len(text):
            out.append((text[last:], None))
        return out

    def _encode_piece(self, text: str) -> List[int]:
        words = [text]
        for regex in self._splits:
            words = [w for word in words for w in _split_isolated(regex, word)]
        ids: List[int] = []
        for w in words:
            ids.extend(self._model.tokenize("".join(BYTE_TO_CHAR[b] for b in w.encode("utf-8"))))
        return ids

    def encode(self, text: str, add_special_tokens: Optional[bool] = None) -> List[int]:
        ids: List[int] = []
        for piece, tid in self._split_added(self._raw_added, text):
            if tid is not None:
                ids.append(tid)
                continue
            if self._nfc:
                piece = unicodedata.normalize("NFC", piece)
            for sub, sid in self._split_added(self._norm_added, piece):
                if sid is not None:
                    ids.append(sid)
                else:
                    ids.extend(self._encode_piece(sub))
        if self.add_special_tokens if add_special_tokens is None else add_special_tokens:
            for tpl in self._templates:
                ids = self._apply_template(tpl, ids)
        return ids

    @staticmethod
    def _apply_template(tpl: dict, ids: List[int]) -> List[int]:
        out: List[int] = []
        for part in tpl["single"]:
            if "SpecialToken" in part:
                out.extend(tpl["special_tokens"][part["SpecialToken"]["id"]]["ids"])
            else:
                _need(part["Sequence"]["id"] == "A", "a single-sequence template with sequence B")
                out.extend(ids)
        return out

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str:
        data = bytearray()
        for i in ids:
            i = int(i)
            added = self._added.get(i)
            tok = added[0] if added is not None else self._id_to_token.get(i)
            if tok is None or (skip_special_tokens and tok in self._special_contents):
                continue
            try:
                data.extend(CHAR_TO_BYTE[ch] for ch in tok)
            except KeyError:   # a character outside the byte table: raw UTF-8
                data.extend(tok.encode("utf-8"))
        text = data.decode("utf-8", errors="replace")
        if self.clean_up_tokenization_spaces:
            text = clean_up_tokenization(text)
        return text

    def apply_chat_template(self, messages, add_generation_prompt: bool = True, *,
                            tools=None, tokenize: bool = True):
        """``messages`` rendered with the chat template in transformers'
        jinja environment: the ids (no special tokens added), or with
        ``tokenize=False`` the text. ``tools`` is a list of JSON schemas
        (dicts) that the template renders, as transformers passes them."""
        if not self.chat_template:
            raise ValueError("the tokenizer has no chat_template")
        if tools is not None and not all(isinstance(t, dict) for t in tools):
            raise ValueError("tools must be JSON schemas (dicts)")
        text = _compile_template(self.chat_template).render(
            messages=messages, tools=None if tools is None else list(tools), documents=None,
            add_generation_prompt=add_generation_prompt, **self.special_tokens_map)
        return self.encode(text, add_special_tokens=False) if tokenize else text


def clean_up_tokenization(text: str) -> str:
    """transformers' ``clean_up_tokenization``."""
    return (text.replace(" .", ".").replace(" ?", "?").replace(" !", "!")
            .replace(" ,", ",").replace(" ' ", "'").replace(" n't", "n't")
            .replace(" 'm", "'m").replace(" 's", "'s").replace(" 've", "'ve")
            .replace(" 're", "'re"))


@functools.lru_cache(maxsize=8)
def _compile_template(source: str):
    """transformers' chat-template environment: sandboxed, ``trim_blocks``,
    ``lstrip_blocks``, loop controls, a ``{% generation %}`` block that
    renders its body, a ``tojson`` that does not escape HTML, and the
    ``raise_exception`` and ``strftime_now`` globals."""
    import jinja2
    import jinja2.ext
    from jinja2.sandbox import ImmutableSandboxedEnvironment

    class Generation(jinja2.ext.Extension):
        tags = {"generation"}

        def parse(self, parser):
            lineno = next(parser.stream).lineno
            body = parser.parse_statements(["name:endgeneration"], drop_needle=True)
            return jinja2.nodes.CallBlock(self.call_method("_render"), [], [], body).set_lineno(lineno)

        def _render(self, caller):
            return caller()

    def raise_exception(message):
        raise jinja2.exceptions.TemplateError(message)

    def tojson(x, ensure_ascii=False, indent=None, separators=None, sort_keys=False):
        return json.dumps(x, ensure_ascii=ensure_ascii, indent=indent,
                          separators=separators, sort_keys=sort_keys)

    def strftime_now(fmt):
        return datetime.datetime.now().strftime(fmt)

    env = ImmutableSandboxedEnvironment(trim_blocks=True, lstrip_blocks=True,
                                        extensions=[Generation, jinja2.ext.loopcontrols])
    env.filters["tojson"] = tojson
    env.globals["raise_exception"] = raise_exception
    env.globals["strftime_now"] = strftime_now
    return env.from_string(source)
