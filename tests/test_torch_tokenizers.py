"""The port's tokenizers against the JAX package's and transformers', on the
CPU.

``HFTokenizer`` reads ``tokenizer.json`` and ``tokenizer_config.json``
itself. It is held against the JAX package's ``HFTokenizer`` (which wraps
``transformers.AutoTokenizer``) and against ``AutoTokenizer`` on three
directories: the committed fixture ``tests/fixtures/hf_tokenizer``; a
tokenizer with Qwen2's pre-tokenizer trained here with ``tokenizers``; and a
Llama-3-style one trained here (``ignore_merges``, its ``\\p{N}{1,3}`` split,
a TemplateProcessing post-processor that adds a BOS token, and
``clean_up_tokenization_spaces``). Ids, decodes, ``len``, pad, eos and chat
template ids must be equal (exact comparisons), over a stated corpus and
hypothesis-generated text and ids.
"""

import json
import os
import sys

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from rlinf_tpu.data.tokenizers import BPETokenizer as JBPE
from rlinf_tpu.data.tokenizers import HFTokenizer as JHF
from rlinf_tpu_torch.data.hf_tokenizer import translate_regex
from rlinf_tpu_torch.data.tokenizers import BPETokenizer, HFTokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "hf_tokenizer")
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import make_hf_tokenizer_fixture as fixture_script  # noqa: E402

LLAMA3_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*"
    r"|\s*[\r\n]+|\s+(?!\S)|\s+"
)
LLAMA3_TEMPLATE = (
    "{{ bos_token }}{% for message in messages %}"
    "{{ '<|start_header_id|>' + message['role'] + '<|end_header_id|>\n\n' + message['content'] | trim"
    " + '<|eot_id|>' }}{% endfor %}"
    "{% if add_generation_prompt %}{{ '<|start_header_id|>assistant<|end_header_id|>\n\n' }}{% endif %}"
)

#: the stated corpus: ASCII, digit runs, whitespace runs with \x1c-\x1f,
#: CJK, combining accents (NFC), emoji, contractions in both cases, and
#: special tokens inside text
CORPUS = [
    "Tom has 5 apples. He buys 3 bags of 7 apples each. How many apples does Tom have now?",
    "1234567890 + 98765 = 1111111111; 3.14159 * 2 = 6.28318",
    "  leading and trailing  \n\n\tTabs\tand\r\nCRLF\x0b\x0c  end   ",
    "file\x1cgroup\x1drecord\x1eunit\x1f sep \x1c\x1d \x1f\x1f",
    "日本語のテキストと中文字符，还有한국어 문장。",
    "café naïve résumé Å Å",
    "emoji 😀🎉👍🏽 👨‍👩‍👧 flags 🇺🇸🇯🇵 and ✓✗",
    "IT'S it's They'RE we'VE I'M you'LL he'D 'ſ 'K",
    "<|im_start|>user\nHi there<|im_end|>\n<|im_start|>assistant\nok<|im_end|><|endoftext|>",
    "x<|im_end|>y<|im_start|><|im_start|>z <|endoftext|> ",
    "",
    " ",
    "a　b c d\u0085e f",
]
MESSAGES = [
    {"role": "system", "content": "You are terse."},
    {"role": "user", "content": "What is 12 + 30?"},
    {"role": "assistant", "content": "42"},
    {"role": "user", "content": "And 日本 😀?"},
]


def _training_texts():
    return fixture_script.gsm_corpus(300) + CORPUS * 20


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """{name: directory} of the three tokenizers."""
    base = tmp_path_factory.mktemp("tok")
    out = {"fixture": FIXTURE}
    qwen = fixture_script.build_tokenizer(_training_texts(), 700)
    out["qwen2"] = str(base / "qwen2")
    fixture_script.save_pretrained(qwen, out["qwen2"])

    from tokenizers import processors
    from transformers import PreTrainedTokenizerFast

    specials = ["<|begin_of_text|>", "<|end_of_text|>", "<|start_header_id|>",
                "<|end_header_id|>", "<|eot_id|>"]
    llama = fixture_script.build_tokenizer(_training_texts(), 800, ignore_merges=True,
                                           pattern=LLAMA3_PATTERN, specials=specials)
    bos = llama.token_to_id("<|begin_of_text|>")
    llama.post_processor = processors.Sequence([
        processors.ByteLevel(trim_offsets=False),
        processors.TemplateProcessing(single="<|begin_of_text|> $A",
                                      pair="<|begin_of_text|> $A <|begin_of_text|> $B",
                                      special_tokens=[("<|begin_of_text|>", bos)]),
    ])
    fast = PreTrainedTokenizerFast(tokenizer_object=llama, bos_token="<|begin_of_text|>",
                                   eos_token="<|eot_id|>", chat_template=LLAMA3_TEMPLATE,
                                   clean_up_tokenization_spaces=True)
    out["llama3"] = str(base / "llama3")
    fast.save_pretrained(out["llama3"])
    return out


NAMES = ["fixture", "qwen2", "llama3"]


@pytest.fixture(scope="module")
def pairs(dirs):
    """{name: (port HFTokenizer, JAX HFTokenizer, AutoTokenizer)}."""
    from transformers import AutoTokenizer

    return {n: (HFTokenizer(d), JHF(d), AutoTokenizer.from_pretrained(d)) for n, d in dirs.items()}


def test_fixture_is_what_the_script_writes(tmp_path):
    """The committed fixture is the script's output (Qwen2 layout, ChatML)."""
    assert fixture_script.main(["--out", str(tmp_path)]) == 0
    for name in ("tokenizer.json", "tokenizer_config.json"):
        with open(os.path.join(FIXTURE, name)) as f, open(tmp_path / name) as g:
            assert json.load(f) == json.load(g), name
    spec = json.load(open(os.path.join(FIXTURE, "tokenizer.json")))
    assert spec["pre_tokenizer"]["pretokenizers"][0]["pattern"]["Regex"] == fixture_script.QWEN2_PATTERN
    assert len(spec["model"]["merges"]) > 100
    assert [t["content"] for t in spec["added_tokens"]] == fixture_script.SPECIALS


@pytest.mark.parametrize("name", NAMES)
def test_ids_and_decodes_match_jax_and_transformers(pairs, name):
    port, jax_tk, auto = pairs[name]
    assert len(port) == jax_tk.vocab_size == len(auto)
    assert port.vocab_size == jax_tk.vocab_size
    assert (port.pad_id, port.eos_id) == (jax_tk.pad_id, jax_tk.eos_id)
    assert port.eos_token_id == auto.eos_token_id and port.pad_token_id == auto.pad_token_id
    assert port.special_tokens_map == auto.special_tokens_map
    for text in CORPUS:
        ids = port.encode(text)
        assert ids == jax_tk.encode(text), text
        assert HFTokenizer(pairs_dir(pairs, name), add_special_tokens=True).encode(text) == \
            auto.encode(text), text
        assert port.decode(ids) == jax_tk.decode(ids) == auto.decode(ids), text
        assert port.decode(ids, skip_special_tokens=True) == auto.decode(
            ids, skip_special_tokens=True), text


def pairs_dir(pairs, name):
    return pairs[name][2].name_or_path


@pytest.mark.parametrize("name", NAMES)
def test_decode_of_invalid_utf8_and_ids_past_the_vocabulary(pairs, name):
    """Byte tokens that form invalid UTF-8 decode lossily as in
    transformers; ids past the vocabulary (a model's padded vocabulary) are
    dropped."""
    port, jax_tk, auto = pairs[name]
    byte_id = lambda b: port.token_to_id(fixture_script_byte_char(b))
    cases = [
        [byte_id(0xE6), byte_id(0x97)],                    # a cut 3-byte sequence
        [byte_id(0xF0), byte_id(0x80), byte_id(0x41)],     # an overlong start
        [byte_id(0xFF), byte_id(0xC3), byte_id(0x28)],
        [byte_id(0xED), byte_id(0xA0), byte_id(0x80)],     # a UTF-16 surrogate
        port.encode("ok ") + [len(port), len(port) + 5, 151_935] + port.encode(" fine"),
    ]
    for ids in cases:
        assert port.decode(ids) == jax_tk.decode(ids) == auto.decode(ids), ids


def fixture_script_byte_char(b):
    from rlinf_tpu_torch.data.hf_tokenizer import BYTE_TO_CHAR

    return BYTE_TO_CHAR[b]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("gen", [True, False])
def test_chat_template_ids_match(pairs, name, gen):
    port, jax_tk, auto = pairs[name]
    ids = port.apply_chat_template(MESSAGES, add_generation_prompt=gen)
    assert ids == jax_tk.apply_chat_template(MESSAGES, add_generation_prompt=gen)
    assert port.decode(ids) == auto.apply_chat_template(MESSAGES, add_generation_prompt=gen,
                                                         tokenize=False)


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=st.text(max_size=40))
@pytest.mark.parametrize("name", NAMES)
def test_hypothesis_text(pairs, name, text):
    port, jax_tk, _ = pairs[name]
    ids = port.encode(text)
    assert ids == jax_tk.encode(text)
    assert port.decode(ids) == jax_tk.decode(ids)


_SPECIAL_TEXT = st.lists(st.sampled_from(
    ["<|im_start|>", "<|im_end|>", "<|endoftext|>", "<|eot_id|>", "<|im_", " ", "\n", "a", "日",
     "1", "'s", "'S"]), max_size=12).map("".join)


@settings(max_examples=80, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=_SPECIAL_TEXT)
@pytest.mark.parametrize("name", NAMES)
def test_hypothesis_special_tokens_in_text(pairs, name, text):
    port, jax_tk, _ = pairs[name]
    assert port.encode(text) == jax_tk.encode(text)


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(ids=st.lists(st.integers(0, 2000), max_size=24))
@pytest.mark.parametrize("name", NAMES)
def test_hypothesis_ids_decode(pairs, name, ids):
    port, jax_tk, auto = pairs[name]
    assert port.decode(ids) == jax_tk.decode(ids)
    assert port.decode(ids, skip_special_tokens=True) == auto.decode(ids, skip_special_tokens=True)


@pytest.mark.parametrize("pattern,text,want", [
    # Python's \s takes \x1c-\x1f; Unicode White_Space (Oniguruma's) does not
    (r"\s+", "a\x1c\x1d b", [" "]),
    (r"\S+", "a\x1c b", ["a\x1c", "b"]),
    # (?i:...) folds ASCII only: not long s
    (r"(?i:'s)", "'S 'ſ 's", ["'S", "'s"]),
    (r"\p{L}+", "ab1\U00013460c", ["ab", "\U00013460c"]),   # a Unicode 16 letter
    (r"\p{N}{1,3}", "12345", ["123", "45"]),
])
def test_translated_regex_classes(pattern, text, want):
    import re

    assert re.findall(translate_regex(pattern), text) == want


@pytest.mark.parametrize("pattern", [r"\w+", r"\p{Lu}", r"(?x:a)", r"[\S]", r"\d"])
def test_untranslated_regex_constructs_raise(pattern):
    with pytest.raises(ValueError, match="not supported"):
        translate_regex(pattern)


def test_unsupported_tokenizer_features_raise(tmp_path):
    spec = json.load(open(os.path.join(FIXTURE, "tokenizer.json")))
    cfg = json.load(open(os.path.join(FIXTURE, "tokenizer_config.json")))
    cases = [
        ("normalizer", {"type": "NFKC"}, "normalizer 'NFKC'"),
        ("decoder", {"type": "Metaspace"}, "decoder 'Metaspace'"),
        ("post_processor", {"type": "RobertaProcessing"}, "post-processor 'RobertaProcessing'"),
    ]
    for key, value, match in cases:
        d = tmp_path / key
        d.mkdir()
        json.dump({**spec, key: value}, open(d / "tokenizer.json", "w"))
        json.dump(cfg, open(d / "tokenizer_config.json", "w"))
        with pytest.raises(ValueError, match=match):
            HFTokenizer(str(d))
    d = tmp_path / "model"
    d.mkdir()
    json.dump({**spec, "model": {**spec["model"], "byte_fallback": True}}, open(d / "tokenizer.json", "w"))
    with pytest.raises(ValueError, match="byte_fallback"):
        HFTokenizer(str(d))
    with pytest.raises(FileNotFoundError, match="tokenizer.json"):
        HFTokenizer(str(tmp_path / "nowhere"))


# ---------------------------------------------------------------------------
# BPETokenizer
# ---------------------------------------------------------------------------

def test_bpe_tokenizer_matches_jax_and_files_load_across(tmp_path):
    texts = _training_texts()
    port = BPETokenizer.train(texts, num_merges=120)
    jax_tk = JBPE.train(texts, num_merges=120)
    assert [tuple(m) for m in port.merges] == [tuple(m) for m in jax_tk.merges]
    assert port.vocab_size == jax_tk.vocab_size
    for text in CORPUS:
        ids = port.encode(text)
        assert ids == jax_tk.encode(text)
        assert port.decode(ids) == jax_tk.decode(ids)
    port.save(str(tmp_path / "port.json"))
    jax_tk.save(str(tmp_path / "jax.json"))
    assert JBPE.load(str(tmp_path / "port.json")).merges == jax_tk.merges
    assert BPETokenizer.load(str(tmp_path / "jax.json")).merges == port.merges


@pytest.mark.parametrize("merge_digits", [False, True])
def test_bpe_digit_rule_matches_jax(merge_digits):
    texts = ["12 + 34 = 46", "100 apples and 200 pens", "2024 2025 2026"] * 10
    port = BPETokenizer.train(texts, num_merges=40, merge_digits=merge_digits)
    jax_tk = JBPE.train(texts, num_merges=40, merge_digits=merge_digits)
    assert [tuple(m) for m in port.merges] == [tuple(m) for m in jax_tk.merges]
    assert port.encode("1234 pens") == jax_tk.encode("1234 pens")
