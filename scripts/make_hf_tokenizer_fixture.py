"""Write the Hugging Face tokenizer fixture ``tests/fixtures/hf_tokenizer/``.

A Qwen2-style byte-level BPE (NFC normalizer, Qwen2's split regex, the
ByteLevel pre-tokenizer and decoder) with a few hundred merges trained on
the synthetic GSM corpus of ``rlinf_tpu_torch/data/gsm_synth.py``, the
special tokens ``<|endoftext|>``, ``<|im_start|>`` and ``<|im_end|>`` and a
ChatML chat template. It writes ``tokenizer.json`` and
``tokenizer_config.json`` as transformers' ``save_pretrained`` does. Needs
the ``tokenizers`` and ``transformers`` packages; the port reads the files
without them.

Usage:
  python scripts/make_hf_tokenizer_fixture.py [--out tests/fixtures/hf_tokenizer] [--merges 400]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

#: Qwen2's pre-tokenizer split pattern
QWEN2_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*"
    r"|\s*[\r\n]+|\s+(?!\S)|\s+"
)
SPECIALS = ["<|endoftext|>", "<|im_start|>", "<|im_end|>"]
#: the ChatML template of Qwen2.5's tokenizer_config.json, without tools
CHATML_TEMPLATE = (
    "{% for message in messages %}"
    "{% if loop.first and messages[0]['role'] != 'system' %}"
    "{{ '<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n' }}"
    "{% endif %}"
    "{{'<|im_start|>' + message['role'] + '\n' + message['content'] + '<|im_end|>' + '\n'}}"
    "{% endfor %}"
    "{% if add_generation_prompt %}{{ '<|im_start|>assistant\n' }}{% endif %}"
)


def build_tokenizer(texts, vocab_size: int, *, ignore_merges: bool = False,
                    pattern: str = QWEN2_PATTERN, specials=SPECIALS):
    """A trained ``tokenizers.Tokenizer`` of the Qwen2 layout."""
    from tokenizers import Regex, Tokenizer, decoders, models, normalizers, pre_tokenizers, trainers
    from tokenizers import processors

    tk = Tokenizer(models.BPE(ignore_merges=ignore_merges))
    tk.normalizer = normalizers.NFC()
    tk.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(pattern), behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False),
    ])
    tk.decoder = decoders.ByteLevel()
    tk.post_processor = processors.ByteLevel(trim_offsets=False)
    trainer = trainers.BpeTrainer(
        vocab_size=vocab_size, min_frequency=1, special_tokens=list(specials),
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(), show_progress=False,
    )
    tk.train_from_iterator(texts, trainer)
    return tk


def save_pretrained(tk, out: str, *, chat_template: str = CHATML_TEMPLATE,
                    clean_up_tokenization_spaces: bool = False) -> None:
    """Save ``tk`` as a transformers Qwen2 fast tokenizer in ``out``."""
    from transformers import Qwen2TokenizerFast

    fast = Qwen2TokenizerFast(
        tokenizer_object=tk, eos_token="<|im_end|>", pad_token="<|endoftext|>",
        unk_token=None, bos_token=None, chat_template=chat_template,
        clean_up_tokenization_spaces=clean_up_tokenization_spaces,
        model_max_length=32768,
    )
    fast.save_pretrained(out)
    # the template goes into tokenizer_config.json, as published Qwen
    # checkpoints ship it, in place of transformers' chat_template.jinja
    config_path = os.path.join(out, "tokenizer_config.json")
    with open(config_path, encoding="utf-8") as f:
        config = json.load(f)
    config["chat_template"] = chat_template
    with open(config_path, "w", encoding="utf-8") as f:
        json.dump(config, f, indent=2, ensure_ascii=False)
        f.write("\n")
    for extra in ("chat_template.jinja", "special_tokens_map.json", "vocab.json",
                  "merges.txt", "added_tokens.json"):
        path = os.path.join(out, extra)
        if os.path.exists(path):
            os.remove(path)


def gsm_corpus(n: int = 2000, seed: int = 0):
    """The SFT examples of ``gsm_synth`` as prompt + answer texts, each also
    in a ChatML conversation."""
    from rlinf_tpu_torch.data.gsm_synth import build_sft_examples

    out = []
    for ex in build_sft_examples(n, seed):
        out.append(ex.prompt + ex.answer)
        out.append("<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
                   f"<|im_start|>user\n{ex.prompt}<|im_end|>\n"
                   f"<|im_start|>assistant\n{ex.answer}<|im_end|>\n")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("tests", "fixtures", "hf_tokenizer"))
    ap.add_argument("--merges", type=int, default=400)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    # 256 byte symbols + the specials + the merges
    tk = build_tokenizer(gsm_corpus(), 256 + len(SPECIALS) + args.merges)
    save_pretrained(tk, args.out)
    print(f"wrote {args.out}: vocab {tk.get_vocab_size()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
