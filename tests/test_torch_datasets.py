"""The port's reasoning-dataset family (``ReasoningDataset``,
``WideSeekR1Dataset``, ``Rstar2Dataset``, ``create_rl_dataset``) and
``HFTokenizer.apply_chat_template(tokenize=False, tools=...)`` against the
JAX package's and transformers', on the CPU.

Every case of the JAX package's ``tests/test_reasoning_datasets.py`` runs
through both packages with its ``StubTokenizer``; the examples (prompt,
answer, meta) must be equal. Then the chat-templated datasets run on the
tokenizer fixture under a chat template that renders tools: the port's
``HFTokenizer`` on one side, transformers' ``AutoTokenizer`` (the surface
the JAX datasets call) on the other, with equal examples; and the rendered
text and ids equal transformers' (exact comparisons).
"""

import dataclasses
import json
import os
import shutil

import pytest

from rlinf_tpu.agents.rstar2 import get_tool_schemas as jget_tool_schemas
from rlinf_tpu.config import DataConfig as JDataConfig
from rlinf_tpu.data import datasets as jds
from rlinf_tpu_torch.agents.rstar2 import get_tool_schemas
from rlinf_tpu_torch.config import DataConfig
from rlinf_tpu_torch.data import datasets as tds
from rlinf_tpu_torch.data.tokenizers import HFTokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "hf_tokenizer")

#: a ChatML template that renders ``tools`` as Qwen2.5's does (a system
#: turn listing each schema as JSON), cut to its tool block
TOOLS_TEMPLATE = (
    "{%- if tools %}{{- '<|im_start|>system\\nYou are a helpful assistant.\\n\\n# Tools\\n<tools>' }}"
    "{%- for tool in tools %}{{- '\\n' }}{{- tool | tojson }}{%- endfor %}"
    "{{- '\\n</tools><|im_end|>\\n' }}"
    "{%- elif messages[0]['role'] != 'system' %}"
    "{{- '<|im_start|>system\\nYou are a helpful assistant.<|im_end|>\\n' }}{%- endif %}"
    "{%- for message in messages %}"
    "{{- '<|im_start|>' + message['role'] + '\\n' + message['content'] + '<|im_end|>\\n' }}"
    "{%- endfor %}"
    "{%- if add_generation_prompt %}{{- '<|im_start|>assistant\\n' }}{%- endif %}"
)


class StubTokenizer:
    """The JAX package's test tokenizer: one id a whitespace-split word."""

    def encode(self, text, add_special_tokens=True):
        toks = text.split()
        return ([0] if add_special_tokens else []) + list(range(len(toks)))

    def apply_chat_template(self, messages, tools=None,
                            add_generation_prompt=True, tokenize=False):
        body = " ".join(m["content"] for m in messages)
        tool_tag = f"[tools:{len(tools)}]" if tools else ""
        return f"<chat>{tool_tag}{body}<gen>"


def _write(tmp_path, name, rows, jsonl=True):
    p = tmp_path / name
    if jsonl:
        p.write_text("\n".join(json.dumps(r) for r in rows))
    else:
        p.write_text(json.dumps(rows))
    return str(p)


def _examples(ds):
    return [(e.prompt, e.answer, e.meta) for e in ds.examples]


def _both(cls_name, *args, tokenizers=None, **kw):
    """The dataset of each package on the same files and arguments."""
    tj, tt = tokenizers or (None, None)
    extra_j = {"tokenizer": tj} if tj is not None else {}
    extra_t = {"tokenizer": tt} if tt is not None else {}
    return (getattr(jds, cls_name)(*args, **kw, **extra_j),
            getattr(tds, cls_name)(*args, **kw, **extra_t))


def test_multi_file_merge_and_answer_coercion(tmp_path):
    a = _write(tmp_path, "a.jsonl", [
        {"prompt": "p1", "answer": "x"},
        {"prompt": "p2", "answer": ["y", "z"]},
    ])
    b = _write(tmp_path, "b.json", [{"prompt": "p3", "answer": "w"}], jsonl=False)
    c = _write(tmp_path, "c.json", {"prompt": "p4", "answer": 5}, jsonl=False)
    j, t = _both("ReasoningDataset", [a, b, c])
    assert _examples(t) == _examples(j)
    assert t.examples[0].answer == ["x"] and t.examples[1].answer == ["y", "z"]
    assert t.examples[2].meta["prompt"] == "p3" and t.examples[3].answer == 5


def test_data_size_truncation_and_custom_keys(tmp_path):
    p = _write(tmp_path, "d.jsonl", [{"q": f"question {i}", "gt": str(i)} for i in range(10)])
    for size in (4, 0, -1, None, 20):
        j, t = _both("ReasoningDataset", p, prompt_key="q", answer_key="gt", data_size=size)
        assert _examples(t) == _examples(j), size
    assert len(tds.ReasoningDataset(p, prompt_key="q", answer_key="gt", data_size=4)) == 4


def test_unsupported_extension_raises_as_jax(tmp_path):
    p = tmp_path / "d.csv"
    p.write_text("prompt,answer\n")
    for mod in (jds, tds):
        with pytest.raises(ValueError, match="Unsupported extension .csv"):
            mod.ReasoningDataset(str(p))


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("batch_size", [1, 2, 256])
def test_chat_template_and_length_filter(tmp_path, workers, batch_size):
    p = _write(tmp_path, "d.jsonl", [
        {"prompt": [{"role": "user", "content": "short one"}], "answer": "a"},
        {"prompt": [{"role": "user", "content": " ".join(["w"] * 50)}], "answer": "b"},
        {"prompt": "a plain string prompt", "answer": "c"},
    ])
    j, t = _both("ReasoningDataset", p, tokenizers=(StubTokenizer(), StubTokenizer()),
                 apply_chat_template=True, filter_prompt_by_length=True,
                 max_prompt_length=10, process_workers=workers, process_batch_size=batch_size)
    assert _examples(t) == _examples(j)
    assert len(t) == 2 and t.examples[0].prompt.startswith("<chat>")


def test_filter_without_template(tmp_path):
    p = _write(tmp_path, "d.jsonl", [{"prompt": " ".join(["w"] * n), "answer": str(n)}
                                     for n in (3, 12, 9, 30)])
    j, t = _both("ReasoningDataset", p, tokenizers=(StubTokenizer(), StubTokenizer()),
                 filter_prompt_by_length=True, max_prompt_length=10)
    assert _examples(t) == _examples(j) and len(t) == 2


def test_no_samples_raises_as_jax(tmp_path):
    p = _write(tmp_path, "d.jsonl", [{"prompt": " ".join(["w"] * 50), "answer": "b"}])
    for mod in (jds, tds):
        with pytest.raises(ValueError, match="No samples within max_prompt_length=10"):
            mod.ReasoningDataset(p, tokenizer=StubTokenizer(), filter_prompt_by_length=True,
                                 max_prompt_length=10)


def test_bad_rows_are_skipped_not_fatal(tmp_path, caplog):
    p = _write(tmp_path, "d.jsonl", [
        {"prompt": "fine", "answer": "a"},
        {"nope": 1},
        {"prompt": "also fine", "answer": "b"},
    ])
    j, t = _both("ReasoningDataset", p, tokenizers=(StubTokenizer(), StubTokenizer()),
                 apply_chat_template=True, process_batch_size=1)
    assert _examples(t) == _examples(j) and len(t) == 2
    assert "1 samples skipped due to format issues (kept 2/3)" in caplog.text


@pytest.mark.parametrize("markdown", [True, False])
@pytest.mark.parametrize("zh", [True, False])
def test_wideseek_answer_dicts(tmp_path, markdown, zh):
    p = _write(tmp_path, "w.jsonl", [
        {"prompt": "p", "answer": "ans", "instance_id": "zh-7", "unique_columns": ["c1"],
         "evaluation": json.dumps({"required": ["r1"]})},
        {"prompt": "q", "answer": ["a", "b"], "language": "zh", "evaluation": "{not json"},
        {"prompt": "r", "answer": "c", "evaluation": {"required": ["r2"]}, "cols": ["k"]},
    ])
    j, t = _both("WideSeekR1Dataset", p, is_markdown=markdown, enable_zh=zh,
                 unique_columns_key="unique_columns")
    assert _examples(t) == _examples(j)
    if markdown and zh:
        d = t.examples[0].answer
        assert d["is_markdown"] and d["language"] == "zh"
        assert d["unique_columns"] == ["c1"] and d["required"] == ["r1"]


def test_rstar2_tool_schemas_in_template(tmp_path):
    p = _write(tmp_path, "r.jsonl", [
        {"prompt": [{"role": "user", "content": "solve"}], "answer": "1"},
    ])
    for schemas in ([{"name": "python"}], None):
        j, t = _both("Rstar2Dataset", p, tokenizers=(StubTokenizer(), StubTokenizer()),
                     apply_chat_template=True, tool_schemas=schemas)
        assert _examples(t) == _examples(j)
        assert t.tool_schemas == j.tool_schemas
    assert "[tools:1]" in tds.Rstar2Dataset(
        p, tokenizer=StubTokenizer(), apply_chat_template=True,
        tool_schemas=[{"name": "python"}]).examples[0].prompt
    # rstar2 encodes without special tokens
    assert t._encode("a b c") == [0, 1, 2] == j._encode("a b c")
    assert get_tool_schemas() == jget_tool_schemas()


def test_create_rl_dataset_dispatch(tmp_path):
    tr = _write(tmp_path, "t.jsonl", [{"prompt": "p", "answer": "a"}])
    va = _write(tmp_path, "v.jsonl", [{"prompt": "q", "answer": "b"}])
    assert sorted(tds.DATASET_TYPE_MAP) == sorted(jds.DATASET_TYPE_MAP)
    for typ in sorted(tds.DATASET_TYPE_MAP):
        kw = dict(type=typ, train_data_paths=tr, val_data_paths=va)
        jtrain, jval = jds.create_rl_dataset(JDataConfig(**kw), StubTokenizer())
        ttrain, tval = tds.create_rl_dataset(DataConfig(**kw), StubTokenizer())
        assert type(ttrain).__name__ == type(jtrain).__name__
        assert _examples(ttrain) == _examples(jtrain) and _examples(tval) == _examples(jval)
    train, val = tds.create_rl_dataset(DataConfig(type="math", train_data_paths=tr), None)
    assert len(train) == 1 and val is None
    for mod, cfg in ((jds, JDataConfig), (tds, DataConfig)):
        with pytest.raises(ValueError, match="Unknown data.type 'nope'"):
            mod.create_rl_dataset(cfg(type="nope"), StubTokenizer())
    assert ({f.name for f in dataclasses.fields(DataConfig)}
            == {f.name for f in dataclasses.fields(JDataConfig)})


# ---------------------------------------------------------------------------
# the HF tokenizer's chat template with tools, against transformers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tools_tokenizer(tmp_path_factory):
    """A copy of the fixture whose chat template renders tools: the port's
    HFTokenizer and transformers' AutoTokenizer on it."""
    from transformers import AutoTokenizer

    d = tmp_path_factory.mktemp("tools_tok")
    for name in os.listdir(FIXTURE):
        shutil.copy(os.path.join(FIXTURE, name), d / name)
    cfg = json.loads((d / "tokenizer_config.json").read_text())
    cfg["chat_template"] = TOOLS_TEMPLATE
    (d / "tokenizer_config.json").write_text(json.dumps(cfg))
    return HFTokenizer(str(d)), AutoTokenizer.from_pretrained(str(d))


MESSAGES = [
    [{"role": "user", "content": "What is 6 * 7?"}],
    [{"role": "system", "content": "Be brief."}, {"role": "user", "content": "Add 2 and 3."},
     {"role": "assistant", "content": "5"}, {"role": "user", "content": "Now times 4."}],
]
TOOLS = [None, [], get_tool_schemas(),
         get_tool_schemas() + [{"type": "function", "function": {"name": "search",
                                                                  "parameters": {}}}]]


@pytest.mark.parametrize("tools", TOOLS, ids=["none", "empty", "python", "two"])
@pytest.mark.parametrize("msgs", range(len(MESSAGES)))
@pytest.mark.parametrize("gen", [True, False])
def test_chat_template_text_and_tools_match_transformers(tools_tokenizer, tools, msgs, gen):
    port, auto = tools_tokenizer
    messages = MESSAGES[msgs]
    text = port.apply_chat_template(messages, add_generation_prompt=gen, tools=tools,
                                    tokenize=False)
    assert isinstance(text, str)
    assert text == auto.apply_chat_template(messages, tools=tools, add_generation_prompt=gen,
                                            tokenize=False)
    ids = port.apply_chat_template(messages, add_generation_prompt=gen, tools=tools)
    assert ids == auto.apply_chat_template(messages, tools=tools, add_generation_prompt=gen,
                                           tokenize=True)
    assert ids == port.encode(text, add_special_tokens=False)
    if tools:
        assert "python_code_with_standard_io" in text


def test_chat_template_refuses_callable_tools(tools_tokenizer):
    port, _ = tools_tokenizer
    with pytest.raises(ValueError, match="JSON schemas"):
        port.apply_chat_template(MESSAGES[0], tools=[len], tokenize=False)


@pytest.mark.parametrize("typ,limit", [("reasoning", 150), ("rstar2", 600)])
def test_datasets_on_the_hf_tokenizer_match_jax(tmp_path, tools_tokenizer, typ, limit):
    """``create_rl_dataset`` with chat templating and length filtering: the
    port's HFTokenizer against transformers' AutoTokenizer under the JAX
    datasets, equal examples (rStar2: the python tool's schema in every
    prompt, lengths counted without special tokens)."""
    port, auto = tools_tokenizer
    rows = [{"prompt": "Tom has " * n + f"{n} apples?", "answer": str(n)}
            for n in (1, 5, 40, 90, 3)]
    rows.append({"prompt": [{"role": "user", "content": "a message list"}], "answer": "m"})
    path = _write(tmp_path, "d.jsonl", rows)
    kw = dict(type=typ, train_data_paths=path, apply_chat_template=True,
              filter_prompt_by_length=True, max_prompt_len=limit, process_batch_size=2)
    jtrain, _ = jds.create_rl_dataset(JDataConfig(**kw), auto)
    ttrain, _ = tds.create_rl_dataset(DataConfig(**kw), port)
    assert _examples(ttrain) == _examples(jtrain)
    assert len(ttrain) == len(rows) - 1      # the 90-word prompt is dropped
    assert all(("# Tools" in e.prompt) == (typ == "rstar2") for e in ttrain.examples)
