"""The port's tokenizer, datasets, batch iterator and token-budget
microbatching against the JAX package's, on the CPU. Everything here is
host-side Python and numpy: the two must agree exactly."""

import json

import numpy as np
import pytest

from rlinf_tpu.data import datasets as JD
from rlinf_tpu.data import dynamic_batching as JB
from rlinf_tpu.data.tokenizers import ByteTokenizer as JTokenizer
from rlinf_tpu_torch.data import datasets as TD
from rlinf_tpu_torch.data import dynamic_batching as TB
from rlinf_tpu_torch.data.tokenizers import ByteTokenizer

TEXTS = ["Compute 2 + 3. Final answer: ", "", "naïve café — ∑ 😀", "\x00\x01\n\t"]


@pytest.mark.parametrize("text", TEXTS)
def test_byte_tokenizer_round_trips(text):
    t, j = ByteTokenizer(), JTokenizer()
    ids = t.encode(text)
    assert ids == j.encode(text)
    assert t.decode(ids) == j.decode(ids) == text
    assert (t.vocab_size, t.pad_id, t.eos_id) == (j.vocab_size, j.pad_id, j.eos_id)


def test_byte_tokenizer_skips_ids_past_the_bytes():
    ids = list(np.random.default_rng(0).integers(0, 151936, 400))
    assert ByteTokenizer().decode(ids) == JTokenizer().decode(ids)


def _datasets(n=37):
    rows = [(f"q{i}", str(i)) for i in range(n)]
    return (JD.PromptDataset([JD.PromptExample(p, a) for p, a in rows]),
            TD.PromptDataset([TD.PromptExample(p, a) for p, a in rows]))


def _prompts(batch):
    return [e.prompt for e in batch]


@pytest.mark.parametrize("batch_size, seed", [(8, 0), (5, 3)])
def test_batch_iterator_matches_across_epochs(batch_size, seed):
    jd, td = _datasets()
    ji = JD.StatefulBatchIterator(jd, batch_size, seed=seed)
    ti = TD.StatefulBatchIterator(td, batch_size, seed=seed)
    steps = 3 * len(jd) // batch_size + 1          # into a fourth epoch
    for _ in range(steps):
        assert _prompts(ti.next_batch()) == _prompts(ji.next_batch())
    assert ti.epoch == ji.epoch == 3


def test_batch_iterator_resumes_mid_epoch():
    jd, td = _datasets()
    ji = JD.StatefulBatchIterator(jd, 6, seed=1)
    ti = TD.StatefulBatchIterator(td, 6, seed=1)
    for _ in range(4):
        ji.next_batch()
        ti.next_batch()
    state = json.loads(json.dumps(ti.state_dict()))
    assert state == ji.state_dict() and 0 < state["index"] < len(td)
    resumed = TD.StatefulBatchIterator(td, 6, seed=99)
    resumed.load_state_dict(state)
    for _ in range(10):
        want = _prompts(ji.next_batch())
        assert _prompts(resumed.next_batch()) == want
        assert _prompts(ti.next_batch()) == want


def test_prompt_dataset_from_jsonl(tmp_path):
    path = tmp_path / "d.jsonl"
    rows = [{"question": "1 + 1?", "answer": 2}, {"note": "no prompt"}, {},
            {"prompt": "p", "solution": "s", "extra": [1]}, {"problem": "x", "label": "y"},
            {"query": "q"}]
    path.write_text("\n".join(json.dumps(r) if r else "" for r in rows) + "\n")
    for limit in (None, 2):
        got = TD.PromptDataset.from_jsonl(str(path), max_examples=limit)
        want = JD.PromptDataset.from_jsonl(str(path), max_examples=limit)
        assert [(e.prompt, e.answer, e.meta) for e in got.examples] == [
            (e.prompt, e.answer, e.meta) for e in want.examples]
    assert len(got) == 2 and got[1].prompt == "p"


def _batch(r, B, T):
    lengths = r.integers(1, T + 1, B)
    attn = np.arange(T)[None, :] < lengths[:, None]
    return {"input_ids": r.integers(0, 1000, (B, T)).astype(np.int32),
            "attention_mask": attn, "loss_mask": attn & (r.random((B, T)) < 0.7),
            "old_logprobs": r.normal(size=(B, T)).astype(np.float32),
            "scalar_per_row": r.normal(size=B).astype(np.float32)}, lengths


@pytest.mark.parametrize("B, T, budget", [(16, 384, 1024), (33, 256, 700), (8, 128, 64),
                                          (128, 1536, 16384), (64, 768, 16384), (5, 64, 40)])
def test_pack_microbatches_matches(B, T, budget):
    """Array for array equal to the JAX package's packing (the lengths
    include ties and rows longer than the budget; 128 rows of 1536 under
    16384 tokens is a minibatch of grpo_math_qwen05b.yaml)."""
    r = np.random.default_rng(B)
    batch, lengths = _batch(r, B, T)
    lengths[:3] = lengths[0]                       # ties
    got = TB.pack_microbatches(batch, lengths, budget)
    want = JB.pack_microbatches(batch, lengths, budget)
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("n, budget", [(0, 8), (1, 10), (50, 300), (200, 2048)])
def test_best_fit_decreasing_matches(n, budget):
    """The same bins, in the same order, as the JAX package's Python
    partitioner (and so as its host C++ one)."""
    lengths = list(np.random.default_rng(n).integers(1, 400, n))
    assert TB.best_fit_decreasing(lengths, budget) == JB.best_fit_decreasing(lengths, budget)
