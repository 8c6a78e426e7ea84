"""The port's continuous-batching engine against the JAX package's on the
CPU, greedy, from the same params (``params_from_numpy``).

Where the arithmetic is the per-layer path's (no quantization in f32, or
int8 weights and an int8 KV cache on ``LLMConfig.tiny()``), the
``RolloutResult`` arrays must be equal and the logprobs agree within 1e-4
(summation order only). Where the decode step is the megakernel's (the JAX
side in interpret mode), bf16 roundings can flip a near-tie, so the bar is
the JAX package's own for that path: equal response lengths and greedy
agreement > 0.9 on the generated tokens; the logprobs of the tokens up to a
row's first difference agree within 0.05.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from rlinf_tpu.data.io_struct import RolloutRequest as JRequest
from rlinf_tpu.models.llm import model as JM
from rlinf_tpu.models.llm.config import LLMConfig as JConfig
from rlinf_tpu.models.llm.sampler import SamplingParams as JSampling
from rlinf_tpu.rollout.continuous_engine import ContinuousBatchingEngine as JEngine
from rlinf_tpu_torch.data.io_struct import RolloutRequest
from rlinf_tpu_torch.models.llm.config import LLMConfig as TConfig
from rlinf_tpu_torch.models.llm.convert import params_from_numpy
from rlinf_tpu_torch.models.llm.sampler import SamplingParams
from rlinf_tpu_torch.rollout.continuous_engine import ContinuousBatchingEngine

torch.set_num_threads(2)


def _params(jcfg, seed=0):
    tcfg = TConfig(**dataclasses.asdict(jcfg))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return tcfg, jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")


@pytest.fixture(scope="module")
def f32():
    jcfg = JConfig(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2,
                   num_heads=2, num_kv_heads=2, max_seq_len=256, dtype="float32",
                   qkv_bias=False, rope_theta=1e4)
    return (jcfg, *_params(jcfg))


@pytest.fixture(scope="module")
def tiny():
    jcfg = JConfig.tiny(vocab_size=64, max_seq_len=128)
    return (jcfg, *_params(jcfg))


def _both(setup, sp_kw, prompts, budgets=None, spy=None, **kw):
    jcfg, tcfg, jp, tp = setup
    jres = JEngine(jcfg, JSampling(**sp_kw), **kw).rollout(
        jp, JRequest(prompt_ids=prompts, max_new_tokens=budgets), jax.random.PRNGKey(1))
    eng = ContinuousBatchingEngine(tcfg, SamplingParams(**sp_kw), device="cpu", **kw)
    if spy is not None:
        spy(eng)
    tres = eng.rollout(tp, RolloutRequest(prompt_ids=prompts, max_new_tokens=budgets),
                       torch.Generator())
    return tres, jres


def _hold_equal(t, j, lp_tol=1e-4):
    np.testing.assert_array_equal(t.prompt_ids, j.prompt_ids)
    np.testing.assert_array_equal(t.prompt_mask, j.prompt_mask)
    np.testing.assert_array_equal(t.response_mask, j.response_mask)
    np.testing.assert_array_equal(t.response_ids, j.response_ids)
    np.testing.assert_allclose(t.response_logprobs, j.response_logprobs, atol=lp_tol)


def _prompts(seed, n, lo, hi, vocab):
    r = np.random.default_rng(seed)
    return [list(map(int, r.integers(1, vocab, int(r.integers(lo, hi))))) for _ in range(n)]


def test_engine_f32_matches_jax_with_slot_reuse(f32):
    tres, jres = _both(f32, dict(max_new_tokens=12, greedy=True), _prompts(0, 7, 3, 20, 128),
                       num_slots=3, max_seq_len=64, prompt_bucket=16, decode_chunk=4)
    _hold_equal(tres, jres)
    assert (tres.response_lengths == 12).all()


def test_engine_eos_frees_slots_as_jax(f32):
    prompts = _prompts(1, 6, 5, 6, 128)
    kw = dict(num_slots=2, max_seq_len=64, prompt_bucket=8, decode_chunk=3)
    probe, _ = _both(f32, dict(max_new_tokens=4, greedy=True), prompts[:1], **kw)
    eos = int(probe.response_ids[0, 1])
    tres, jres = _both(f32, dict(max_new_tokens=10, greedy=True, eos_token_id=eos), prompts, **kw)
    _hold_equal(tres, jres)
    assert tres.response_lengths.min() < 10


def test_engine_long_prompt_is_trimmed_as_jax(f32):
    tres, jres = _both(f32, dict(max_new_tokens=4, greedy=True), [list(range(1, 101))],
                       num_slots=1, max_seq_len=32, prompt_bucket=8, decode_chunk=2)
    _hold_equal(tres, jres)
    assert int(tres.response_lengths[0]) == 4


def test_engine_budgets_and_compaction_match_jax(f32):
    """A long tail: once the queue drains the pool shrinks, and the result
    is the JAX engine's all the same."""
    budgets = [4, 8, 12, 16, 24, 40] * 4
    sizes = []

    def spy(eng):
        orig = eng.decode_and_harvest
        eng.decode_and_harvest = lambda pool, *a: (sizes.append(pool.size), orig(pool, *a))[1]

    tres, jres = _both(f32, dict(max_new_tokens=40, greedy=True), _prompts(2, 24, 4, 16, 128),
                       budgets, spy, num_slots=32, max_seq_len=128, prompt_bucket=16,
                       decode_chunk=4)
    _hold_equal(tres, jres)
    np.testing.assert_array_equal(tres.response_lengths, budgets)
    assert sizes[0] == 32 and min(sizes) == 8


@pytest.mark.parametrize("weight_quant,kv_quant", [("int8", "int8"), ("none", "int8"),
                                                   ("int8", "none")])
def test_engine_quantized_matches_jax(tiny, weight_quant, kv_quant):
    tres, jres = _both(tiny, dict(max_new_tokens=8, greedy=True), _prompts(3, 10, 3, 12, 64),
                       [8, 3, 8, 5, 8, 8, 2, 8, 8, 6], num_slots=8, max_seq_len=32,
                       prompt_bucket=16, decode_chunk=4, weight_quant=weight_quant,
                       kv_quant=kv_quant, decode_attn_impl="xla")
    _hold_equal(tres, jres)


@pytest.mark.parametrize("use_mega", [True, "auto"])
def test_engine_megakernel_matches_jax(tiny, use_mega):
    """use_mega: the whole-step decode with per-row write positions inside
    the slot pool; "auto" starts per-layer (16 > 8) and moves the cache into
    the stacked layout when compaction shrinks the pool."""
    budgets = [4, 4, 8, 8, 12, 16, 16, 16]
    layouts = []

    def spy(eng):
        orig = eng.decode_and_harvest
        eng.decode_and_harvest = lambda pool, *a: (
            layouts.append(eng._is_stacked(pool.kv_layers)), orig(pool, *a))[1]

    tres, jres = _both(tiny, dict(max_new_tokens=16, greedy=True), _prompts(3, 8, 3, 10, 60),
                       budgets, spy, num_slots=16, max_seq_len=128, prompt_bucket=16,
                       decode_chunk=4, weight_quant="int8", kv_quant="int8",
                       decode_attn_impl="xla", use_mega=use_mega, mega_chunk_width=128,
                       mega_threshold=8)
    assert set(layouts) == ({True} if use_mega is True else {False, True})
    np.testing.assert_array_equal(tres.response_mask, jres.response_mask)
    np.testing.assert_array_equal(tres.response_lengths, budgets)
    same = tres.response_ids == jres.response_ids
    assert same[jres.response_mask].mean() > 0.9
    prefix = np.cumprod(same, axis=1).astype(bool) & jres.response_mask
    assert np.abs(tres.response_logprobs - jres.response_logprobs)[prefix].max() < 0.05


def test_engine_fused_sampler_draws_the_plain_paths_tokens(tiny):
    """sampler_impl="fused" and the plain lm-head path draw the same Philox
    noise from the same generator, here at temperature 0.8."""
    _, tcfg, _, tp = tiny
    runs = []
    for impl in ("fused", None):
        eng = ContinuousBatchingEngine(
            tcfg, SamplingParams(max_new_tokens=6, temperature=0.8), num_slots=8, max_seq_len=32,
            prompt_bucket=16, decode_chunk=3, weight_quant="int8", kv_quant="int8",
            sampler_impl=impl, device="cpu")
        runs.append(eng.rollout(tp, RolloutRequest(prompt_ids=_prompts(4, 5, 3, 9, 64)),
                                torch.Generator().manual_seed(5)))
    np.testing.assert_array_equal(runs[0].response_ids, runs[1].response_ids)
    np.testing.assert_allclose(runs[0].response_logprobs, runs[1].response_logprobs, atol=1e-5)
    assert (runs[0].response_logprobs <= 0).all() and runs[0].response_mask.all()


@pytest.mark.parametrize("kw,err", [
    (dict(use_mega="always", weight_quant="int8", kv_quant="int8"), "use_mega must be"),
    (dict(use_mega=1, weight_quant="int8", kv_quant="int8"), "use_mega must be"),
    (dict(sampler_impl="fused"), "sampler_impl='fused' needs"),
    (dict(use_mega=True), "needs weight_quant='int8' and kv_quant='int8'"),
    (dict(use_mega="auto", weight_quant="int8", kv_quant="int8", num_slots=12), "num_slots % 8"),
    (dict(use_mega=True, weight_quant="int8", kv_quant="int8", max_seq_len=100),
     "max_seq_len % 128"),
])
def test_engine_constructor_checks(tiny, kw, err):
    _, tcfg, _, _ = tiny
    args = {"num_slots": 8, "max_seq_len": 128, **kw}
    with pytest.raises(ValueError, match=err):
        ContinuousBatchingEngine(tcfg, SamplingParams(), device="cpu", **args)


def test_megakernel_weights_are_packed_at_the_first_stacked_decode(tiny):
    """Not at prepare_params: in "auto" mode a pool that never shrinks to
    the threshold never holds a second copy of the decode weights."""
    _, tcfg, _, tp = tiny
    eng = ContinuousBatchingEngine(
        tcfg, SamplingParams(max_new_tokens=4, greedy=True), num_slots=16, max_seq_len=128,
        prompt_bucket=16, decode_chunk=4, weight_quant="int8", kv_quant="int8",
        use_mega="auto", mega_threshold=8, compact=False, device="cpu")
    eng.rollout(tp, RolloutRequest(prompt_ids=_prompts(5, 3, 3, 9, 64)), torch.Generator())
    assert eng._mega_mw is None
    eng.mega_threshold = 16                   # now the pool starts in the stacked layout
    eng.rollout(tp, RolloutRequest(prompt_ids=_prompts(5, 3, 3, 9, 64)), torch.Generator())
    assert eng._mega_mw is not None
    eng.prepare_params(tp)
    assert eng._mega_mw is None               # new weights: packed again when needed


def test_engine_needs_a_card_unless_cpu_is_asked(tiny, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg, _, tp = tiny
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatchingEngine(tcfg, SamplingParams(max_new_tokens=2))
    eng = ContinuousBatchingEngine(tcfg, SamplingParams(max_new_tokens=2), device="cpu")
    with pytest.raises(NotImplementedError):
        eng.rollout(tp, RolloutRequest(prompt_ids=[[1, 2]]), torch.Generator(), mesh=object())
