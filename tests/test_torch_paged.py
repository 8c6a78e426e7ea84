"""The port's paged-KV pieces against the JAX package on the CPU: the plain
version of kernel K10, ``PagePool``, the page-pool cache ops and the paged
engine.

Tolerances: f32 paged attention within 1e-5 (summation order only), bf16
within 8e-3 (one bf16 ulp of values below 1). The JAX Pallas kernel
(interpret mode) gives 0 on a row of length 0 and so does the port; the JAX
gather oracle does not, so it is compared on rows of length >= 1 only.
``PagePool`` is exact. The engines run an f32 model: greedy tokens must be
equal and logprobs agree within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlinf_tpu.data.io_struct import RolloutRequest as JRequest
from rlinf_tpu.models.llm import model as JM
from rlinf_tpu.models.llm.config import LLMConfig as JConfig
from rlinf_tpu.models.llm.sampler import SamplingParams as JSampling
from rlinf_tpu.ops.pallas.paged_attention import paged_attention as j_paged_attention
from rlinf_tpu.ops.pallas.paged_attention import paged_attention_xla as j_paged_attention_xla
from rlinf_tpu.rollout import paged_cache as JPC
from rlinf_tpu.rollout.paged_engine import PagedContinuousEngine as JPagedEngine
from rlinf_tpu_torch.data.io_struct import RolloutRequest
from rlinf_tpu_torch.models.llm.config import LLMConfig as TConfig
from rlinf_tpu_torch.models.llm.convert import cache_from_numpy, params_from_numpy
from rlinf_tpu_torch.models.llm.sampler import SamplingParams
from rlinf_tpu_torch.ops.cuda.paged_attention import paged_attention, paged_attention_xla
from rlinf_tpu_torch.rollout import paged_cache as TPC
from rlinf_tpu_torch.rollout.paged_engine import PagedContinuousEngine

torch.set_num_threads(2)


def _case(dtype, B=5, H=8, Kv=2, Hd=64, P=16, max_pages=4, seed=0):
    r = np.random.default_rng(seed)
    num_pages = B * max_pages + 1
    q = r.normal(size=(B, H, Hd)).astype(np.float32)
    kp = (r.normal(size=(num_pages, Kv, P, Hd)) * 0.5).astype(np.float32)
    vp = (r.normal(size=(num_pages, Kv, P, Hd)) * 0.5).astype(np.float32)
    table = np.zeros((B, max_pages), np.int32)
    lengths = r.integers(1, max_pages * P + 1, (B,)).astype(np.int32)
    lengths[1], lengths[2] = 0, max_pages * P
    pages = r.permutation(np.arange(1, num_pages))
    at = 0
    for b in range(B):
        n = -(-int(lengths[b]) // P)
        table[b, :n] = pages[at:at + n]
        at += n
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jargs = (jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
             jnp.asarray(table), jnp.asarray(lengths))
    targs = cache_from_numpy(tuple(np.asarray(a) for a in jargs))
    return jargs, targs, lengths


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 8e-3)])
def test_plain_paged_attention_matches_jax(dtype, tol):
    jargs, targs, lengths = _case(dtype)
    kernel = np.asarray(j_paged_attention(*jargs, interpret=True), np.float32)
    oracle = np.asarray(j_paged_attention_xla(*jargs), np.float32)
    for fn in (paged_attention, paged_attention_xla):   # CPU tensors: the plain version
        out = fn(*targs)
        assert out.dtype == targs[0].dtype and out.shape == targs[0].shape
        got = out.float().numpy()
        np.testing.assert_allclose(got, kernel, atol=tol)
        live = lengths >= 1
        np.testing.assert_allclose(got[live], oracle[live], atol=tol)
        assert (got[~live] == 0).all() and (kernel[~live] == 0).all()


def test_plain_paged_attention_scale_argument():
    jargs, targs, _ = _case("float32", seed=3)
    want = np.asarray(j_paged_attention(*jargs, scale=0.2, interpret=True))
    np.testing.assert_allclose(paged_attention(*targs, scale=0.2).numpy(), want, atol=1e-5)


def _script(pool):
    """One scripted life of a pool; returns everything a caller can see."""
    log = []
    pool.alloc_slot(0, 20)
    pool.alloc_slot(2, 8)
    log.append(pool.arrays())
    log.append([pool.append_token(0) for _ in range(13)])
    log.append((pool.can_alloc(8 * 5), pool.can_alloc(8 * 6), pool.free_pages, pool.pages_needed(17)))
    log.append(pool.append_tokens_chunk(np.array([True, False, True, False]), 5))
    pool.free_slot(0)
    pool.alloc_slot(1, 30)
    pool.lengths[1] = 25                      # the engine counts real tokens only
    log.append(pool.append_tokens_chunk(np.array([False, True, True, False]), 9))
    log.append(pool.arrays())
    log.append(pool.free_pages)
    for s in (1, 2):
        pool.free_slot(s)
    log.append((pool.free_pages, pool.arrays()))
    return log


def _assert_same(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_page_pool_matches_jax_on_a_scripted_sequence():
    args = dict(num_pages=12, page_size=8, num_slots=4, max_pages_per_slot=6)
    _assert_same(_script(TPC.PagePool(**args)), _script(JPC.PagePool(**args)))


@pytest.mark.parametrize("call", ["alloc", "append", "chunk"])
def test_page_pool_exhaustion_raises_as_jax(call):
    for mod in (TPC, JPC):
        pool = mod.PagePool(num_pages=3, page_size=4, num_slots=2, max_pages_per_slot=4)
        pool.alloc_slot(0, 8)
        with pytest.raises(MemoryError):
            if call == "alloc":
                pool.alloc_slot(1, 4)
            elif call == "append":
                pool.append_token(0)
            else:
                pool.append_tokens_chunk(np.array([True, False]), 2)


def test_page_pool_cache_write_matches_jax():
    r = np.random.default_rng(0)
    L, NP, Kv, P, Hd, B = 2, 7, 2, 4, 8, 3
    jk, jv = JPC.init_page_pool_cache(L, NP, P, Kv, Hd, jnp.float32)
    tk, tv = TPC.init_page_pool_cache(L, NP, P, Kv, Hd, torch.float32)
    assert tuple(tk.shape) == jk.shape == (L, NP, Kv, P, Hd) and not tk.any() and not tv.any()
    k_new, v_new = r.normal(size=(2, B, Kv, Hd)).astype(np.float32)
    pages, offs = np.array([3, 1, 6], np.int32), np.array([0, 3, 2], np.int32)
    jk1, jv1 = JPC.paged_cache_write(jk[1], jv[1], jnp.asarray(k_new), jnp.asarray(v_new),
                                     jnp.asarray(pages), jnp.asarray(offs))
    tk1, tv1 = TPC.paged_cache_write(tk[1], tv[1], torch.as_tensor(k_new), torch.as_tensor(v_new),
                                     torch.as_tensor(pages), torch.as_tensor(offs))
    np.testing.assert_array_equal(tk1.numpy(), np.asarray(jk1))
    np.testing.assert_array_equal(tv1.numpy(), np.asarray(jv1))
    assert tk1.data_ptr() == tk[1].data_ptr()          # in place


@pytest.fixture(scope="module")
def engine_setup():
    jcfg = JConfig(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2,
                   num_heads=4, num_kv_heads=2, max_seq_len=256, dtype="float32",
                   qkv_bias=False, rope_theta=1e4)
    tcfg = TConfig(**dataclasses.asdict(jcfg))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    return jcfg, tcfg, jp, tp


def _hold_results(t, j, lp_tol=1e-4):
    np.testing.assert_array_equal(t.prompt_ids, j.prompt_ids)
    np.testing.assert_array_equal(t.prompt_mask, j.prompt_mask)
    np.testing.assert_array_equal(t.response_mask, j.response_mask)
    np.testing.assert_array_equal(t.response_ids, j.response_ids)
    np.testing.assert_allclose(t.response_logprobs, j.response_logprobs, atol=lp_tol)
    assert t.response_ids.dtype == np.int32 and t.response_logprobs.dtype == np.float32


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_paged_engine_greedy_matches_jax(engine_setup, attn_impl):
    jcfg, tcfg, jp, tp = engine_setup
    r = np.random.default_rng(0)
    prompts = [list(map(int, r.integers(1, 128, size=r.integers(3, 30)))) for _ in range(7)]
    budgets = [12, 5, 12, 9, 12, 1, 12]
    kw = dict(num_slots=3, max_seq_len=64, prompt_bucket=16, decode_chunk=4, page_size=8)
    jres = JPagedEngine(jcfg, JSampling(max_new_tokens=12, greedy=True), **kw).generate(
        jp, JRequest(prompt_ids=prompts, max_new_tokens=budgets), jax.random.PRNGKey(1))
    eng = PagedContinuousEngine(tcfg, SamplingParams(max_new_tokens=12, greedy=True),
                                attn_impl=attn_impl, device="cpu", **kw)
    tres = eng.rollout(tp, RolloutRequest(prompt_ids=prompts, max_new_tokens=budgets,
                                          answers=list("abcdefg")), torch.Generator())
    _hold_results(tres, jres)
    np.testing.assert_array_equal(tres.response_lengths, budgets)
    assert tres.answers == list("abcdefg")


def test_paged_engine_eos_and_page_backpressure_match_jax(engine_setup):
    jcfg, tcfg, jp, tp = engine_setup
    r = np.random.default_rng(1)
    prompts = [list(map(int, r.integers(1, 128, size=6))) for _ in range(6)]
    kw = dict(num_slots=2, max_seq_len=32, prompt_bucket=16, decode_chunk=4, page_size=8,
              num_pages=1 + 2 * 4)            # room for two slots only: pages are reused
    probe = JPagedEngine(jcfg, JSampling(max_new_tokens=8, greedy=True), **kw).generate(
        jp, JRequest(prompt_ids=prompts[:1]), jax.random.PRNGKey(0))
    eos = int(probe.response_ids[0, 3])       # a token greedy decode emits early
    jres = JPagedEngine(jcfg, JSampling(max_new_tokens=8, greedy=True, eos_token_id=eos),
                        **kw).generate(jp, JRequest(prompt_ids=prompts), jax.random.PRNGKey(1))
    tres = PagedContinuousEngine(
        tcfg, SamplingParams(max_new_tokens=8, greedy=True, eos_token_id=eos), device="cpu",
        **kw).generate(tp, RolloutRequest(prompt_ids=prompts), torch.Generator())
    _hold_results(tres, jres)
    assert tres.response_lengths.min() < 8


def test_paged_engine_needs_a_card_unless_cpu_is_asked(engine_setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg, _, tp = engine_setup
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedContinuousEngine(tcfg, SamplingParams(max_new_tokens=2))
    with pytest.raises(AssertionError):
        PagedContinuousEngine(tcfg, SamplingParams(max_new_tokens=2), prompt_bucket=12,
                              page_size=8, device="cpu")
