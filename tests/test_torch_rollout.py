"""The port's static rollout path (generate, RolloutEngine) and the engine
selection of ``build_rollout_engine`` against the JAX package on ``LLMConfig.tiny()``, on the CPU.

The port runs with the kernel implementation names ("pallas"), which on CPU
tensors take the plain versions; the JAX side runs its XLA decode path (its
Pallas decode kernels take no interpret flag there). Greedy tokens must be
equal and logprobs agree within 1e-4 (fp32, summation order only).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlinf_tpu.data.io_struct import RolloutRequest as JRequest
from rlinf_tpu.models.llm import model as JM
from rlinf_tpu.models.llm.config import LLMConfig as JConfig
from rlinf_tpu.models.llm.quant import quantize_params as j_quantize_params
from rlinf_tpu.models.llm.sampler import SamplingParams as JSampling
from rlinf_tpu.models.llm.sampler import generate as j_generate
from rlinf_tpu.rollout.engine import RolloutEngine as JEngine
from rlinf_tpu_torch.config import RolloutConfig
from rlinf_tpu_torch.data.io_struct import RolloutRequest
from rlinf_tpu_torch.models.llm.config import LLMConfig as TConfig
from rlinf_tpu_torch.models.llm.convert import params_from_numpy
from rlinf_tpu_torch.models.llm.quant import quantize_params
from rlinf_tpu_torch.models.llm.sampler import SamplingParams, generate
from rlinf_tpu_torch.rollout import (
    RolloutEngine, build_rollout_engine, resolve_recompute_logprobs, resolve_rollout_paths,
)
from rlinf_tpu_torch.rollout.continuous_engine import ContinuousBatchingEngine
from rlinf_tpu_torch.rollout.paged_engine import PagedContinuousEngine

torch.set_num_threads(2)

B, P, N = 3, 16, 6


def _setup(seed=0):
    jcfg = JConfig.tiny()
    tcfg = TConfig(**dataclasses.asdict(jcfg))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    r = np.random.default_rng(seed)
    ids = r.integers(1, tcfg.vocab_size, (B, P)).astype(np.int32)
    lens = np.array([P, 5, 11])
    mask = np.arange(P)[None, :] >= (P - lens)[:, None]
    ids = np.where(mask, ids, 0).astype(np.int32)
    return jcfg, tcfg, jp, tp, ids, mask


def _jax_generate(jcfg, jp, ids, mask, sp, weight_quant, kv_quant):
    dparams = j_quantize_params(jp) if weight_quant == "int8" else None
    out = j_generate(jp, jcfg, jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask), sp,
                     decode_params=dparams, decode_attn_impl="xla", kv_quant=kv_quant)
    return (np.asarray(out.response_ids), np.asarray(out.response_logprobs),
            np.asarray(out.response_mask))


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("weight_quant", ["none", "int8"])
def test_greedy_generate_matches_jax(weight_quant, kv_quant):
    jcfg, tcfg, jp, tp, ids, mask = _setup()
    jsp = JSampling(max_new_tokens=N, greedy=True)
    jt, jl, jm = _jax_generate(jcfg, jp, ids, mask, jsp, weight_quant, kv_quant)
    out = generate(tp, tcfg, torch.Generator().manual_seed(0), ids, mask,
                   SamplingParams(max_new_tokens=N, greedy=True), attn_impl="pallas",
                   decode_params=quantize_params(tp) if weight_quant == "int8" else None,
                   decode_attn_impl="pallas", kv_quant=kv_quant, device="cpu")
    np.testing.assert_array_equal(out.response_ids.numpy(), jt)
    np.testing.assert_allclose(out.response_logprobs.numpy(), jl, atol=1e-4)
    np.testing.assert_array_equal(out.response_mask.numpy(), jm)
    assert out.response_ids.shape == (B, N) and out.response_ids.dtype == torch.int32


def test_greedy_generate_eos_masking_matches_jax():
    jcfg, tcfg, jp, tp, ids, mask = _setup(1)
    jt, _, _ = _jax_generate(jcfg, jp, ids, mask, JSampling(max_new_tokens=N, greedy=True),
                             "none", "none")
    eos = int(jt[0, 2])  # row 0 stops by its third token
    jt, jl, jm = _jax_generate(jcfg, jp, ids, mask,
                               JSampling(max_new_tokens=N, greedy=True, eos_token_id=eos),
                               "none", "none")
    out = generate(tp, tcfg, torch.Generator(), ids, mask,
                   SamplingParams(max_new_tokens=N, greedy=True, eos_token_id=eos), device="cpu")
    np.testing.assert_array_equal(out.response_ids.numpy(), jt)
    np.testing.assert_array_equal(out.response_mask.numpy(), jm)
    np.testing.assert_allclose(out.response_logprobs.numpy(), jl, atol=1e-4)
    assert 1 <= out.response_lengths[0] <= 3


def test_sampled_fused_and_plain_paths_draw_the_same_tokens():
    """One seed per step from the generator keys the same Philox noise in
    the fused sampler and the plain logits path."""
    _, tcfg, _, tp, ids, mask = _setup(2)
    qp = quantize_params(tp)
    sp = SamplingParams(max_new_tokens=N, temperature=0.8)
    runs = [
        generate(tp, tcfg, torch.Generator().manual_seed(7), ids, mask, sp, decode_params=qp,
                 sampler_impl=impl, device="cpu")
        for impl in ("fused", "xla")
    ]
    np.testing.assert_array_equal(runs[0].response_ids.numpy(), runs[1].response_ids.numpy())
    np.testing.assert_allclose(runs[0].response_logprobs.numpy(),
                               runs[1].response_logprobs.numpy(), atol=1e-5)
    assert (runs[0].response_logprobs <= 0).all()


def test_rollout_engine_matches_jax():
    jcfg, tcfg, jp, tp, _, _ = _setup(3)
    r = np.random.default_rng(3)
    prompts = [list(r.integers(1, tcfg.vocab_size, n)) for n in (3, 9, 14)]
    jeng = JEngine(jcfg, JSampling(max_new_tokens=N, greedy=True), prompt_bucket=8,
                   weight_quant="int8")
    jres = jeng.rollout(jp, JRequest(prompt_ids=prompts), jax.random.PRNGKey(0))
    teng = RolloutEngine(tcfg, SamplingParams(max_new_tokens=N, greedy=True), prompt_bucket=8,
                         attn_impl="pallas", decode_attn_impl="pallas", weight_quant="int8",
                         device="cpu")
    tres = teng.rollout(tp, RolloutRequest(prompt_ids=prompts, answers=["a", "b", "c"]),
                        torch.Generator())
    np.testing.assert_array_equal(tres.prompt_ids, jres.prompt_ids)
    np.testing.assert_array_equal(tres.prompt_mask, jres.prompt_mask)
    np.testing.assert_array_equal(tres.response_ids, jres.response_ids)
    np.testing.assert_allclose(tres.response_logprobs, jres.response_logprobs, atol=1e-4)
    assert tres.answers == ["a", "b", "c"]
    with pytest.raises(NotImplementedError):
        teng.rollout(tp, RolloutRequest(prompt_ids=prompts), torch.Generator(), mesh=object())


def _trainer_cfg(**rollout):
    return types.SimpleNamespace(
        model=TConfig.tiny(), sampling=SamplingParams(max_new_tokens=4),
        rollout=RolloutConfig(**rollout), attn_impl="xla",
        data=types.SimpleNamespace(max_prompt_len=32),
        algorithm=types.SimpleNamespace(recompute_logprobs=None),
    )


def test_build_rollout_engine_resolves_on_the_device():
    eng = build_rollout_engine(_trainer_cfg(engine="static"), device="cpu")
    assert isinstance(eng, RolloutEngine) and eng.weight_quant == "none"
    assert resolve_rollout_paths(_trainer_cfg(engine="static"), device="cuda") == (
        "static", "int8", "pallas")
    assert resolve_rollout_paths(_trainer_cfg(engine="static"), device="cpu") == (
        "static", "none", "xla")
    assert resolve_rollout_paths(_trainer_cfg(), device="cpu")[0] == "continuous"
    assert resolve_recompute_logprobs(_trainer_cfg(engine="static"), device="cuda")
    assert not resolve_recompute_logprobs(_trainer_cfg(engine="static"), device="cpu")
    for engine in ("auto", "continuous"):
        eng = build_rollout_engine(
            _trainer_cfg(engine=engine, kv_quant="int8", num_slots=8, decode_chunk=4),
            device="cpu")
        assert type(eng) is ContinuousBatchingEngine
        assert (eng.num_slots, eng.decode_chunk, eng.prompt_bucket) == (8, 4, 64)
        assert (eng.weight_quant, eng.kv_quant, eng.attn_impl) == ("none", "int8", "xla")
        assert eng.max_seq_len == 32 + 4 and eng.use_mega is False and eng.compact
    eng = build_rollout_engine(_trainer_cfg(engine="paged", page_size=8, num_slots=4),
                               device="cpu")
    assert type(eng) is PagedContinuousEngine
    assert (eng.page_size, eng.num_slots, eng.attn_impl) == (8, 4, "xla")
    assert eng.max_pages_per_slot == 5 and eng.num_pages == 1 + 4 * 5
    for engine in ("static", "auto", "paged"):
        with pytest.raises(NotImplementedError):
            build_rollout_engine(_trainer_cfg(engine=engine), mesh=object(), device="cpu")
    with pytest.raises(ValueError):
        build_rollout_engine(_trainer_cfg(engine="bogus"), device="cpu")


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg, _, tp, ids, mask = _setup()
    sp = SamplingParams(max_new_tokens=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RolloutEngine(tcfg, sp)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(tp, tcfg, torch.Generator(), ids, mask, sp)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_rollout_engine(_trainer_cfg(engine="static"))
    for engine in ("auto", "paged"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_rollout_engine(_trainer_cfg(engine=engine))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(tp, tcfg, torch.Generator(), ids, mask, sp, kv_quant="int8", mega=object())
