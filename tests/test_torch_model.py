"""The port's decoder (params, int8 quantization, prefill, packed decode
steps) against the JAX package on ``LLMConfig.tiny()``, on the CPU.

One JAX init feeds both sides through ``params_from_numpy``. fp32 model
outputs agree within 1e-4 (a few layers of fp32 summation-order noise).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlinf_tpu.models.llm import model as JM
from rlinf_tpu.models.llm.config import LLMConfig as JConfig
from rlinf_tpu.models.llm.quant import quantize_params as j_quantize_params
from rlinf_tpu_torch.models.llm import model as TM
from rlinf_tpu_torch.models.llm.config import LLMConfig as TConfig
from rlinf_tpu_torch.models.llm.convert import params_from_numpy
from rlinf_tpu_torch.models.llm.quant import QTensor, quantize_params

torch.set_num_threads(2)


def _configs(**kw):
    jcfg = dataclasses.replace(JConfig.tiny(), **kw)
    return jcfg, TConfig(**dataclasses.asdict(jcfg))


def _jax_params(jcfg, seed=0):
    """JAX init with non-zero qkv biases, so the bias path is exercised."""
    p = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    r = np.random.default_rng(seed)
    for name in ("bq", "bk", "bv"):
        b = p["blocks"][name]
        p["blocks"][name] = jnp.asarray(r.normal(size=b.shape) * 0.1, b.dtype)
    return p


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _prompts(cfg, B=3, S=10, seed=1):
    r = np.random.default_rng(seed)
    ids = r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lens = np.array([S, 4, 7][:B])
    mask = np.arange(S)[None, :] >= (S - lens)[:, None]
    return ids, mask


def _torch_leaves(tree):
    out = []
    for v in tree.values():
        if isinstance(v, dict):
            out += _torch_leaves(v)
        elif isinstance(v, QTensor):
            out += [v.q, v.scale]
        else:
            out.append(v)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_numpy_round_trip(dtype):
    jcfg, tcfg = _configs(dtype=dtype)
    jp = _jax_params(jcfg)
    tp = params_from_numpy(_to_numpy(jp), tcfg, device="cpu")
    assert tp["embed"].dtype == tcfg.compute_dtype
    jflat = jax.tree_util.tree_leaves(jp)
    assert len(jflat) == len(_torch_leaves(tp))
    for name, w in jp["blocks"].items():
        np.testing.assert_array_equal(_np(tp["blocks"][name]), _np(w))
    np.testing.assert_array_equal(_np(tp["embed"]), _np(jp["embed"]))
    # quantized leaves become the port's QTensor
    tq = params_from_numpy(_to_numpy(j_quantize_params(jp)), tcfg, device="cpu")
    assert isinstance(tq["lm_head"], QTensor) and tq["lm_head"].q.dtype == torch.int8
    with pytest.raises(ValueError):
        params_from_numpy(_to_numpy(jp), dataclasses.replace(tcfg, vocab_size=7), device="cpu")


def test_quantize_params_matches_jax():
    jcfg, tcfg = _configs()
    jp = _jax_params(jcfg)
    jq = _to_numpy(j_quantize_params(jp))
    tq = quantize_params(params_from_numpy(_to_numpy(jp), tcfg, device="cpu"))
    assert set(tq["blocks"]) == set(jq["blocks"])
    assert {"wqkv", "wgu"} <= set(tq["blocks"]) and "wq" not in tq["blocks"]
    pairs = [(tq["lm_head"], jq["lm_head"])] + [
        (tq["blocks"][k], jq["blocks"][k])
        for k in tq["blocks"] if isinstance(tq["blocks"][k], QTensor)
    ]
    for t, j in pairs:
        np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
        np.testing.assert_allclose(t.scale.numpy(), np.asarray(j.scale), rtol=1e-6)
    assert tq["lm_head"].q.is_contiguous()


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_forward_hidden_and_prefill_match_jax(attn_impl):
    jcfg, tcfg = _configs()
    jp = _jax_params(jcfg)
    tp = params_from_numpy(_to_numpy(jp), tcfg, device="cpu")
    ids, mask = _prompts(tcfg)
    jh, _ = JM.forward_hidden(jp, jcfg, jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    th, _ = TM.forward_hidden(tp, tcfg, torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                              attn_impl=attn_impl)
    valid = mask[..., None]
    np.testing.assert_allclose(_np(th) * valid, _np(jh) * valid, atol=1e-4)

    jlast, jcache = JM.prefill(jp, jcfg, jnp.asarray(ids), jnp.asarray(mask), 16)
    tlast, tcache = TM.prefill(tp, tcfg, torch.from_numpy(ids), torch.from_numpy(mask), 16,
                               attn_impl=attn_impl)
    np.testing.assert_allclose(_np(tlast), _np(jlast), atol=1e-4)
    assert tcache.k.shape == jcache.k.shape
    kvalid = np.concatenate([mask, np.zeros((3, 6), bool)], 1)[None, :, :, None, None]
    np.testing.assert_allclose(_np(tcache.k) * kvalid, _np(jcache.k) * kvalid, atol=1e-4)
    np.testing.assert_allclose(_np(tcache.v) * kvalid, _np(jcache.v) * kvalid, atol=1e-4)


def _decode_case(quant_weights):
    jcfg, tcfg = _configs()
    jp = _jax_params(jcfg)
    tp = params_from_numpy(_to_numpy(jp), tcfg, device="cpu")
    ids, mask = _prompts(tcfg)
    B, P = ids.shape
    _, jcache = JM.prefill(jp, jcfg, jnp.asarray(ids), jnp.asarray(mask), P + 4)
    if quant_weights:
        jp, tp = j_quantize_params(jp), quantize_params(tp)
    plen = mask.sum(-1).astype(np.int32)
    tok = np.array([5, 9, 1], np.int32)
    return jcfg, tcfg, jp, tp, jcache, tok, plen, P


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("quant_weights", [False, True])
def test_decode_step_packed_matches_jax(ragged, quant_weights):
    jcfg, tcfg, jp, tp, jcache, tok, plen, P = _decode_case(quant_weights)
    B = tok.shape[0]
    jlayers = JM.packed_cache_from_stacked(jcache)
    tlayers = tuple((torch.from_numpy(np.array(k)), torch.from_numpy(np.array(v)))
                    for k, v in jlayers)
    starts = (P - plen).astype(np.int32)
    wp = np.full((B,), P, np.int32) if ragged else P
    lengths = np.full((B,), P + 1, np.int32)
    jh, jnew = JM.decode_step_packed(jp, jcfg, jnp.asarray(tok), jlayers, jnp.asarray(wp),
                                     jnp.asarray(plen), jnp.asarray(starts), jnp.asarray(lengths),
                                     attn_impl="xla")
    th, tnew = TM.decode_step_packed(tp, tcfg, torch.from_numpy(tok), tlayers,
                                     torch.from_numpy(wp) if ragged else wp,
                                     torch.from_numpy(plen), torch.from_numpy(starts),
                                     torch.from_numpy(lengths), attn_impl="pallas")
    np.testing.assert_allclose(_np(th), _np(jh), atol=1e-4)
    assert tnew[0][0] is tlayers[0][0]  # written in place
    for (tk, tv), (jk, jv) in zip(tnew, jnew):
        np.testing.assert_allclose(_np(tk), _np(jk), atol=1e-4)
        np.testing.assert_allclose(_np(tv), _np(jv), atol=1e-4)


@pytest.mark.parametrize("ragged", [False, True])
def test_decode_step_packed_q8_matches_jax(ragged):
    jcfg, tcfg, jp, tp, jcache, tok, plen, P = _decode_case(False)
    B = tok.shape[0]
    jlayers = tuple(
        (lambda kq, ks, vq, vs: (kq, vq, ks, vs))(*JM.quantize_packed_kv(k), *JM.quantize_packed_kv(v))
        for k, v in JM.packed_cache_from_stacked(jcache))
    tlayers = tuple(tuple(torch.from_numpy(np.array(a)) for a in layer) for layer in jlayers)
    starts = (P - plen).astype(np.int32)
    wp = np.full((B,), P, np.int32) if ragged else P
    lengths = np.full((B,), P + 1, np.int32)
    jh, jnew = JM.decode_step_packed_q8(jp, jcfg, jnp.asarray(tok), jlayers, jnp.asarray(wp),
                                        jnp.asarray(plen), jnp.asarray(starts),
                                        jnp.asarray(lengths), attn_impl="xla")
    for impl in ("xla", "pallas"):
        layers = tuple(tuple(a.clone() for a in layer) for layer in tlayers)
        th, tnew = TM.decode_step_packed_q8(tp, tcfg, torch.from_numpy(tok), layers,
                                            torch.from_numpy(wp) if ragged else wp,
                                            torch.from_numpy(plen), torch.from_numpy(starts),
                                            torch.from_numpy(lengths), attn_impl=impl)
        np.testing.assert_allclose(_np(th), _np(jh), atol=1e-4)
        for tl, jl in zip(tnew, jnew):
            np.testing.assert_array_equal(tl[0].numpy(), np.asarray(jl[0]))
            np.testing.assert_array_equal(tl[1].numpy(), np.asarray(jl[1]))
            np.testing.assert_allclose(tl[2].numpy(), np.asarray(jl[2]), rtol=1e-5)
            np.testing.assert_allclose(tl[3].numpy(), np.asarray(jl[3]), rtol=1e-5)


def test_init_params_seeded_and_moe_rejected():
    _, tcfg = _configs()
    a = TM.init_params(tcfg, 3, device="cpu")
    b = TM.init_params(tcfg, 3, device="cpu")
    assert torch.equal(a["blocks"]["wq"], b["blocks"]["wq"])
    assert a["blocks"]["wq"].shape == (tcfg.num_layers, tcfg.hidden_size, tcfg.q_dim)
    assert "lm_head" not in a and a["blocks"]["bq"].abs().sum() == 0
    with pytest.raises(NotImplementedError):
        TM.init_params(dataclasses.replace(tcfg, num_experts=4), 0, device="cpu")
