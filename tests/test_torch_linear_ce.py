"""The port's lm-head logprob ops and the fused linear-CE autograd Function
(kernels K5/K6, here their plain versions) against the JAX package, on the
CPU.

Every input is drawn with numpy from a seed and handed to both sides. The
JAX Pallas kernel runs in interpret mode, as ``tests/test_linear_ce.py``
runs it. Tolerances: fp32 logprob paths agree within 1e-5 (summation order
only). The fused path rounds ``dz`` to bf16 on both sides; from the same
f32 inputs the two sides' ``dz`` can land on neighbouring bf16 values, so
gradients agree within 1e-3 relative to their largest entry, and the
forward within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlinf_tpu.models.llm import model as JM
from rlinf_tpu.models.llm.config import LLMConfig as JConfig
from rlinf_tpu.ops import logprobs as jlp
from rlinf_tpu.ops.pallas.linear_ce import fused_linear_ce as j_fused_ce
from rlinf_tpu_torch.models.llm.config import LLMConfig as TConfig
from rlinf_tpu_torch.models.llm.convert import params_from_numpy
from rlinf_tpu_torch.ops import logprobs as tlp
from rlinf_tpu_torch.ops.cuda import linear_ce as tce

torch.set_num_threads(2)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rel_close(got, want, rel):
    got, want = _np(got), _np(want)
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(got / scale, want / scale, atol=rel, rtol=0)


@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_logprobs_and_entropy_from_logits(temperature):
    r = np.random.default_rng(0)
    logits = (r.normal(size=(3, 5, 40)) * 3).astype(np.float32)
    ids = r.integers(0, 40, (3, 5)).astype(np.int32)
    got = tlp.logprobs_and_entropy_from_logits(_t(logits), _t(ids), temperature)
    want = jlp.logprobs_and_entropy_from_logits(jnp.asarray(logits), jnp.asarray(ids), temperature)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("S,chunk", [(12, 4), (10, 4)])
def test_fused_linear_logprobs_and_entropy_with_grads(S, chunk):
    """Chunked plain path (even chunks, and one chunk when S does not
    divide): values and gradients of a mixed loss for hidden and lm_head."""
    r = np.random.default_rng(1)
    B, D, V = 2, 16, 50
    h = r.normal(size=(B, S, D)).astype(np.float32)
    w = (r.normal(size=(D, V)) * 0.3).astype(np.float32)
    ids = r.integers(0, V, (B, S)).astype(np.int32)
    adv = r.normal(size=(B, S)).astype(np.float32)
    th, tw = _t(h).requires_grad_(True), _t(w).requires_grad_(True)
    lp, ent = tlp.fused_linear_logprobs_and_entropy(th, tw, _t(ids), chunk_size=chunk,
                                                     temperature=0.8)
    ((lp * _t(adv)).sum() + 0.1 * ent.sum()).backward()

    def jloss(h_, w_):
        a, b = jlp.fused_linear_logprobs_and_entropy(h_, w_, jnp.asarray(ids), chunk_size=chunk,
                                                     temperature=0.8)
        return jnp.sum(a * adv) + 0.1 * jnp.sum(b), (a, b)

    (_, (jlp_, jent)), (gh, gw) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(h), jnp.asarray(w))
    np.testing.assert_allclose(_np(lp), _np(jlp_), atol=1e-5)
    np.testing.assert_allclose(_np(ent), _np(jent), atol=1e-5)
    np.testing.assert_allclose(_np(th.grad), _np(gh), atol=1e-5)
    np.testing.assert_allclose(_np(tw.grad), _np(gw), atol=1e-5)


@pytest.mark.parametrize("w_layout", ["dv", "vd"])
@pytest.mark.parametrize("shape,temperature", [((2, 20, 32, 1500), 0.7), ((1, 40, 64, 1000), 1.0)])
def test_linear_ce_function_matches_pallas(w_layout, shape, temperature):
    """40 rows pad to the port's row block of 64 (and to the Pallas row
    block of 8); V = 1000 and 1500 are not multiples of either vocab tile."""
    B, S, D, V = shape
    r = np.random.default_rng(2)
    h = r.normal(size=(B, S, D)).astype(np.float32)
    w_dv = (r.normal(size=(D, V)) * 0.05).astype(np.float32)
    ids = r.integers(0, V, (B, S)).astype(np.int32)
    adv = r.normal(size=(B, S)).astype(np.float32)
    w = w_dv if w_layout == "dv" else np.ascontiguousarray(w_dv.T)

    th, tw = _t(h).requires_grad_(True), _t(w).requires_grad_(True)
    lp, ent = tce.fused_linear_ce(th, tw, _t(ids), temperature=temperature, w_layout=w_layout)
    ((lp * _t(adv)).mean() + 0.03 * ent.mean()).backward()

    def jloss(h_, w_):
        a, b = j_fused_ce(h_, w_, jnp.asarray(ids), temperature=temperature,
                          w_layout=w_layout, interpret=True)
        return jnp.mean(a * adv) + 0.03 * jnp.mean(b), (a, b)

    (_, (ja, jb)), (gh, gw) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(h), jnp.asarray(w))
    np.testing.assert_allclose(_np(lp), _np(ja), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(ent), _np(jb), atol=1e-5, rtol=1e-5)
    assert tw.grad.shape == tw.shape
    _rel_close(th.grad, gh, 1e-3)
    _rel_close(tw.grad, gw, 1e-3)


def test_linear_ce_chunks_rows_and_sums_weight_grads():
    """Rows above row_chunk run in chunks (the last one short); values and
    gradients equal one unchunked call."""
    r = np.random.default_rng(3)
    n, D, V = 150, 16, 300
    h = r.normal(size=(n, D)).astype(np.float32)
    w = (r.normal(size=(V, D)) * 0.1).astype(np.float32)
    ids = _t(r.integers(0, V, n).astype(np.int32))
    out = []
    for chunk in (64, 4096):
        th, tw = _t(h).requires_grad_(True), _t(w).requires_grad_(True)
        lp, ent = tce.fused_linear_ce(th, tw, ids, w_layout="vd", row_chunk=chunk)
        (lp.sum() + ent.sum()).backward()
        out.append((lp, ent, th.grad, tw.grad))
    for a, b in zip(*out):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-5)


def test_backward_plain_rounds_dz_to_bf16_and_pads_vocab():
    r = np.random.default_rng(4)
    n, D, V = 64, 8, 130
    h = _t(r.normal(size=(n, D)).astype(np.float32))
    w = _t((r.normal(size=(D, V)) * 0.2).astype(np.float32))
    tgt = _t(r.integers(0, V, n).astype(np.int32))
    lp, ent, lse = tce.ce_forward_plain(h, w, tgt, 1.0, "dv")
    g = _t(r.normal(size=n).astype(np.float32))
    dz, dh = tce.ce_backward_plain(h, w, tgt, lse, lse - ent, g, g, 1.0, "dv")
    assert dz.dtype == torch.bfloat16 and dz.shape == (n, 256)
    assert torch.all(dz[:, V:] == 0)
    np.testing.assert_allclose(_np(dh), _np(dz[:, :V].float() @ w.t()), atol=1e-5)


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_linear_logprobs_dispatch_matches_jax(impl):
    """The dispatcher on a tiny tied-embedding model: "auto" on the CPU runs
    the chunked plain path, "pallas" the fused Function's plain version."""
    jcfg = JConfig.tiny()
    tcfg = TConfig(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    r = np.random.default_rng(5)
    hidden = r.normal(size=(2, 8, jcfg.hidden_size)).astype(np.float32)
    ids = r.integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    got = tlp.linear_logprobs_and_entropy(tp, tcfg, _t(hidden), _t(ids), chunk_size=4, impl=impl)
    want = jlp.linear_logprobs_and_entropy(jp, jcfg, jnp.asarray(hidden), jnp.asarray(ids),
                                           chunk_size=4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-5)


# ---------------------------------------------------------------------------
# K6 pass B's plan: the vocabulary cut into slices whose f32 partials of
# dh = dz W are added in slice order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("V", [1000, 1500, 151936])
def test_vocab_slices_cover_the_padded_vocabulary_in_order(V):
    vp = tce._v_pad(V)
    n_kb = -(-vp // tce.VOCAB_BLOCK)
    counts = {1, 2, 3, 7, min(11, n_kb), n_kb, tce.dh_slices(4096, 1536, vp, 132),
              tce.dh_slices(64, 64, vp, 132)}
    for s in sorted(counts):
        cuts = tce.vocab_slices(vp, s)
        assert len(cuts) == s and cuts[0][0] == 0 and cuts[-1][1] == vp
        assert all(a < b for a, b in cuts)                          # none empty
        assert all(b == c for (_, b), (c, _) in zip(cuts, cuts[1:]))  # in order, no gap or overlap
        assert all(a % tce.VOCAB_BLOCK == 0 for a, _ in cuts)       # whole 64-blocks


def test_dh_slices_fill_whole_rounds_of_the_card():
    """At the training chunk (4096 rows, D = 1536, Qwen2-1.5B's vocabulary)
    on 132 SMs: 384 output tiles x 11 slices = 16 rounds of 264 consumers."""
    vp = tce._v_pad(151936)
    s = tce.dh_slices(4096, 1536, vp, 132)
    assert s == 11 and (384 * s) % (tce.CONSUMERS * 132) == 0
    for n, D, V, sms in ((64, 64, 1000, 132), (4096, 1536, 151936, 114), (320, 200, 1000, 8)):
        vp = tce._v_pad(V)
        s = tce.dh_slices(n, D, vp, sms)
        assert 1 <= s <= min(tce.MAX_SLICES, vp // tce.VOCAB_BLOCK)


@pytest.mark.parametrize("w_layout", ["vd", "dv"])
def test_slice_partials_in_order_give_the_plain_dh(w_layout):
    """The pass-B scheme on the CPU: f32 partials of dz W over the slices,
    added in slice order, equal the plain version's dh."""
    r = np.random.default_rng(6)
    n, D, V = 128, 24, 1000
    h = _t(r.normal(size=(n, D)).astype(np.float32))
    w = _t((r.normal(size=(V, D) if w_layout == "vd" else (D, V)) * 0.2).astype(np.float32))
    tgt = _t(r.integers(0, V, n).astype(np.int32))
    _, ent, lse = tce.ce_forward_plain(h, w, tgt, 1.0, w_layout)
    g = _t(r.normal(size=n).astype(np.float32))
    dz, dh = tce.ce_backward_plain(h, w, tgt, lse, lse - ent, g, 0.1 * g, 1.0, w_layout)
    wv = torch.nn.functional.pad(w if w_layout == "vd" else w.t(), (0, 0, 0, dz.shape[1] - V))
    acc = torch.zeros((n, D))
    for a, b in tce.vocab_slices(dz.shape[1], 5):
        acc += dz[:, a:b].float() @ wv[a:b]
    np.testing.assert_allclose(_np(acc), _np(dh), atol=1e-5, rtol=1e-5)


def test_k6_wrapper_and_source_agree_on_their_constants():
    import re

    from rlinf_tpu_torch.ops.cuda import _build

    text = (_build.CSRC / "linear_ce.cu").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
    assert const("GM") == const("GN") == tce.GEMM_TILE == tce.VOCAB_TILE
    assert const("GK") == tce.VOCAB_BLOCK and const("BM") == tce.ROW_BLOCK
    assert "n_slices > Vp / GK" in text       # the source refuses empty slices too


def test_backward_wrapper_goes_to_its_kernel_for_tensors_off_the_cpu(monkeypatch):
    def never(*a, **kw):
        raise AssertionError("the plain version was called for a tensor off the CPU")

    monkeypatch.setattr(tce, "ce_backward_plain", never)
    n, D, V = 64, 16, 40
    meta = dict(device="meta")
    h, w = torch.zeros((n, D), dtype=torch.bfloat16, **meta), torch.zeros((V, D), dtype=torch.bfloat16, **meta)
    tgt = torch.zeros((n,), dtype=torch.int32, **meta)
    f = torch.zeros((n,), **meta)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tce.ce_backward(h, w, tgt, f, f, f, f, 1.0, "vd")
    assert tce.KERNEL_BWD.launches == 0


@pytest.mark.parametrize("w_layout", ["vd", "dv"])
def test_depth_padding_gives_the_unpadded_backward(w_layout):
    """K6's wrapper zero-pads the depth to a multiple of 8 (TMA row strides
    are multiples of 16 bytes). Through the plain backward at D = 100: the
    padded run, with dh sliced back, equals the unpadded run (a zero depth
    column adds an exact 0 to every logit, so dz is bit-identical and dh
    agrees to float32 summation order, 1e-6 relative)."""
    r = np.random.default_rng(7)
    n, D, V = 64, 100, 300
    h = _t(r.normal(size=(n, D)).astype(np.float32))
    w = _t((r.normal(size=(V, D) if w_layout == "vd" else (D, V)) * 0.2).astype(np.float32))
    tgt = _t(r.integers(0, V, n).astype(np.int32))
    _, ent, lse = tce.ce_forward_plain(h, w, tgt, 1.0, w_layout)
    g = _t(r.normal(size=n).astype(np.float32))
    hp, wp = tce.pad_depth(h, w, w_layout)
    assert hp.shape == (n, 104) and wp.shape == ((V, 104) if w_layout == "vd" else (104, V))
    assert torch.all(hp[:, D:] == 0) and torch.all((wp[:, D:] if w_layout == "vd" else wp[D:]) == 0)
    dz, dh = tce.ce_backward_plain(h, w, tgt, lse, lse - ent, g, 0.1 * g, 1.0, w_layout)
    dzp, dhp = tce.ce_backward_plain(hp, wp, tgt, lse, lse - ent, g, 0.1 * g, 1.0, w_layout)
    np.testing.assert_array_equal(_np(dzp), _np(dz))
    _rel_close(dhp[:, :D], dh, 1e-6)
    assert tce.pad_depth(hp, wp, w_layout)[0] is hp      # a multiple of 8 is left as it is
