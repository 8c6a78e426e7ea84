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
    """40 rows fill part of the port's 128-row tile (and pad to the Pallas
    row block of 8); V = 1000 and 1500 are not multiples of either vocab
    tile."""
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
    """K5 and K6 share the tiles of one mainloop: the wrapper's tile, depth
    block and combine segments are the source's, K5's partials are one per
    vocabulary tile, and no row block of the source remains (the kernels
    mask rows past n in their 128-row tiles)."""
    import re

    from rlinf_tpu_torch.ops.cuda import _build

    text = (_build.CSRC / "linear_ce.cu").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
    assert const("GM") == const("GN") == tce.GEMM_TILE == tce.VOCAB_TILE
    assert const("GK") == tce.VOCAB_BLOCK
    assert const("COMBINE_SEGS") == tce.COMBINE_SEGMENTS
    assert "constexpr int BM" not in text and "mma.sync" not in text
    assert "(V + GN - 1) / GN" in text        # K5: one partial per vocabulary tile
    assert "n_slices > Vp / GK" in text       # the source refuses empty slices too


def test_forward_wrapper_goes_to_its_kernel_for_tensors_off_the_cpu(monkeypatch):
    def never(*a, **kw):
        raise AssertionError("the plain version was called for a tensor off the CPU")

    monkeypatch.setattr(tce, "ce_forward_plain", never)
    n, D, V = 64, 16, 40
    meta = dict(device="meta")
    h, tgt = torch.zeros((n, D), dtype=torch.bfloat16, **meta), torch.zeros((n,), dtype=torch.int32, **meta)
    for w_layout, shape in (("vd", (V, D)), ("dv", (D, V))):
        w = torch.zeros(shape, dtype=torch.bfloat16, **meta)
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            tce.ce_forward(h, w, tgt, 1.0, w_layout)
    assert tce.KERNEL_FWD.launches == 0


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


# ---------------------------------------------------------------------------
# K5's scheme: per-tile statistics, merged in the combine's order
# ---------------------------------------------------------------------------

def _merge(a, b):
    """csrc merge(): two (m, s1, s2, tl) row statistics as one."""
    m = torch.maximum(a[0], b[0])
    ea, eb = torch.exp(a[0] - m), torch.exp(b[0] - m)
    return m, a[1] * ea + b[1] * eb, a[2] * ea + b[2] * eb, a[3] + b[3]


def _k5_emulated(h, w, tgt, inv_temp, w_layout):
    """K5 on the CPU by its scheme: each 128-column tile's statistics of
    every row (pad columns past V left out), merged in the combine's order
    (``combine_segments``: each segment's tiles in order from the identity,
    then the segments in order) -> (lp, ent, lse)."""
    x = tce._logits_plain(h, w, w_layout, inv_temp)
    n, V = x.shape
    tiles = []
    for c0 in range(0, V, tce.VOCAB_TILE):
        xt = x[:, c0:c0 + tce.VOCAB_TILE]
        m = xt.max(-1).values
        e = torch.exp(xt - m[:, None])
        hit = (tgt.long()[:, None] == torch.arange(c0, c0 + xt.shape[1])[None, :])
        tiles.append((m, e.sum(-1), (e * xt).sum(-1), (xt * hit).sum(-1)))
    ident = (torch.full((n,), -2.0**30), torch.zeros(n), torch.zeros(n), torch.zeros(n))
    segs = []
    for a, b in tce.combine_segments(len(tiles)):
        st = ident
        for t in tiles[a:b]:
            st = _merge(st, t)
        segs.append(st)
    st = segs[0]
    for seg in segs[1:]:
        st = _merge(st, seg)
    m, s1, s2, tl = st
    lse = m + torch.log(s1.clamp_min(1e-30))
    return tl - lse, lse - s2 / s1.clamp_min(1e-30), lse


@pytest.mark.parametrize("n_tiles", [1, 3, 8, 9, 1187])
def test_combine_segments_cover_the_tiles_in_order(n_tiles):
    segs = tce.combine_segments(n_tiles)
    assert len(segs) == tce.COMBINE_SEGMENTS and segs[0][0] == 0 and segs[-1][1] == n_tiles
    assert all(a <= b for a, b in segs)
    assert all(b == c for (_, b), (c, _) in zip(segs, segs[1:]))


@pytest.mark.parametrize("temperature", [1.0, 1.3])
@pytest.mark.parametrize("w_layout", ["vd", "dv"])
def test_forward_tile_partials_merged_in_order_give_the_plain_and_pallas_forward(
        w_layout, temperature):
    """K5's tile statistics merged as its combine merges them equal the
    plain forward (1e-5 relative) and the JAX package's fused_linear_ce in
    interpret mode (lp and entropy, 1e-5), at n = 128, D = 24, V = 1000 (8
    tiles, the last one partial)."""
    r = np.random.default_rng(8)
    n, D, V = 128, 24, 1000
    h = r.normal(size=(n, D)).astype(np.float32)
    w_dv = (r.normal(size=(D, V)) * 0.3).astype(np.float32)
    w = w_dv if w_layout == "dv" else np.ascontiguousarray(w_dv.T)
    tgt = r.integers(0, V, n).astype(np.int32)
    tgt[-1] = V - 1                                     # a target in the partial last tile
    got = _k5_emulated(_t(h), _t(w), _t(tgt), 1.0 / temperature, w_layout)
    plain = tce.ce_forward_plain(_t(h), _t(w), _t(tgt), 1.0 / temperature, w_layout)
    for g_, p_ in zip(got, plain):
        _rel_close(g_, p_, 1e-5)
    ja, jb = j_fused_ce(jnp.asarray(h), jnp.asarray(w), jnp.asarray(tgt), temperature=temperature,
                        w_layout=w_layout, interpret=True)
    np.testing.assert_allclose(_np(got[0]), _np(ja), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(got[1]), _np(jb), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("w_layout", ["vd", "dv"])
def test_depth_padding_gives_the_unpadded_forward(w_layout):
    """K5's wrapper pads the depth to a multiple of 8 and copies an untied
    weight with V % 8 != 0 into rows of a multiple of 8 (``_tma_operands``),
    as K6's does. Through the plain forward at D = 100, V = 301: the padded
    operands give the unpadded forward (a zero depth column adds an exact 0
    to every logit: bit-identical), and the untied weight's pad columns lie
    past the V columns the kernel reads."""
    r = np.random.default_rng(9)
    n, D, V = 64, 100, 301
    h = _t(r.normal(size=(n, D)).astype(np.float32))
    w = _t((r.normal(size=(V, D) if w_layout == "vd" else (D, V)) * 0.2).astype(np.float32))
    tgt = _t(r.integers(0, V, n).astype(np.int32))
    hp, wp = tce._tma_operands(h, w, w_layout, V)
    assert hp.shape == (n, 104)
    assert wp.shape == ((V, 104) if w_layout == "vd" else (104, 304))
    want = tce.ce_forward_plain(h, w, tgt, 1.0, w_layout)
    got = tce.ce_forward_plain(hp, wp if w_layout == "vd" else wp[:, :V], tgt, 1.0, w_layout)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), _np(b))
    if w_layout == "dv":
        assert torch.all(wp[:, V:] == 0) and torch.all(wp[D:] == 0)
