"""The port's ops and the plain versions of its kernels against the JAX
package, on the CPU at small sizes.

Every input is drawn with numpy from a seed and handed to both sides. The
JAX Pallas kernels run in interpret mode, as the JAX package's own tests
run them. Tolerances: fp32 on both sides agrees to 1e-5 (summation order
only); the bf16 cases state their own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlinf_tpu.ops import attention as jattn
from rlinf_tpu.ops.norm import rms_norm as j_rms_norm
from rlinf_tpu.ops.pallas import decode_attention as jdec
from rlinf_tpu.ops.pallas.flash_attention import flash_attention as j_flash
from rlinf_tpu.ops.pallas.sampler_kernel import fused_lmhead_sample as j_sample
from rlinf_tpu.ops.rope import apply_rope as j_apply_rope
from rlinf_tpu.ops.rope import rope_frequencies as j_rope_frequencies
from rlinf_tpu_torch.models.llm.quant import quantize_tensor
from rlinf_tpu_torch.ops import attention as tattn
from rlinf_tpu_torch.ops.cuda import decode_attention as tdec
from rlinf_tpu_torch.ops.cuda import flash_attention as tflash
from rlinf_tpu_torch.ops.cuda import sampler_kernel as tsamp
from rlinf_tpu_torch.ops.norm import rms_norm
from rlinf_tpu_torch.ops.rope import apply_rope, rope_frequencies

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _left_padded(r, B, S):
    """(positions, valid) of left-padded rows, lengths in [1, S], one full."""
    lens = r.integers(1, S + 1, B)
    lens[0] = S
    valid = np.arange(S)[None, :] >= (S - lens)[:, None]
    pos = np.maximum(np.cumsum(valid, -1) - 1, 0).astype(np.int32)
    return pos, valid


def test_rms_norm_matches_jax():
    r = np.random.default_rng(0)
    x = r.normal(size=(3, 5, 32)).astype(np.float32)
    w = r.normal(size=(32,)).astype(np.float32)
    got = rms_norm(_t(x), _t(w), 1e-6)
    np.testing.assert_allclose(_np(got), _np(j_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)),
                               atol=1e-5, rtol=1e-5)


def test_rope_matches_jax():
    r = np.random.default_rng(1)
    B, S, H, K, D = 2, 7, 4, 2, 16
    q = r.normal(size=(B, S, H, D)).astype(np.float32)
    k = r.normal(size=(B, S, K, D)).astype(np.float32)
    pos = r.integers(0, 64, (B, S)).astype(np.int32)
    cos, sin = rope_frequencies(D, 64, 1e4)
    jcos, jsin = j_rope_frequencies(D, 64, 1e4)
    np.testing.assert_allclose(_np(cos), _np(jcos), atol=1e-5)
    np.testing.assert_allclose(_np(sin), _np(jsin), atol=1e-5)
    tq, tk = apply_rope(_t(q), _t(k), cos, sin, _t(pos).long())
    jq, jk = j_apply_rope(jnp.asarray(q), jnp.asarray(k), jcos, jsin, jnp.asarray(pos))
    np.testing.assert_allclose(_np(tq), _np(jq), atol=1e-5)
    np.testing.assert_allclose(_np(tk), _np(jk), atol=1e-5)


@pytest.mark.parametrize("H,K", [(4, 4), (4, 2), (6, 1)])
def test_causal_attention_xla_matches_jax(H, K):
    r = np.random.default_rng(2)
    B, S, D = 3, 12, 16
    q = r.normal(size=(B, S, H, D)).astype(np.float32)
    k = r.normal(size=(B, S, K, D)).astype(np.float32)
    v = r.normal(size=(B, S, K, D)).astype(np.float32)
    pos, valid = _left_padded(r, B, S)
    got = tattn.causal_attention(_t(q), _t(k), _t(v), positions_q=_t(pos), positions_kv=_t(pos),
                                 kv_valid_mask=_t(valid))
    want = jattn.causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  positions_q=jnp.asarray(pos), positions_kv=jnp.asarray(pos),
                                  kv_valid_mask=jnp.asarray(valid))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


def test_causal_attention_rejects_ring_and_unknown():
    """Without a mesh "ring" takes the plain path, in the port as in the JAX
    package (same result within 1e-5); an unknown impl raises."""
    r = np.random.default_rng(14)
    q = r.normal(size=(2, 6, 4, 8)).astype(np.float32)
    k = r.normal(size=(2, 6, 2, 8)).astype(np.float32)
    v = r.normal(size=(2, 6, 2, 8)).astype(np.float32)
    got = tattn.causal_attention(_t(q), _t(k), _t(v), impl="ring")
    want = jattn.causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), impl="ring")
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)
    np.testing.assert_array_equal(_np(got), _np(tattn.causal_attention(_t(q), _t(k), _t(v))))
    x = torch.zeros(1, 2, 2, 4)
    with pytest.raises(ValueError):
        tattn.causal_attention(x, x, x, impl="nope")


def test_decode_attention_matches_jax():
    r = np.random.default_rng(3)
    B, S, H, K, D = 2, 9, 4, 2, 8
    q = r.normal(size=(B, 1, H, D)).astype(np.float32)
    kc = r.normal(size=(B, S, K, D)).astype(np.float32)
    vc = r.normal(size=(B, S, K, D)).astype(np.float32)
    valid = r.random((B, S)) < 0.7
    valid[:, 0] = True
    got = tattn.decode_attention(_t(q), _t(kc), _t(vc), _t(valid))
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(valid))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


# --- K1: flash attention forward --------------------------------------------

@pytest.mark.parametrize("H,K,S", [(4, 2, 32), (2, 2, 40)])
def test_flash_plain_matches_pallas_left_padding(H, K, S):
    """Every row here has a valid key (left padding keeps position 0), the
    only rows where the kernel and the Pallas kernel are defined alike."""
    r = np.random.default_rng(4)
    B, D = 3, 16
    q = r.normal(size=(B, S, H, D)).astype(np.float32)
    k = r.normal(size=(B, S, K, D)).astype(np.float32)
    v = r.normal(size=(B, S, K, D)).astype(np.float32)
    pos, valid = _left_padded(r, B, S)
    got = tflash.flash_attention(_t(q), _t(k), _t(v), positions_q=_t(pos), positions_kv=_t(pos),
                                 kv_valid_mask=_t(valid))
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), positions_q=jnp.asarray(pos),
                   positions_kv=jnp.asarray(pos), kv_valid_mask=jnp.asarray(valid),
                   block_q=16, block_k=16)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)
    xla = tattn.causal_attention(_t(q), _t(k), _t(v), positions_q=_t(pos), positions_kv=_t(pos),
                                 kv_valid_mask=_t(valid), impl="pallas")
    np.testing.assert_allclose(_np(xla), _np(want), atol=1e-5)


@pytest.mark.parametrize("B,S,H,K,D,block", [(2, 100, 14, 2, 64, 64), (2, 70, 12, 2, 128, 32)])
def test_flash_plain_matches_pallas_at_kernel_head_dims(B, S, H, K, D, block):
    """At the head dims the kernels take: Hd=64 with G=7 (Qwen2-0.5B's
    heads) and Hd=128 with G=6, with S not a multiple of the Pallas blocks
    (the JAX wrapper pads the tail, K1 masks its ragged tile), left-padded
    rows. fp32 on both sides: 1e-5."""
    r = np.random.default_rng(9)
    q = r.normal(size=(B, S, H, D)).astype(np.float32)
    k = r.normal(size=(B, S, K, D)).astype(np.float32)
    v = r.normal(size=(B, S, K, D)).astype(np.float32)
    pos, valid = _left_padded(r, B, S)
    got = tflash.flash_attention(_t(q), _t(k), _t(v), positions_q=_t(pos), positions_kv=_t(pos),
                                 kv_valid_mask=_t(valid))
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), positions_q=jnp.asarray(pos),
                   positions_kv=jnp.asarray(pos), kv_valid_mask=jnp.asarray(valid),
                   block_q=block, block_k=block)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


def test_flash_plain_lse_and_bf16():
    """lse equals logsumexp of the masked scores; in bf16 the output agrees
    with the fp32 plain version within 2e-2 (one bf16 rounding of q, k, v
    and of the output)."""
    r = np.random.default_rng(5)
    B, S, H, K, D = 2, 16, 4, 2, 16
    q = r.normal(size=(B, S, H, D)).astype(np.float32)
    k = r.normal(size=(B, S, K, D)).astype(np.float32)
    v = r.normal(size=(B, S, K, D)).astype(np.float32)
    pos, valid = _left_padded(r, B, S)
    args = (_t(pos).int(), _t(pos).int(), _t(valid).to(torch.uint8), D**-0.5)
    o, lse = tflash.flash_attention_fwd(_t(q), _t(k), _t(v), *args)
    s = np.einsum("bqhd,bshd->bhqs", q, np.repeat(k, H // K, axis=2)) * D**-0.5
    mask = (pos[:, None, :] <= pos[:, :, None]) & valid[:, None, :]
    s = np.where(mask[:, None], s, -np.inf)
    want_lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5)
    ob, _ = tflash.flash_attention_fwd(_t(q).bfloat16(), _t(k).bfloat16(), _t(v).bfloat16(), *args)
    assert ob.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(ob), _np(o), atol=2e-2)


# --- K7 / K8: flash attention backward -----------------------------------------

def _right_padded(r, B, S):
    """(positions, valid) as build_train_batch lays rows out: pads at the
    right repeat the last valid position."""
    lens = r.integers(1, S + 1, B)
    lens[0] = S
    valid = np.arange(S)[None, :] < lens[:, None]
    pos = np.maximum(np.cumsum(valid, -1) - 1, 0).astype(np.int32)
    return pos, valid


# (row layout, S, D) of each case; the Pallas kernels run blocks of 16.
# "hd64" is Qwen2-0.5B's head width; "s48" holds the plain backward against
# the Pallas kernel at S=48 with blocks of 16. On the CPU the port runs its
# plain version, so the CUDA tiles' ragged edges are checked on the card
# (chip_smoke.py, flash_bwd_ragged), not here.
_FLASH_BWD_CASES = {"left": ("left", 64, 16), "right": ("right", 64, 16),
                    "masked_row": ("masked_row", 64, 16), "hd64": ("right", 64, 64),
                    "s48": ("left", 48, 16)}


@pytest.mark.parametrize("padding", ["left", "right", "masked_row", "hd64", "s48"])
def test_flash_backward_matches_jax_grad(padding):
    """The autograd Function (K1 forward, K7/K8 backward; here their plain
    versions) against jax.grad through the Pallas flash attention in
    interpret mode: GQA (H=4, K=2), fp32, a random cotangent; S=64 and
    D=16 unless the case says otherwise (``_FLASH_BWD_CASES``).

    "masked_row" gives row 2 no valid key at all: there K1 gives 0 and the
    Pallas forward the mean of the visited values, so outputs are compared
    only at rows with a valid key; both backwards mask p before the
    exponent, so such a row adds no gradient and gradients agree
    everywhere. In every case outputs agree within 1e-5 and gradients (up
    to ~20 in size) within 1e-5 absolute plus 1e-5 relative."""
    layout, S, D = _FLASH_BWD_CASES[padding]
    r = np.random.default_rng(15)
    B, H, K = 3, 4, 2
    q = r.normal(size=(B, S, H, D)).astype(np.float32)
    k = r.normal(size=(B, S, K, D)).astype(np.float32)
    v = r.normal(size=(B, S, K, D)).astype(np.float32)
    cot = r.normal(size=(B, S, H, D)).astype(np.float32)
    pos, valid = (_left_padded if layout == "left" else _right_padded)(r, B, S)
    if layout == "masked_row":
        valid[2] = False
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    o = tflash.flash_attention(tq, tk, tv, positions_q=_t(pos), positions_kv=_t(pos),
                               kv_valid_mask=_t(valid))
    (o * _t(cot)).sum().backward()

    def loss(q_, k_, v_):
        o_ = j_flash(q_, k_, v_, positions_q=jnp.asarray(pos), positions_kv=jnp.asarray(pos),
                     kv_valid_mask=jnp.asarray(valid), block_q=16, block_k=16)
        return jnp.sum(o_ * cot), o_

    (_, jo), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    rows = valid.any(-1)
    np.testing.assert_allclose(_np(o.detach())[rows], _np(jo)[rows], atol=1e-5)
    for got, want in zip((tq.grad, tk.grad, tv.grad), grads):
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


def test_flash_backward_plain_bf16_against_fp32():
    """bf16 inputs: the plain backward computes in fp32 and casts dq, dk, dv
    once, so it lies within 3e-2 of the fp32 gradients (one bf16 rounding of
    the inputs and of the outputs, at gradients of size ~1-5)."""
    r = np.random.default_rng(16)
    B, S, H, K, D = 2, 32, 4, 2, 16
    q, k, v, do = (r.normal(size=(B, S, n, D)).astype(np.float32) for n in (H, K, K, H))
    pos, valid = _right_padded(r, B, S)
    meta = (_t(pos).int(), _t(pos).int(), _t(valid).to(torch.uint8))
    outs = []
    for dt in (torch.float32, torch.bfloat16):
        a = [_t(x).to(dt) for x in (q, k, v)]
        o, lse = tflash.flash_attention_fwd(*a, *meta, D**-0.5)
        outs.append(tflash.flash_attention_bwd(*a, *meta, o, lse, _t(do).to(dt), D**-0.5))
        np.testing.assert_array_equal(
            _np(outs[-1][0]),
            _np(tflash.flash_attention_bwd_plain(*a, *meta, o, lse, _t(do).to(dt), D**-0.5)[0]))
    for g32, g16 in zip(*outs):
        assert g16.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(g16), _np(g32), atol=3e-2, rtol=3e-2)


# --- K2 / K3: packed decode attention -----------------------------------------

def _decode_inputs(seed, B=4, S=24, H=4, Kv=2, Hd=16):
    r = np.random.default_rng(seed)
    q = r.normal(size=(B, H, Hd)).astype(np.float32)
    k = (r.normal(size=(B, S, Kv * Hd)) * 0.5).astype(np.float32)
    v = (r.normal(size=(B, S, Kv * Hd)) * 0.5).astype(np.float32)
    starts = np.array([0, 5, 3, 10], np.int32)[:B]
    lengths = np.array([S, 17, 3, 11], np.int32)[:B]   # row 2 is empty
    return q, k, v, starts, lengths, Kv


def test_decode_packed_plain_matches_pallas_and_oracle():
    q, k, v, st, ln, Kv = _decode_inputs(6)
    got = tdec.decode_attention_packed(_t(q), _t(k), _t(v), _t(st), _t(ln), num_kv=Kv)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(st), jnp.asarray(ln))
    want = jdec.decode_attention_packed(*args, num_kv=Kv, block_size=8, block_rows=2, interpret=True)
    oracle = jdec.decode_attention_packed_xla(*args, num_kv=Kv)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=1e-5)
    assert np.all(_np(got)[2] == 0.0)  # empty interval -> 0


def test_decode_packed_q8_plain_matches_pallas_and_oracle():
    q, k, v, st, ln, Kv = _decode_inputs(7)
    kq, ks = tdec.quantize_kv_token(_t(k))
    vq, vs = tdec.quantize_kv_token(_t(v))
    got = tdec.decode_attention_packed_q8(_t(q), kq, vq, ks, vs, _t(st), _t(ln), num_kv=Kv)
    jargs = (jnp.asarray(q), jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()),
             jnp.asarray(ks.numpy()), jnp.asarray(vs.numpy()), jnp.asarray(st), jnp.asarray(ln))
    want = jdec.decode_attention_packed_q8(*jargs, num_kv=Kv, block_size=8, block_rows=2,
                                           interpret=True)
    oracle = jdec.decode_attention_packed_q8_xla(*jargs, num_kv=Kv)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=1e-5)
    assert np.all(_np(got)[2] == 0.0)


def test_decode_packed_bf16_plain():
    """bf16 q and cache: the plain version computes in fp32 inside and
    rounds the output once; against the JAX oracle (bf16 einsums) 2e-2."""
    q, k, v, st, ln, Kv = _decode_inputs(8)
    bf = lambda a: _t(a).bfloat16()
    got = tdec.decode_attention_packed(bf(q), bf(k), bf(v), _t(st), _t(ln), num_kv=Kv)
    assert got.dtype == torch.bfloat16
    want = jdec.decode_attention_packed_xla(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
        jnp.asarray(st), jnp.asarray(ln), num_kv=Kv)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2)


def test_quantize_kv_token_bit_exact():
    r = np.random.default_rng(9)
    k = (r.normal(size=(5, 7, 32)) * 3).astype(np.float32)
    k[0, 0] = 0.0                       # all-zero token: the 1e-8 floor
    k[1, 1, :4] = [0.5, -0.5, 1.5, 127.0]  # exact halves: round half to even
    tq, ts = tdec.quantize_kv_token(_t(k))
    jq, js = jdec.quantize_kv_token(jnp.asarray(k))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# --- K4: fused lm-head sampler --------------------------------------------------

def _sampler_inputs(seed, B=6, D=32, V=300, hidden_dtype=np.float32):
    r = np.random.default_rng(seed)
    h = (r.normal(size=(B, D)) * 0.5).astype(np.float32)
    w = (r.normal(size=(D, V)) * 0.3).astype(np.float32)
    return h, quantize_tensor(_t(w))


def test_sampler_plain_greedy_matches_pallas():
    h, qt = _sampler_inputs(10)
    tok, lp = tsamp.fused_lmhead_sample(_t(h), qt.q, qt.scale, 7, greedy=True)
    jt, jl = j_sample(jnp.asarray(h), jnp.asarray(qt.q.numpy()), jnp.asarray(qt.scale.numpy()),
                      jnp.int32(7), greedy=True, vt_size=128, interpret=True)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jt))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jl), atol=1e-4)


def test_sampler_plain_greedy_bf16_hidden():
    """bf16 hidden: the int8 x bf16 products are exact in fp32 on both
    sides, so only summation order differs; lp within 1e-4."""
    h, qt = _sampler_inputs(11)
    hb = _t(h).bfloat16()
    tok, lp = tsamp.fused_lmhead_sample(hb, qt.q, qt.scale, 0, greedy=True)
    jt, jl = j_sample(jnp.asarray(h, jnp.bfloat16), jnp.asarray(qt.q.numpy()),
                      jnp.asarray(qt.scale.numpy()), jnp.int32(0), greedy=True, vt_size=128,
                      interpret=True)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jt))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jl), atol=1e-4)


def test_sampler_plain_sampled_logprob_is_that_of_token():
    h, qt = _sampler_inputs(12)
    T = 0.7
    logits = (_t(h) @ qt.q.float()) * qt.scale.reshape(1, -1) / T
    want_lp = torch.log_softmax(logits, -1)
    for seed in (1, 2, 3):
        tok, lp = tsamp.fused_lmhead_sample(_t(h), qt.q, qt.scale, seed, temperature=T)
        assert tok.dtype == torch.int32
        np.testing.assert_allclose(
            lp.numpy(), want_lp.gather(1, tok.long()[:, None])[:, 0].numpy(), atol=1e-5)


def test_sampler_plain_frequencies_follow_softmax():
    """Draw 4000 seeds on a 5-token vocabulary: the empirical frequencies
    match softmax(z / T) within 0.03 (about 4 standard errors)."""
    r = np.random.default_rng(13)
    h = _t((r.normal(size=(1, 4)) * 0.5).astype(np.float32))
    qt = quantize_tensor(_t((r.normal(size=(4, 5))).astype(np.float32)))
    T = 1.3
    p = torch.softmax((h @ qt.q.float()) * qt.scale.reshape(1, -1) / T, -1)[0].numpy()
    counts = np.zeros(5)
    for seed in range(4000):
        tok, _ = tsamp.fused_lmhead_sample(h, qt.q, qt.scale, seed, temperature=T)
        counts[int(tok[0])] += 1
    np.testing.assert_allclose(counts / counts.sum(), p, atol=0.03)


def test_gumbel_noise_depends_on_seed_row_and_column_only():
    a = tsamp.gumbel_noise(5, 3, 10, "cpu")
    b = tsamp.gumbel_noise(5, 4, 20, "cpu")
    np.testing.assert_array_equal(a.numpy(), b[:3, :10].numpy())
    assert not torch.equal(a, tsamp.gumbel_noise(6, 3, 10, "cpu"))
    assert torch.isfinite(b).all()
