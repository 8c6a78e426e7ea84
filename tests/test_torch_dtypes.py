"""The plain versions of the kernels at head dims 16 and 32 and in f16 and
f32 (the geometries and dtypes the kernels now take on the card) against
the JAX package's Pallas kernels in interpret mode, on the CPU at small
sizes.

Every input is drawn with numpy from a seed, rounded to the case's dtype,
and handed to both sides. Both sides compute in f32 and round their
outputs to the dtype, so they agree to a rounding of the output: f32 1e-5,
f16 2e-3 and bf16 2e-2 absolute on outputs of size ~1 (one f16 step is
2^-11, one bf16 step 2^-8 of the value).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlinf_tpu.ops.pallas import decode_attention as jdec
from rlinf_tpu.ops.pallas.flash_attention import flash_attention as j_flash
from rlinf_tpu.ops.pallas.linear_ce import fused_linear_ce as j_fused_ce
from rlinf_tpu.ops.pallas.paged_attention import paged_attention as j_paged
from rlinf_tpu.ops.pallas.sampler_kernel import fused_lmhead_sample as j_sample
from rlinf_tpu_torch.models.llm.convert import tensor_from_numpy
from rlinf_tpu_torch.models.llm.quant import quantize_tensor
from rlinf_tpu_torch.ops.cuda import decode_attention as tdec
from rlinf_tpu_torch.ops.cuda import flash_attention as tflash
from rlinf_tpu_torch.ops.cuda import linear_ce as tce
from rlinf_tpu_torch.ops.cuda import paged_attention as tpaged
from rlinf_tpu_torch.ops.cuda import sampler_kernel as tsamp

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, 1e-5), "float16": (jnp.float16, 2e-3),
          "bfloat16": (jnp.bfloat16, 2e-2)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(a, dtype):
    """(JAX array, torch tensor) of the same values in ``dtype``."""
    j = jnp.asarray(a, DTYPES[dtype][0])
    return j, tensor_from_numpy(np.asarray(j), device="cpu")


def _left_padded(r, B, S):
    lens = r.integers(1, S + 1, B)
    lens[0] = S
    valid = np.arange(S)[None, :] >= (S - lens)[:, None]
    pos = np.maximum(np.cumsum(valid, -1) - 1, 0).astype(np.int32)
    return pos, valid


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("Hd", [16, 32])
def test_flash_forward_and_backward_at_small_heads(Hd, dtype):
    """K1's plain version and the K7/K8 plain backward (through the
    autograd Function) against the Pallas flash attention and its
    jax.grad, GQA H=4 over Kv=2, left-padded rows; outputs and gradients in
    the inputs' dtype. Gradients within the dtype's tolerance relative to
    their largest entry."""
    r = np.random.default_rng(Hd)
    B, S, H, K = 2, 32, 4, 2
    jq, tq = _pair(r.normal(size=(B, S, H, Hd)), dtype)
    jk, tk = _pair(r.normal(size=(B, S, K, Hd)), dtype)
    jv, tv = _pair(r.normal(size=(B, S, K, Hd)), dtype)
    cot = r.normal(size=(B, S, H, Hd)).astype(np.float32)
    pos, valid = _left_padded(r, B, S)
    tol = DTYPES[dtype][1]
    tq, tk, tv = (t.requires_grad_(True) for t in (tq, tk, tv))
    o = tflash.flash_attention(tq, tk, tv, positions_q=torch.from_numpy(pos),
                               positions_kv=torch.from_numpy(pos),
                               kv_valid_mask=torch.from_numpy(valid))
    assert o.dtype == tq.dtype
    (o.float() * torch.from_numpy(cot)).sum().backward()

    def loss(q_, k_, v_):
        o_ = j_flash(q_, k_, v_, positions_q=jnp.asarray(pos), positions_kv=jnp.asarray(pos),
                     kv_valid_mask=jnp.asarray(valid), block_q=16, block_k=16)
        return jnp.sum(o_.astype(jnp.float32) * cot), o_

    (_, jo), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(jq, jk, jv)
    np.testing.assert_allclose(_np(o), _np(jo), atol=tol)
    for got, want in zip((tq.grad, tk.grad, tv.grad), grads):
        assert got.dtype == tq.dtype
        scale = np.abs(_np(want)).max()
        np.testing.assert_allclose(_np(got), _np(want), atol=tol * scale)


def _decode_inputs(r, Hd, B=4, S=24, H=4, Kv=2):
    q = r.normal(size=(B, H, Hd))
    k = r.normal(size=(B, S, Kv * Hd)) * 0.5
    v = r.normal(size=(B, S, Kv * Hd)) * 0.5
    starts = np.array([0, 5, 3, 10], np.int32)[:B]
    lengths = np.array([S, 17, 3, 11], np.int32)[:B]   # row 2 is empty
    return q, k, v, starts, lengths, Kv


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("Hd", [16, 32])
def test_decode_attention_at_small_heads(Hd, dtype):
    """K2's plain version (cache in the query's dtype) and K3's (int8
    cache, query in the dtype) against the Pallas decode kernels; outputs
    in the query's dtype, the empty row 0."""
    r = np.random.default_rng(100 + Hd)
    q, k, v, st, ln, Kv = _decode_inputs(r, Hd)
    tol = DTYPES[dtype][1]
    jq, tq = _pair(q, dtype)
    jk, tk = _pair(k, dtype)
    jv, tv = _pair(v, dtype)
    got = tdec.decode_attention_packed(tq, tk, tv, torch.from_numpy(st), torch.from_numpy(ln),
                                       num_kv=Kv)
    want = jdec.decode_attention_packed(jq, jk, jv, jnp.asarray(st), jnp.asarray(ln), num_kv=Kv,
                                        block_size=8, block_rows=2, interpret=True)
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(_np(got), _np(want), atol=tol)
    assert np.all(_np(got)[2] == 0.0)
    kq, ks = tdec.quantize_kv_token(torch.from_numpy(k.astype(np.float32)))
    vq, vs = tdec.quantize_kv_token(torch.from_numpy(v.astype(np.float32)))
    got8 = tdec.decode_attention_packed_q8(tq, kq, vq, ks, vs, torch.from_numpy(st),
                                           torch.from_numpy(ln), num_kv=Kv)
    want8 = jdec.decode_attention_packed_q8(
        jq, jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()), jnp.asarray(ks.numpy()),
        jnp.asarray(vs.numpy()), jnp.asarray(st), jnp.asarray(ln), num_kv=Kv, block_size=8,
        block_rows=2, interpret=True)
    assert got8.dtype == tq.dtype
    np.testing.assert_allclose(_np(got8), _np(want8), atol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("Hd", [16, 32])
def test_paged_attention_at_small_heads(Hd, dtype):
    """K10's plain version against the Pallas paged kernel: pages of 8
    tokens in a shuffled pool, a row of length 0 (which gives 0)."""
    r = np.random.default_rng(200 + Hd)
    B, H, Kv, P, max_pages = 3, 4, 2, 8, 4
    lengths = np.array([29, 0, 9], np.int32)
    pool = 1 + B * max_pages
    kp, vp = r.normal(size=(pool, Kv, P, Hd)), r.normal(size=(pool, Kv, P, Hd))
    table = np.zeros((B, max_pages), np.int32)
    perm = r.permutation(pool - 1) + 1
    at = 0
    for b in range(B):
        n = -(-int(lengths[b]) // P)
        table[b, :n] = perm[at:at + n]
        at += n
    tol = DTYPES[dtype][1]
    jq, tq = _pair(r.normal(size=(B, H, Hd)), dtype)
    jk, tk = _pair(kp, dtype)
    jv, tv = _pair(vp, dtype)
    got = tpaged.paged_attention(tq, tk, tv, torch.from_numpy(table), torch.from_numpy(lengths))
    want = j_paged(jq, jk, jv, jnp.asarray(table), jnp.asarray(lengths), interpret=True)
    assert got.dtype == tq.dtype
    valid = lengths > 0
    np.testing.assert_allclose(_np(got)[valid], _np(want)[valid], atol=tol)
    assert np.all(_np(got)[1] == 0.0)


@pytest.mark.parametrize("w_layout", ["dv", "vd"])
@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_linear_ce_in_f32_and_f16(dtype, w_layout):
    """K5/K6's plain versions (through fused_linear_ce's autograd) against
    the Pallas fused linear cross-entropy with its custom VJP: logprobs and
    entropies (f32) within 1e-4 (f16 operands: 2e-3), the gradients of h
    and W in the inputs' dtype within 1e-3 of their largest entry (both
    round dz to bf16, as the Pallas kernel does)."""
    r = np.random.default_rng(7)
    B, S, D, V = 2, 20, 32, 700
    jh, th = _pair(r.normal(size=(B, S, D)), dtype)
    w_dv = r.normal(size=(D, V)) * 0.05
    jw, tw = _pair(w_dv if w_layout == "dv" else w_dv.T.copy(), dtype)
    ids = r.integers(0, V, (B, S)).astype(np.int32)
    adv = r.normal(size=(B, S)).astype(np.float32)
    th, tw = th.requires_grad_(True), tw.requires_grad_(True)
    lp, ent = tce.fused_linear_ce(th, tw, torch.from_numpy(ids), w_layout=w_layout)
    ((lp * torch.from_numpy(adv)).mean() + 0.03 * ent.mean()).backward()

    def jloss(h_, w_):
        a, b = j_fused_ce(h_, w_, jnp.asarray(ids), w_layout=w_layout, interpret=True)
        return jnp.mean(a * adv) + 0.03 * jnp.mean(b), (a, b)

    (_, (ja, jb)), (gh, gw) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(jh, jw)
    tol = 1e-4 if dtype == "float32" else 2e-3
    np.testing.assert_allclose(_np(lp), _np(ja), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(ent), _np(jb), atol=tol, rtol=tol)
    for got, want in ((th.grad, gh), (tw.grad, gw)):
        assert got.dtype == th.dtype
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-3 * np.abs(_np(want)).max())


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_sampler_greedy_with_f32_and_f16_hidden(dtype):
    """K4's plain version on an f32 or f16 hidden state against the Pallas
    sampler (greedy): the same tokens, logprobs within 1e-4 (f16: 2e-3)."""
    r = np.random.default_rng(12)
    B, D, V = 6, 32, 300
    jh, th = _pair(r.normal(size=(B, D)) * 0.5, dtype)
    qt = quantize_tensor(torch.from_numpy((r.normal(size=(D, V)) * 0.3).astype(np.float32)))
    tok, lp = tsamp.fused_lmhead_sample(th, qt.q, qt.scale, 7, greedy=True)
    jt, jl = j_sample(jh, jnp.asarray(qt.q.numpy()), jnp.asarray(qt.scale.numpy()), jnp.int32(7),
                      greedy=True, vt_size=128, interpret=True)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jt))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jl), atol=1e-4 if dtype == "float32" else 2e-3)
