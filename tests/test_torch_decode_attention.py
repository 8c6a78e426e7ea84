"""The host side of K2 and K3 (bf16- and int8-cache decode attention,
split-KV) against the JAX package, on the CPU.

Each kernel cuts each row's valid interval into 16-key blocks, the blocks
into splits (``split_plan``), computes one partial state per split (max in
log2 units, sum of probabilities, unnormalised output) and merges the used
splits. Here that scheme runs in plain torch and is held against the
port's plain version, the JAX Pallas kernel in interpret mode (as the JAX
package's own tests run it) and its XLA oracle. Every input is drawn with
numpy from a seed and handed to both sides. Tolerance 1e-5 absolute on f32
queries (summation order only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlinf_tpu.ops.pallas import decode_attention as jdec
from rlinf_tpu_torch.ops.cuda import decode_attention as tdec

torch.set_num_threads(2)

KEY = tdec.KEY_BLOCK
LOG2E = 1.4426950408889634


def _row_blocks(start, length, S):
    """(first block, blocks) of a row's valid slots, by csrc row_interval."""
    lo, hi = max(start, 0), min(length, S)
    return lo // KEY, (-(-hi // KEY) - lo // KEY if hi > lo else 0)


def _splits(start, length, S, bps):
    """The slots [lo, hi) of each used split of a row: runs of bps blocks
    from the row's first block, clipped to its valid interval."""
    blk0, nblk = _row_blocks(start, length, S)
    lo_v, hi_v = max(start, 0), min(length, S)
    out = []
    for s0 in range(0, nblk, bps):
        lo = (blk0 + s0) * KEY
        hi = (blk0 + min(s0 + bps, nblk)) * KEY
        out.append((max(lo, lo_v), min(hi, hi_v)))
    return out


@pytest.mark.parametrize("rows,S,sms", [(128, 768, 132), (16, 300, 132), (2, 77, 132),
                                        (300, 4096, 132), (8, 16, 4)])
def test_split_plan_covers_each_valid_interval_once_in_order(rows, S, sms):
    """Every valid slot of a row lies in exactly one used split, in order;
    an empty interval has none; the splits span every row's blocks; the
    grid covers the SMs CTAS_PER_SM times unless that would cut splits
    below MIN_SPLIT_UNITS blocks."""
    max_blocks = -(-S // KEY)
    bps, ns = tdec.split_plan(rows, max_blocks, sms)
    assert bps * ns >= max_blocks > bps * (ns - 1)
    assert rows * ns >= tdec.CTAS_PER_SM * sms or bps == min(max_blocks, tdec.MIN_SPLIT_UNITS)
    r = np.random.default_rng(rows + S)
    cases = [(0, 0), (5, 5), (9, 3), (0, 1), (S - 1, S), (0, S), (15, 17), (16, 33), (0, S + 40)]
    cases += [tuple(sorted(r.integers(0, S + 1, 2))) for _ in range(20)]
    for start, length in cases:
        blk0, nblk = _row_blocks(start, length, S)
        assert blk0 + nblk <= max_blocks and -(-nblk // bps) <= ns
        covered = [s for lo, hi in _splits(start, length, S, bps) for s in range(lo, hi)]
        assert covered == list(range(max(start, 0), min(length, S)))


def _inputs(seed, B, S, H, Kv, Hd):
    r = np.random.default_rng(seed)
    q = r.normal(size=(B, H, Hd)).astype(np.float32)
    k = (r.normal(size=(B, S, Kv * Hd)) * 0.5).astype(np.float32)
    v = (r.normal(size=(B, S, Kv * Hd)) * 0.5).astype(np.float32)
    kq, ks = tdec.quantize_kv_token(torch.from_numpy(k))
    vq, vs = tdec.quantize_kv_token(torch.from_numpy(v))
    starts = np.array([0, 37, 150, 60], np.int32)[:B]
    lengths = np.array([S, S - 10, 150, 61], np.int32)[:B]   # row 2 is empty
    return torch.from_numpy(q), kq, vq, ks, vs, starts, lengths


def _k3_emulated(q, kq, vq, ks, vs, starts, lengths, num_kv, sms):
    """K3 on the CPU by its scheme: per (row, kv head, split) the partial
    state over the split's valid slots, then the used splits merged as
    csrc decode_merge_kernel merges them; an empty row gives 0. K2's
    scheme is the same without the scales (``ks``, ``vs`` None)."""
    B, H, Hd = q.shape
    S = kq.shape[1]
    G = H // num_kv
    bps, _ = tdec.split_plan(B * num_kv, -(-S // KEY), sms)
    scale2 = Hd**-0.5 * LOG2E
    kf = kq.float().reshape(B, S, num_kv, Hd)
    vf = vq.float().reshape(B, S, num_kv, Hd)
    out = torch.zeros((B, H, Hd))
    for b in range(B):
        for kvh in range(num_kv):
            qg = q[b, kvh * G:(kvh + 1) * G].float()                      # [G, Hd]
            parts = []
            for lo, hi in _splits(int(starts[b]), int(lengths[b]), S, bps):
                s = (qg @ kf[b, lo:hi, kvh].t()) * scale2
                if ks is not None:
                    s = s * ks[b, lo:hi][None, :]
                m = s.max(-1).values
                p = torch.exp2(s - m[:, None])
                pv = p if vs is None else p * vs[b, lo:hi][None, :]
                o = pv @ vf[b, lo:hi, kvh]
                parts.append((m, p.sum(-1), o))
            if not parts:
                continue
            M = torch.stack([m for m, _, _ in parts]).max(0).values
            L = sum(l * torch.exp2(m - M) for m, l, _ in parts)
            A = sum(o * torch.exp2(m - M)[:, None] for m, _, o in parts)
            out[b, kvh * G:(kvh + 1) * G] = A / L.clamp_min(1e-30)[:, None]
    return out


@pytest.mark.parametrize("G", [6, 7, 8])
@pytest.mark.parametrize("Hd", [64, 128])
def test_split_partials_merged_give_the_plain_and_pallas_q8_attention(Hd, G):
    """The split-KV scheme (splits of 4 blocks: rows of S = 200 run over up
    to 4 splits) against the port's plain version, the JAX Pallas kernel
    in interpret mode and its XLA oracle, 1e-5; the empty row exactly 0."""
    Kv = 2
    B, S, H = 4, 200, G * Kv
    q, kq, vq, ks, vs, starts, lengths = _inputs(10 + Hd + G, B, S, H, Kv, Hd)
    got = _k3_emulated(q, kq, vq, ks, vs, starts, lengths, Kv, sms=132)
    plain = tdec.decode_attention_packed_q8(q, kq, vq, ks, vs, torch.from_numpy(starts),
                                            torch.from_numpy(lengths), num_kv=Kv)
    jargs = (jnp.asarray(q.numpy()), jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()),
             jnp.asarray(ks.numpy()), jnp.asarray(vs.numpy()), jnp.asarray(starts),
             jnp.asarray(lengths))
    want = jdec.decode_attention_packed_q8(*jargs, num_kv=Kv, block_size=8, block_rows=2,
                                           interpret=True)
    oracle = jdec.decode_attention_packed_q8_xla(*jargs, num_kv=Kv)
    np.testing.assert_allclose(got.numpy(), plain.float().numpy(), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle, np.float32), atol=1e-5)
    assert np.all(got.numpy()[2] == 0.0)


def test_q8_wrapper_goes_to_its_kernel_for_tensors_off_the_cpu(monkeypatch):
    """Tensors on the ``meta`` device never reach the plain version: the
    wrapper goes to its kernel's argument checks, which raise for want of a
    CUDA tensor, and nothing is launched."""
    def never(*a, **kw):
        raise AssertionError("the plain version was called for a tensor off the CPU")

    monkeypatch.setattr(tdec, "decode_attention_packed_q8_xla", never)
    B, S, H, Kv, Hd = 2, 32, 4, 2, 64
    meta = dict(device="meta")
    q = torch.zeros((B, H, Hd), dtype=torch.bfloat16, **meta)
    kc = torch.zeros((B, S, Kv * Hd), dtype=torch.int8, **meta)
    sc = torch.zeros((B, S), **meta)
    st = torch.zeros((B,), dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tdec.decode_attention_packed_q8(q, kc, kc, sc, sc, st, st, num_kv=Kv)
    assert tdec.KERNEL_Q8.launches == 0


@pytest.mark.parametrize("G", [6, 7, 12, 16])
@pytest.mark.parametrize("Hd", [64, 128])
def test_split_partials_merged_give_the_plain_and_pallas_bf16_attention(Hd, G):
    """K2's split-KV scheme (the bf16 cache, up to 16 query heads a kv head)
    against the port's plain version, the JAX Pallas kernel in interpret
    mode and its XLA oracle, 1e-5 on f32 inputs; the empty row exactly 0."""
    Kv = 2
    B, S, H = 4, 200, G * Kv
    r = np.random.default_rng(20 + Hd + G)
    q = torch.from_numpy(r.normal(size=(B, H, Hd)).astype(np.float32))
    k = torch.from_numpy((r.normal(size=(B, S, Kv * Hd)) * 0.5).astype(np.float32))
    v = torch.from_numpy((r.normal(size=(B, S, Kv * Hd)) * 0.5).astype(np.float32))
    starts = np.array([0, 37, 150, 60], np.int32)
    lengths = np.array([S, S - 10, 150, 61], np.int32)   # row 2 is empty
    got = _k3_emulated(q, k, v, None, None, starts, lengths, Kv, sms=132)
    plain = tdec.decode_attention_packed(q, k, v, torch.from_numpy(starts),
                                         torch.from_numpy(lengths), num_kv=Kv)
    jargs = (jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
             jnp.asarray(starts), jnp.asarray(lengths))
    want = jdec.decode_attention_packed(*jargs, num_kv=Kv, block_size=8, block_rows=2,
                                        interpret=True)
    oracle = jdec.decode_attention_packed_xla(*jargs, num_kv=Kv)
    np.testing.assert_allclose(got.numpy(), plain.float().numpy(), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle, np.float32), atol=1e-5)
    assert np.all(got.numpy()[2] == 0.0)


def test_bf16_wrapper_goes_to_its_kernel_for_tensors_off_the_cpu(monkeypatch):
    """K2's wrapper: tensors on the ``meta`` device never reach the plain
    version; the wrapper goes to its kernel's argument checks, which raise
    for want of a CUDA tensor, and nothing is launched. A group of 16
    query heads passes the head check; 17 is refused by it."""
    def never(*a, **kw):
        raise AssertionError("the plain version was called for a tensor off the CPU")

    monkeypatch.setattr(tdec, "decode_attention_packed_xla", never)
    B, S, Kv, Hd = 2, 32, 2, 64
    meta = dict(device="meta")
    kc = torch.zeros((B, S, Kv * Hd), dtype=torch.bfloat16, **meta)
    st = torch.zeros((B,), dtype=torch.int32, **meta)
    q = torch.zeros((B, 32, Hd), dtype=torch.bfloat16, **meta)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tdec.decode_attention_packed(q, kc, kc, st, st, num_kv=Kv)
    q = torch.zeros((B, 34, Hd), dtype=torch.bfloat16, **meta)
    with pytest.raises(ValueError, match="unsupported H=34 Kv=2"):
        tdec.decode_attention_packed(q, kc, kc, st, st, num_kv=Kv)
    assert tdec.KERNEL_BF16.launches == 0


def test_q8_wrapper_and_source_agree_on_their_constants():
    """The wrappers' key block, the C entries' argument lists and the
    kernels' group limits are the source's: K2 and K3 both take a split
    plan (BPS, NS); K2 takes 16 query heads per kv head, K3 8."""
    import re

    from rlinf_tpu_torch.ops.cuda import _build
    from rlinf_tpu_torch.ops.cuda.geometry import LIMITS

    text = (_build.CSRC / "decode_attention.cu").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
    assert const("KEYS") == tdec.KEY_BLOCK
    assert const("Q8_NW") == tdec.MIN_SPLIT_UNITS
    assert const("MAXG") == LIMITS["decode_attention_q8"][1] == 8
    assert const("MAXG_BF") == LIMITS["decode_attention_bf16"][1] == 16
    for entry, kernel in (("decode_attention_q8", tdec.KERNEL_Q8),
                          ("decode_attention_bf16", tdec.KERNEL_BF16)):
        params = re.search(rf'extern "C" int {entry}\(([^)]*)\)', text).group(1)
        assert "int BPS, int NS" in params and len(params.split(",")) == len(kernel.argtypes)
    assert "decode_attn_kernel" not in text
