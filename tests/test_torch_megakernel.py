"""The port's decode megakernel module (plan, packing, the plain version of
kernel K9, ``generate(mega=)``) against the JAX package on the CPU, at the
size of ``tests/test_decode_megakernel.py`` (2 layers, D=256, 4 heads of 64).

The JAX side runs its Pallas kernel in interpret mode. Both sides round hn,
the attention output and the gate/up activations to bf16 at the same places
and keep the residual stream in f32, so they differ by f32 summation order
only, which can flip a bf16 rounding: the hidden state must agree within
2e-2 of its largest entry (a bf16 ulp there is 7.8e-3), the written k/v slot
(dequantized) within 1e-2 of its largest entry (one int8 code is 7.9e-3),
and every other slot bit for bit. Greedy ``generate(mega=)`` is held to the
JAX test's own bar (agreement > 0.9).
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
from rlinf_tpu.models.llm.sampler import SamplingParams as JSampling
from rlinf_tpu.models.llm.sampler import generate as j_generate
from rlinf_tpu.ops.pallas import decode_megakernel as JMK
from rlinf_tpu.ops.rope import rope_frequencies as j_rope_frequencies
from rlinf_tpu_torch.models.llm.config import LLMConfig as TConfig
from rlinf_tpu_torch.models.llm.convert import cache_from_numpy, params_from_numpy
from rlinf_tpu_torch.models.llm.quant import quantize_params
from rlinf_tpu_torch.models.llm.sampler import SamplingParams, generate
from rlinf_tpu_torch.ops.cuda import decode_megakernel as TMK
from rlinf_tpu_torch.ops.rope import rope_frequencies

torch.set_num_threads(2)

B, S = 8, 128


def _cfgs(**kw):
    base = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
                head_dim=64, intermediate_size=384, max_seq_len=128)
    jcfg = JConfig(**{**base, **kw})
    return jcfg, TConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    # a non-zero qkv bias, so that the bias path is held too
    r = np.random.default_rng(1)
    blocks = dict(jp["blocks"])
    for k in ("bq", "bk", "bv"):
        blocks[k] = jnp.asarray(r.normal(size=blocks[k].shape) * 0.1, blocks[k].dtype)
    jp = dict(jp, blocks=blocks)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    jq, tq = j_quantize_params(jp), quantize_params(tp)
    return jcfg, tcfg, jp, tp, jq, tq


def _cache(jcfg, seed):
    r = np.random.default_rng(seed)
    L, kd = jcfg.num_layers, jcfg.kv_dim
    return (r.integers(-80, 80, (L, B, S, kd)).astype(np.int8),
            r.integers(-80, 80, (L, B, S, kd)).astype(np.int8),
            (r.random((L, B, S)) * 0.01 + 0.001).astype(np.float32),
            (r.random((L, B, S)) * 0.01 + 0.001).astype(np.float32))


@pytest.mark.parametrize("chunk_width", [2048, 256])
def test_make_plan_fields_equal(chunk_width):
    jcfg, tcfg = _cfgs()
    jplan, tplan = JMK.make_plan(jcfg, chunk_width), TMK.make_plan(tcfg, chunk_width)
    assert dataclasses.asdict(jplan) == dataclasses.asdict(tplan)
    for prop in ("w_qkv", "attn_p", "wo_p0", "gate_p0", "up_p0", "down_p0", "nph", "nchk"):
        assert getattr(jplan, prop) == getattr(tplan, prop), prop
    assert tplan.layer_bytes == sum(k * n for _, k, n in tplan.matrices)


@pytest.mark.parametrize("bad", [dict(qk_norm=True), dict(head_dim=32)])
def test_make_plan_asserts_as_jax(bad):
    jcfg, tcfg = _cfgs(**bad)
    with pytest.raises(AssertionError):
        JMK.make_plan(jcfg)
    with pytest.raises(AssertionError):
        TMK.make_plan(tcfg)


def test_make_plan_chunk_width_below_hidden():
    jcfg, tcfg = _cfgs()
    with pytest.raises(AssertionError):
        JMK.make_plan(jcfg, 128)
    with pytest.raises(AssertionError):
        TMK.make_plan(tcfg, 128)


def test_pack_roundtrip_and_unfused_rejected(setup):
    """The stream holds wqkv | wo | gate_up | down as 64 x 64 wgmma tiles,
    gate and up interleaved by 64-column units (scales alike); unpacking
    gives the quantized matrices back bit for bit."""
    _, tcfg, _, tp, _, tq = setup
    plan, mw = TMK.pack_decode_weights(tq, tcfg)
    assert mw.stream.shape == (plan.L, plan.layer_bytes) and mw.stream.dtype == torch.int8
    assert mw.scales.shape == (plan.L, plan.scale_width)
    assert [name for name, _, _ in plan.matrices] == ["wqkv", "wo", "gate_up", "down"]
    b = tq["blocks"]
    F = plan.F
    want = {"wqkv": (b["wqkv"].q, b["wqkv"].scale), "wo": (b["wo"].q, b["wo"].scale),
            "down": (b["down"].q, b["down"].scale)}
    off_w = off_s = 0
    for name, k, n in plan.matrices:
        for layer in range(plan.L):
            got = TMK._unpack_matrix(mw.stream[layer, off_w:off_w + k * n], k, n)
            sc = mw.scales[layer, off_s:off_s + n]
            if name == "gate_up":
                for part, (q, s_) in zip(TMK._split_units(got), (
                        (b["wgu"].q[layer, :, :F], b["wgu"].scale[layer, ..., :F]),
                        (b["wgu"].q[layer, :, F:], b["wgu"].scale[layer, ..., F:]))):
                    assert torch.equal(part, q)
                gate_s, up_s = TMK._split_units(sc)
                assert torch.equal(gate_s, b["wgu"].scale[layer].reshape(-1)[:F].float())
                assert torch.equal(up_s, b["wgu"].scale[layer].reshape(-1)[F:].float())
                # unit 2j is gate columns 64j.., unit 2j + 1 the same up columns
                assert torch.equal(got[:, 64:128], b["wgu"].q[layer, :, F:F + 64])
            else:
                assert torch.equal(got, want[name][0][layer]), name
                assert torch.equal(sc, want[name][1][layer].reshape(-1).float()), name
        off_w += k * n
        off_s += n
    assert torch.equal(mw.bias, torch.cat([b["bq"], b["bk"], b["bv"]], -1).float())
    with pytest.raises(AssertionError):
        TMK.pack_decode_weights(quantize_params(tp, fuse=False), tcfg)


def test_tile_layout_is_the_warpgroup_fragments():
    """Byte 16 * thread + 4 * (2 (j % 2) + r) + 2 hi + e of a tile (plus 2048
    for k16 steps j = 2, 3) holds depth 16 j + 8 hi + 2 t + e of column
    16 w + g + 8 r, thread = 32 w + 4 g + t: the A fragments of the kernel's
    wgmma, as csrc/decode_megakernel.cu reads them."""
    K, N = 128, 192
    q = torch.arange(K * N, dtype=torch.int64).reshape(1, K, N)
    tiles = TMK._pack_matrix(q).reshape(N // 64, K // 64, 4096)
    r = np.random.default_rng(0)
    for _ in range(200):
        m, kb = r.integers(0, N // 64), r.integers(0, K // 64)
        w, g, t, j, rr, hi, e = (r.integers(0, n) for n in (4, 8, 4, 4, 2, 2, 2))
        thread = 32 * w + 4 * g + t
        byte = (j // 2) * 2048 + 16 * thread + 4 * (2 * (j % 2) + rr) + 2 * hi + e
        depth, col = 64 * kb + 16 * j + 8 * hi + 2 * t + e, 64 * m + 16 * w + g + 8 * rr
        assert tiles[m, kb, byte].item() == q[0, depth, col].item()


@pytest.mark.parametrize("preset,B", [("qwen2_1_5b", 64), ("qwen2_1_5b", 8), ("qwen2_7b", 64),
                                      ("qwen2_7b", 100)])
def test_launch_schedule_covers_every_tile_once(preset, B):
    """The launch's schedule at the geometry of Qwen2-1.5B and Qwen2-7B on
    132 SMs: over all CTAs, every weight tile of every product (each row
    block, unit and k-block) is multiplied exactly once; a CTA's tiles of a
    product lie in one K-slice, whose staged activations fit the kernel's
    shared memory (at most KBS_MAX k-blocks of 64 rows); every slice is
    covered; the attention splits cover the longest row and, where a row
    has several, fit one item a consumer warp."""
    cfg = getattr(TConfig, preset)()
    plan = TMK.make_plan(cfg, max(2048, cfg.hidden_size))
    TMK._check_geometry(plan)
    S, grid = 768, 132
    sched = TMK.mega_schedule(plan, B, S, grid)
    nrb = -(-B // TMK.ROWS)
    seen = [dict() for _ in TMK.PRODUCTS]
    for cta in range(grid):
        tiles = TMK.cta_tiles(plan, sched, B, cta)
        for p, (KB, units) in enumerate(TMK.product_shapes(plan)):
            mine = [(rb, u, kb) for q, rb, u, kb in tiles if q == p]
            _, _, _, kb0, kbs = TMK.cta_slice(KB, sched.ks[p], grid, cta)
            assert kbs <= TMK.KBS_MAX
            assert all(kb0 <= kb < kb0 + kbs for _, _, kb in mine)
            for key in mine:
                seen[p][key] = seen[p].get(key, 0) + 1
    for p, (KB, units) in enumerate(TMK.product_shapes(plan)):
        assert sched.ks[p] <= grid
        assert len(seen[p]) == nrb * units * KB and set(seen[p].values()) == {1}, TMK.PRODUCTS[p]
    assert sched.bps * sched.ns >= -(-S // TMK.KEY_BLOCK) > sched.bps * (sched.ns - 1)
    # a row's splits wait for each other: with several, every item has a warp
    assert sched.ns == 1 or B * plan.Kv * sched.ns <= grid * TMK.CONSUMER_WARPS
    part, apart, sync = TMK.workspace_floats(plan, sched, B)
    assert part >= nrb * max(ks * u for ks, (_, u) in zip(sched.ks, TMK.product_shapes(plan))) * 4096


def _both_steps(setup, write_pos, positions, starts, seed):
    jcfg, tcfg, _, _, jq, tq = setup
    r = np.random.default_rng(seed)
    tok = r.integers(0, jcfg.vocab_size, (B,))
    cache = _cache(jcfg, seed + 100)
    jplan, jmw = JMK.pack_decode_weights(jq, jcfg, chunk_width=256)
    x0 = jq["embed"][jnp.asarray(tok)].astype(jcfg.compute_dtype)
    cos, sin = j_rope_frequencies(jcfg.head_dim_, jcfg.max_seq_len, jcfg.rope_theta)
    jwp = jnp.int32(write_pos) if np.ndim(write_pos) == 0 else jnp.asarray(write_pos, jnp.int32)
    jout = JMK.decode_step_mega(
        jplan, jmw, x0, *map(jnp.asarray, cache), jwp, jnp.asarray(positions, jnp.int32),
        jnp.asarray(starts, jnp.int32), cos, sin, kv_block=64, interpret=True)
    jout = [np.asarray(a, np.float32) if i == 0 else np.asarray(a) for i, a in enumerate(jout)]

    tplan, tmw = TMK.pack_decode_weights(tq, tcfg, chunk_width=256)
    tx0 = tq["embed"][torch.as_tensor(tok)].to(tcfg.compute_dtype)
    tcos, tsin = rope_frequencies(tcfg.head_dim_, tcfg.max_seq_len, tcfg.rope_theta)
    twp = int(write_pos) if np.ndim(write_pos) == 0 else torch.as_tensor(write_pos, dtype=torch.int32)
    tout = TMK.decode_step_mega(
        tplan, tmw, tx0, *cache_from_numpy(cache, device="cpu"), twp,
        torch.as_tensor(positions, dtype=torch.int32), torch.as_tensor(starts, dtype=torch.int32),
        tcos, tsin)
    tout = [tout[0].float().numpy()] + [t.numpy() for t in tout[1:]]
    return cache, jout, tout


def _hold(cache, jout, tout, slots):
    rows = np.arange(B)
    scale = np.abs(jout[0]).max()
    assert np.abs(tout[0] - jout[0]).max() < 2e-2 * scale
    for q_i, s_i in ((1, 3), (2, 4)):
        want = jout[q_i][:, rows, slots].astype(np.float32) * jout[s_i][:, rows, slots][..., None]
        got = tout[q_i][:, rows, slots].astype(np.float32) * tout[s_i][:, rows, slots][..., None]
        assert np.abs(got - want).max() < 1e-2 * np.abs(want).max()
    for i in range(4):                       # every other slot is the input's, bit for bit
        keep = np.ones((B, S), bool)
        keep[rows, slots] = False
        np.testing.assert_array_equal(tout[1 + i][:, keep], cache[i][:, keep])
        np.testing.assert_array_equal(jout[1 + i][:, keep], cache[i][:, keep])


def test_plain_step_matches_jax_interpret_scalar_write_pos(setup):
    r = np.random.default_rng(0)
    wp = 64
    cache, jout, tout = _both_steps(setup, wp, np.full((B,), 40), r.integers(0, 8, (B,)), 0)
    _hold(cache, jout, tout, np.full((B,), wp))


def test_plain_step_matches_jax_interpret_ragged_write_pos(setup):
    r = np.random.default_rng(7)
    wp = r.integers(5, S - 1, (B,))
    wp[0] = 0                                 # a free slot of the engine: no past key
    cache, jout, tout = _both_steps(setup, wp, wp, np.zeros((B,), np.int64), 7)
    assert np.isfinite(tout[0]).all()
    _hold(cache, jout, tout, wp)


def test_generate_mega_greedy_matches_jax(setup):
    jcfg, tcfg, jp, tp, jq, tq = setup
    r = np.random.default_rng(2)
    ids = r.integers(0, 256, (8, 16)).astype(np.int32)
    lens = np.array([16, 16, 9, 16, 5, 16, 12, 16])
    mask = np.arange(16)[None, :] >= (16 - lens)[:, None]
    ids = np.where(mask, ids, 0).astype(np.int32)
    jout = j_generate(jp, jcfg, jax.random.PRNGKey(3), jnp.asarray(ids), jnp.asarray(mask),
                      JSampling(max_new_tokens=5, greedy=True), decode_params=jq,
                      kv_quant="int8", mega=JMK.pack_decode_weights(jq, jcfg, chunk_width=256),
                      sampler_impl="xla")
    out = generate(tp, tcfg, torch.Generator(), ids, mask,
                   SamplingParams(max_new_tokens=5, greedy=True), decode_params=tq,
                   kv_quant="int8", mega=TMK.pack_decode_weights(tq, tcfg), sampler_impl="xla",
                   device="cpu")
    jt, jl = np.asarray(jout.response_ids), np.asarray(jout.response_logprobs)
    agree = (out.response_ids.numpy() == jt).mean()
    assert agree > 0.9, agree
    same = np.cumprod(out.response_ids.numpy() == jt, axis=1).astype(bool)
    assert np.abs(out.response_logprobs.numpy() - jl)[same].max() < 0.05
    np.testing.assert_array_equal(out.response_mask.numpy(), np.asarray(jout.response_mask))


def test_generate_mega_without_int8_kv_takes_the_per_layer_path(setup):
    """As in the JAX package, mega= is used only with kv_quant='int8'."""
    _, tcfg, _, tp, _, tq = setup
    r = np.random.default_rng(3)
    ids, mask = r.integers(0, 256, (8, 16)).astype(np.int32), np.ones((8, 16), bool)
    sp = SamplingParams(max_new_tokens=3, greedy=True)
    runs = [generate(tp, tcfg, torch.Generator(), ids, mask, sp, decode_params=tq, mega=mega,
                     device="cpu") for mega in (TMK.pack_decode_weights(tq, tcfg), None)]
    assert torch.equal(runs[0].response_ids, runs[1].response_ids)


def test_wrapper_geometry_check():
    """The kernel stages a K-slice of the activations at a time, so the
    hidden size has no limit of its own: Qwen2-1.5B, Qwen2-7B (D=3584) and
    the test geometry are taken; a head dim outside 64/128, more than 8
    query heads a kv head and widths the 64-column tiles do not cut are
    refused with a reason."""
    TMK._check_geometry(TMK.make_plan(TConfig.qwen2_1_5b()))
    TMK._check_geometry(TMK.make_plan(TConfig.qwen2_7b(), 4096))
    TMK._check_geometry(TMK.make_plan(_cfgs()[1]))
    with pytest.raises(ValueError, match="unsupported H=4 Kv=2 Hd=16"):
        TMK._check_geometry(TMK.make_plan(TConfig.tiny()))
    with pytest.raises(ValueError, match="at most 8 query heads"):
        TMK._check_geometry(TMK.make_plan(_cfgs(num_heads=32, hidden_size=2048)[1]))
    with pytest.raises(ValueError, match="intermediate 400 not a multiple"):
        TMK._check_geometry(TMK.make_plan(_cfgs(intermediate_size=400)[1]))
