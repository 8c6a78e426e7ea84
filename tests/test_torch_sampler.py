"""The fused lm-head sampler's packed head (ops/cuda/sampler_kernel.py) on
the CPU: the packing that the kernel reads, the packed entry's plain
version against the unpacked one and against the JAX package's Pallas
kernel (interpret mode, as its own tests run it), and the rule that the
serving paths pack the head once per set of decode weights, never per
step.

Packing only moves bytes, so the round trip and the packed plain version
are held bit for bit (tokens equal, logprobs within 1e-6); against the
JAX kernel greedy tokens are equal and logprobs agree within 1e-4 (fp32
summation order only).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlinf_tpu.ops.pallas.sampler_kernel import fused_lmhead_sample as j_sample
from rlinf_tpu_torch.models.llm import model as M
from rlinf_tpu_torch.models.llm import sampler as S
from rlinf_tpu_torch.models.llm.config import LLMConfig
from rlinf_tpu_torch.models.llm.quant import quantize_params, quantize_tensor
from rlinf_tpu_torch.ops.cuda import _build
from rlinf_tpu_torch.ops.cuda import sampler_kernel as SK

torch.set_num_threads(2)

SHAPES = [(64, 8), (200, 1000), (1536, 300), (256, 4096)]


def _head(D, V, seed=0):
    r = np.random.default_rng(seed)
    return quantize_tensor(torch.from_numpy((r.normal(size=(D, V)) * 0.3).astype(np.float32)))


@pytest.mark.parametrize("D,V", SHAPES)
def test_pack_unpack_round_trip_is_exact(D, V):
    lm = _head(D, V)
    head = SK.pack_lm_head(lm.q, lm.scale)
    Dp = -(-D // SK.DEPTH_QUANTUM) * SK.DEPTH_QUANTUM
    Vp = -(-V // SK.COL_GROUP) * SK.COL_GROUP
    assert tuple(head.w.shape) == (Vp // 64, Dp // 64, 4096) and head.w.dtype == torch.int8
    assert (head.D, head.V) == (D, V) and tuple(head.scale.shape) == (Vp,)
    assert not head.scale[V:].any() and head.w.is_contiguous()
    q, s = SK.unpack_lm_head(head)
    assert torch.equal(q, lm.q) and torch.equal(s, lm.scale.reshape(V))
    # the padding is zeros: the packed bytes are the head's bytes and nothing else
    assert int(head.w.abs().sum()) == int(lm.q.abs().sum())


def test_packed_bytes_are_the_wgmma_a_fragments_of_each_thread():
    """In the 4 KB of (group m, k-block kb), thread 4 g + t of warp w finds at
    bytes 32 (32 w + 4 g + t) + 4 (2 j + r) the depths 64 kb + 16 j + 2 t +
    {0, 1, 8, 9} of column 64 m + 16 w + g + 8 r: its A fragment registers
    of k16 step j (the m16n8k16 order, which wgmma keeps for each warp)."""
    D, V = 512, 128
    depth = torch.arange(D)[:, None].expand(D, V)
    col = torch.arange(V)[None, :].expand(D, V)
    q = ((depth * 7 + col * 13) % 255 - 127).to(torch.int8)
    head = SK.pack_lm_head(q, torch.ones(V))
    assert tuple(head.w.shape) == (V // 64, D // 64, 4096)
    for m in range(V // 64):
        for kb in (0, 5):
            tile = head.w[m, kb]
            for w in range(4):
                for lane in (0, 5, 18, 31):
                    g, t = lane // 4, lane % 4
                    for j in range(4):
                        for r in range(2):
                            at = 32 * (32 * w + lane) + 4 * (2 * j + r)
                            v = 64 * m + 16 * w + g + 8 * r
                            ds = [64 * kb + 16 * j + 2 * t + o for o in (0, 1, 8, 9)]
                            assert tile[at:at + 4].tolist() == [int(q[d, v]) for d in ds]


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
@pytest.mark.parametrize("D,V", SHAPES)
def test_packed_entry_matches_the_plain_version(D, V, mode):
    lm = _head(D, V, seed=1)
    head = SK.pack_lm_head(lm.q, lm.scale)
    r = np.random.default_rng(2)
    hidden = torch.from_numpy((r.normal(size=(5, D)) * 0.5).astype(np.float32)).bfloat16()
    kw = {"greedy": True} if mode == "greedy" else {"temperature": 0.8}
    tok, lp = SK.fused_lmhead_sample_packed(hidden, head, 17, **kw)
    want_tok, want_lp = SK.fused_lmhead_sample_plain(hidden, lm.q, lm.scale, 17, **kw)
    assert tok.dtype == torch.int32 and torch.equal(tok, want_tok)
    np.testing.assert_allclose(lp.numpy(), want_lp.numpy(), atol=1e-6, rtol=0)
    # the unpacked entry packs and then runs the packed one: the same draw
    tok2, lp2 = SK.fused_lmhead_sample(hidden, lm.q, lm.scale, 17, **kw)
    assert torch.equal(tok2, tok) and torch.equal(lp2, lp)


@pytest.mark.parametrize("B,D,V", [(6, 32, 300), (9, 128, 1000)])
def test_packed_greedy_matches_pallas_kernel(B, D, V):
    r = np.random.default_rng(B)
    h = (r.normal(size=(B, D)) * 0.5).astype(np.float32)
    lm = quantize_tensor(torch.from_numpy((r.normal(size=(D, V)) * 0.3).astype(np.float32)))
    hb = torch.from_numpy(h).bfloat16()
    tok, lp = SK.fused_lmhead_sample_packed(hb, SK.pack_lm_head(lm.q, lm.scale), 7, greedy=True)
    jt, jl = j_sample(jnp.asarray(h, jnp.bfloat16), jnp.asarray(lm.q.numpy()),
                      jnp.asarray(lm.scale.numpy()), jnp.int32(7), greedy=True, vt_size=128,
                      interpret=True)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jt))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jl), atol=1e-4)


def test_row_block_fits_shared_memory_and_follows_the_batch():
    """The N of the wgmma: the fewest rows of 16, 32, 64 that hold the batch;
    Qwen2-1.5B's depth fits 64 rows exactly; deeper heads stage fewer."""
    assert [SK._row_block(b, 1536) for b in (1, 8, 16, 17, 32, 33, 64, 200)] == [
        16, 16, 16, 32, 32, 64, 64, 64]
    assert SK.smem_bytes(64, 1536) == SK.SMEM_CAP
    assert SK._row_block(64, 3072) == 32 and SK._row_block(64, 4608) == 16
    with pytest.raises(ValueError, match="does not fit"):
        SK._row_block(8, 16384)


def test_wrapper_and_source_agree_on_their_constants():
    text = (_build.CSRC / "sampler.cu").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
    assert const("WG") == SK.WARPGROUPS and const("GROUP") == SK.COL_GROUP == 64
    assert const("KBLK") * const("U") == SK.DEPTH_QUANTUM and const("KBLK") == 64
    assert const("ZLD") == SK.Z_STRIDE and const("SMEM_CAP") == SK.SMEM_CAP
    assert "return (size_t)WG * N * ZLD * 4 + 1024 + (size_t)N * Dp * 2;" in text
    assert all(f"rows == {n}" in text for n in SK.ROW_BLOCKS)


def test_packed_wrapper_goes_to_its_kernel_for_tensors_off_the_cpu(monkeypatch):
    """Tensors that do not lie on the CPU (here on the ``meta`` device) never
    reach the plain version: the wrapper's argument checks raise."""
    lm = _head(64, 32)
    head = SK.pack_lm_head(lm.q.to("meta"), lm.scale.to("meta"))

    def never(*a, **kw):
        raise AssertionError("the plain version was called for a tensor off the CPU")

    monkeypatch.setattr(SK, "fused_lmhead_sample_packed_plain", never)
    monkeypatch.setattr(SK, "fused_lmhead_sample_plain", never)
    hidden = torch.zeros((4, 64), dtype=torch.bfloat16, device="meta")
    for call in (lambda: SK.fused_lmhead_sample_packed(hidden, head, 0),
                 lambda: SK.fused_lmhead_sample(hidden, lm.q.to("meta"), lm.scale.to("meta"), 0)):
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            call()
    assert SK.KERNEL.launches == 0


# ---------------------------------------------------------------------------
# where the head is packed: once per set of decode weights
# ---------------------------------------------------------------------------

CFG = LLMConfig(vocab_size=300, hidden_size=64, num_layers=2, num_heads=2, num_kv_heads=1,
                head_dim=32, intermediate_size=128, max_seq_len=64)


@pytest.fixture
def pack_calls(monkeypatch):
    calls = []
    real = S.pack_lm_head

    def counting(q, s):
        calls.append(tuple(q.shape))
        return real(q, s)

    monkeypatch.setattr(S, "pack_lm_head", counting)
    return calls


def _prompts(B=3, P=8, seed=0):
    r = np.random.default_rng(seed)
    return r.integers(1, CFG.vocab_size, (B, P)).astype(np.int32), np.ones((B, P), bool)


def test_with_packed_lm_head_packs_once_and_keeps_the_head(pack_calls):
    qp = quantize_params(M.init_params(CFG, 0, device="cpu"))
    dp = S.with_packed_lm_head(qp)
    assert S.with_packed_lm_head(dp) is dp and len(pack_calls) == 1
    q, s = SK.unpack_lm_head(dp["lm_head_packed"])
    assert torch.equal(q, qp["lm_head"].q) and torch.equal(s, qp["lm_head"].scale.reshape(-1))
    assert "lm_head_packed" not in qp


@pytest.mark.parametrize("prepacked", [False, True])
def test_generate_packs_the_head_once_not_per_step(pack_calls, prepacked):
    params = M.init_params(CFG, 1, device="cpu")
    qp = quantize_params(params)
    if prepacked:
        qp = S.with_packed_lm_head(qp)
        pack_calls.clear()
    ids, mask = _prompts()
    sp = S.SamplingParams(max_new_tokens=5, temperature=0.9)
    out = S.generate(params, CFG, torch.Generator().manual_seed(3), ids, mask, sp,
                     decode_params=qp, sampler_impl="fused", device="cpu")
    assert len(pack_calls) == (0 if prepacked else 1)
    plain = S.generate(params, CFG, torch.Generator().manual_seed(3), ids, mask, sp,
                       decode_params=qp, sampler_impl="xla", device="cpu")
    assert torch.equal(out.response_ids, plain.response_ids)


def test_fused_sampler_refuses_unpacked_decode_params():
    qp = quantize_params(M.init_params(CFG, 2, device="cpu"))
    with pytest.raises(ValueError, match="with_packed_lm_head"):
        S._sample_hidden(qp, CFG, torch.Generator(), torch.zeros((2, CFG.hidden_size)),
                         S.SamplingParams(), True)


def test_continuous_engine_packs_when_it_quantizes(pack_calls):
    from rlinf_tpu_torch.data.io_struct import RolloutRequest
    from rlinf_tpu_torch.rollout.continuous_engine import ContinuousBatchingEngine

    params = M.init_params(CFG, 4, device="cpu")
    sp = S.SamplingParams(max_new_tokens=4, temperature=1.0, eos_token_id=-1)
    eng = ContinuousBatchingEngine(CFG, sp, num_slots=2, prompt_bucket=8, decode_chunk=2,
                                   weight_quant="int8", sampler_impl="fused", device="cpu")
    r = np.random.default_rng(5)
    req = RolloutRequest(prompt_ids=[list(map(int, r.integers(1, 300, n))) for n in (3, 6, 5)])
    res = eng.rollout(params, req, torch.Generator().manual_seed(1))
    assert len(pack_calls) == 1
    assert (res.response_mask.sum(1) == 4).all()
    _, dparams = eng.prepare_params(params)
    assert "lm_head_packed" in dparams and len(pack_calls) == 2


def test_static_engine_packs_once_per_rollout(pack_calls, monkeypatch):
    """The static engine quantizes the decode weights once per rollout, and
    generate packs their head once before its loop (the fused sampler is
    forced here: on the CPU the dispatch picks the logits path)."""
    from rlinf_tpu_torch.data.io_struct import RolloutRequest
    from rlinf_tpu_torch.rollout.engine import RolloutEngine

    monkeypatch.setattr(S, "_fused_sampler_ok", lambda *a: True)
    params = M.init_params(CFG, 6, device="cpu")
    eng = RolloutEngine(CFG, S.SamplingParams(max_new_tokens=4, greedy=True), prompt_bucket=8,
                        weight_quant="int8", device="cpu")
    req = RolloutRequest(prompt_ids=[[5, 6, 7], [8, 9]])
    eng.rollout(params, req, torch.Generator())
    eng.rollout(params, req, torch.Generator())
    assert len(pack_calls) == 2
