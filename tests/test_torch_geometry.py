"""Model geometries the port's kernels refuse, refused where a path is built.

The attention kernels take head dims 16, 32, 64 and 128 and a bounded
number of query heads per kv head (G); the decode megakernel also needs widths its
64-column weight tiles cut (its hidden size has no bound of its own). ``ops/cuda/geometry.check_kernel_geometry`` holds those
limits, and the engines, ``generate``, the train step and the recompute
call it when they are built on the card, before any prompt or batch is
touched. The card is simulated here (``torch.cuda.is_available`` patched to
True): each refusal must come from a constructor, with nothing yet placed
on a device. On the CPU nothing is refused: the plain versions run any
geometry. Also K10's split plan, which the wrapper computes on the host.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rlinf_tpu_torch.config import load_config, resolve_attn_impl
from rlinf_tpu_torch.models.llm.config import LLMConfig
from rlinf_tpu_torch.models.llm.sampler import SamplingParams, generate
from rlinf_tpu_torch.ops.cuda import decode_attention as DA
from rlinf_tpu_torch.ops.cuda import decode_megakernel as MK
from rlinf_tpu_torch.ops.cuda import paged_attention as PA
from rlinf_tpu_torch.ops.cuda.geometry import LIMITS, PATHS, check_kernel_geometry
from rlinf_tpu_torch.rollout.continuous_engine import ContinuousBatchingEngine
from rlinf_tpu_torch.rollout.engine import RolloutEngine
from rlinf_tpu_torch.rollout.paged_engine import PagedContinuousEngine
from rlinf_tpu_torch.training.learner import (
    make_logprob_fn, make_policy_grad_and_apply, make_policy_train_step,
)


def _cfg(heads=12, kv=2, head_dim=128, hidden=1536):
    return LLMConfig(vocab_size=512, hidden_size=hidden, intermediate_size=512, num_layers=2,
                     num_heads=heads, num_kv_heads=kv, head_dim=head_dim, max_seq_len=256)


HD96 = _cfg(heads=16, kv=2, head_dim=96)
G16 = _cfg(heads=32, kv=2, head_dim=64, hidden=2048)
#: heads every kernel takes, an intermediate size K9's 64-column tiles do not cut
F1000 = dataclasses.replace(_cfg(), intermediate_size=1000)


@pytest.fixture
def card(monkeypatch):
    """A card as far as the constructors can tell: device="cuda" resolves."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_head_dim_96_is_refused_on_every_kernel_path(path):
    with pytest.raises(ValueError, match="Hd=96"):
        check_kernel_geometry(HD96, path)


@pytest.mark.parametrize("path,takes", [("decode", False), ("mega", False), ("paged", True),
                                        ("flash", True)])
def test_a_group_of_16_query_heads(path, takes):
    """The decode path (K2 takes 16 query heads a kv head, K3 8) and K9
    refuse 16; K10 takes 16, K1/K7/K8 any."""
    if takes:
        check_kernel_geometry(G16, path)
    else:
        with pytest.raises(ValueError, match="at most 8 query heads"):
            check_kernel_geometry(G16, path)


def test_the_limits_are_the_wrappers():
    """One table of limits: the megakernel's constant and the wrappers'
    checks read it (a G=16 paged call passes the head check and stops at
    the tensor check; G=17 stops at the heads)."""
    assert MK.MAX_GROUP == LIMITS["decode_megakernel"][1] == 8
    assert LIMITS["paged_attention"][1] == 16
    meta = lambda *s: torch.empty(s, dtype=torch.bfloat16, device="meta")
    table = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    lengths = torch.zeros((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        PA.paged_attention(meta(2, 32, 64), meta(9, 2, 16, 64), meta(9, 2, 16, 64), table, lengths)
    with pytest.raises(ValueError, match="unsupported H=34 Kv=2"):
        PA.paged_attention(meta(2, 34, 64), meta(9, 2, 16, 64), meta(9, 2, 16, 64), table, lengths)
    with pytest.raises(ValueError, match="page size 12"):
        PA.paged_attention(meta(2, 32, 64), meta(9, 2, 12, 64), meta(9, 2, 12, 64), table, lengths)


def test_qwen2_7b_plan_is_refused_by_the_megakernel():
    """Qwen2-7B (D=3584) is taken on the megakernel's path now that K9
    stages K-slices of its activations; a geometry K9 still refuses (more
    than 8 query heads a kv head, widths its tiles do not cut) is refused
    with the limit named."""
    MK._check_geometry(MK.make_plan(LLMConfig.qwen2_7b(), 3584))
    check_kernel_geometry(LLMConfig.qwen2_7b(), "mega")
    check_kernel_geometry(LLMConfig.qwen2_7b(), "decode")      # the per-layer kernels take it
    check_kernel_geometry(LLMConfig.qwen2_1_5b(), "mega")
    with pytest.raises(ValueError, match="decode_megakernel: unsupported H=32 Kv=2"):
        check_kernel_geometry(G16, "mega")
    with pytest.raises(ValueError, match="intermediate 1000 not a multiple of its 64-column"):
        check_kernel_geometry(F1000, "mega")
    check_kernel_geometry(F1000, "decode")


_MEGA = dict(num_slots=8, max_seq_len=256, weight_quant="int8", kv_quant="int8")


@pytest.mark.parametrize("use_mega", [True, "auto"])
def test_continuous_engine_refuses_the_megakernel_for_qwen2_7b(card, use_mega):
    """Qwen2-7B now builds with the megakernel on the card. A geometry K9
    refuses is refused in the constructor, before any prompt; "auto" does
    not quietly fall back to the per-layer kernels, and the message names
    the way that runs."""
    eng = ContinuousBatchingEngine(LLMConfig.qwen2_7b(), SamplingParams(), use_mega=use_mega,
                                   device="cuda", **_MEGA)
    assert eng.device.type == "cuda"
    with pytest.raises(ValueError, match="use_mega=False"):
        ContinuousBatchingEngine(F1000, SamplingParams(), use_mega=use_mega, device="cuda",
                                 **_MEGA)
    eng = ContinuousBatchingEngine(F1000, SamplingParams(), use_mega=False, device="cuda",
                                   **_MEGA)
    assert eng.device.type == "cuda"


def test_on_the_cpu_nothing_is_refused():
    ContinuousBatchingEngine(LLMConfig.qwen2_7b(), SamplingParams(), use_mega=True,
                             device="cpu", **_MEGA)
    ContinuousBatchingEngine(HD96, SamplingParams(), attn_impl="pallas", device="cpu")
    RolloutEngine(HD96, SamplingParams(), attn_impl="pallas", device="cpu")


@pytest.mark.parametrize("build", [
    lambda cfg: ContinuousBatchingEngine(cfg, SamplingParams(), device="cuda"),
    lambda cfg: ContinuousBatchingEngine(cfg, SamplingParams(), attn_impl="pallas",
                                         decode_attn_impl="xla", device="cuda"),
    lambda cfg: RolloutEngine(cfg, SamplingParams(), device="cuda"),
    lambda cfg: RolloutEngine(cfg, SamplingParams(), attn_impl="pallas", decode_attn_impl="xla",
                              device="cuda"),
    lambda cfg: PagedContinuousEngine(cfg, SamplingParams(), attn_impl="pallas", device="cuda"),
    lambda cfg: make_policy_train_step(cfg, None, None, attn_impl="pallas", device="cuda"),
    lambda cfg: make_policy_grad_and_apply(cfg, None, None, attn_impl="pallas", device="cuda"),
    lambda cfg: make_logprob_fn(cfg, attn_impl="pallas", device="cuda"),
], ids=["continuous-decode", "continuous-prefill", "static-decode", "static-prefill", "paged",
        "train-step", "grad-and-apply", "logprob"])
def test_head_dim_96_is_refused_where_each_path_is_built(card, build):
    with pytest.raises(ValueError, match="Hd=96"):
        build(HD96)


def test_generate_refuses_before_touching_its_prompts(card):
    """The params live on the CPU here: the geometry is refused first."""
    params = {"embed": torch.zeros(1)}
    prompts = np.zeros((2, 8), np.int32)
    mask = np.ones((2, 8), bool)
    sp = SamplingParams(max_new_tokens=2)
    with pytest.raises(ValueError, match="Hd=96"):
        generate(params, HD96, torch.Generator(), prompts, mask, sp, attn_impl="pallas",
                 decode_attn_impl="xla", device="cuda")
    with pytest.raises(ValueError, match="decode_attention_bf16: unsupported"):
        generate(params, HD96, torch.Generator(), prompts, mask, sp, device="cuda")
    with pytest.raises(ValueError, match="not a multiple of its 64-column"):
        generate(params, F1000, torch.Generator(), prompts, mask, sp,
                 kv_quant="int8", mega=(MK.make_plan(F1000), None), device="cuda")
    with pytest.raises(ValueError, match="params live on"):    # a geometry the kernels take
        generate(params, G16, torch.Generator(), prompts, mask, sp, attn_impl="pallas",
                 decode_attn_impl="xla", device="cuda")
    with pytest.raises(ValueError, match="params live on"):    # Qwen2-7B on the megakernel
        generate(params, LLMConfig.qwen2_7b(), torch.Generator(), prompts, mask, sp,
                 kv_quant="int8", mega=(MK.make_plan(LLMConfig.qwen2_7b(), 3584), None),
                 device="cuda")


def test_paged_engine_takes_16_query_heads_and_refuses_odd_pages(card):
    PagedContinuousEngine(G16, SamplingParams(), attn_impl="pallas", device="cuda")
    PagedContinuousEngine(G16, SamplingParams(), page_size=32, attn_impl="pallas", device="cuda")
    with pytest.raises(ValueError, match="page size 12"):
        PagedContinuousEngine(G16, SamplingParams(), prompt_bucket=48, page_size=12,
                              attn_impl="pallas", device="cuda")
    with pytest.raises(ValueError, match="page size 128"):
        PagedContinuousEngine(_cfg(), SamplingParams(), prompt_bucket=128, page_size=128,
                              attn_impl="pallas", device="cuda")


def test_auto_attention_refuses_a_head_dim_the_kernels_do_not_take():
    """A long-context run of grpo_demo_tiny.yaml's model resolves "auto" to
    the kernels on the card at its shipped head dim (16); at a head dim no
    kernel takes (96) it is refused there, and on the CPU it is "xla"."""
    cfg = load_config("examples/reasoning/config/grpo_demo_tiny.yaml", ["attn_impl=auto"])
    long = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, max_prompt_len=2048),
                               model=dataclasses.replace(cfg.model, max_seq_len=4096))
    assert long.model.head_dim_ == 16
    assert resolve_attn_impl(long, device="cuda") == "pallas"
    odd = dataclasses.replace(long, model=dataclasses.replace(long.model, head_dim=96))
    with pytest.raises(ValueError, match="Hd=96"):
        resolve_attn_impl(odd, device="cuda")
    assert resolve_attn_impl(long, device="cpu") == "xla"


SHIPPED = {
    "grpo_demo_tiny.yaml": lambda: load_config(
        "examples/reasoning/config/grpo_demo_tiny.yaml").model,
    "ppo_separate_critic.yaml": lambda: load_config(
        "examples/reasoning/config/ppo_separate_critic.yaml").model,
    "grpo_math_qwen05b.yaml": lambda: load_config(
        "examples/reasoning/config/grpo_math_qwen05b.yaml").model,
    "tiny preset": lambda: LLMConfig.tiny(vocab_size=300, max_seq_len=512),
}


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("name", sorted(SHIPPED))
def test_shipped_models_are_taken_on_every_kernel_path(name, path):
    """The three shipped reasoning yamls (Hd 16, 32 and 64; f32 and bf16)
    and the tiny preset of main_agent_grpo and serve_openai (Hd=16, f32)
    pass every kernel path's check, pages of 16 tokens on the paged one."""
    check_kernel_geometry(SHIPPED[name](), path, page_size=16 if path == "paged" else None)


@pytest.mark.parametrize("head_dim", [16, 32])
def test_small_head_dims_build_every_path_on_the_card(card, head_dim):
    """Models with heads of 16 and 32 build the engines, the train step and
    the recompute on the card (the checks run where each path is built)."""
    cfg = _cfg(heads=4, kv=2, head_dim=head_dim, hidden=4 * head_dim)
    ContinuousBatchingEngine(cfg, SamplingParams(), device="cuda")
    RolloutEngine(cfg, SamplingParams(), attn_impl="pallas", device="cuda")
    PagedContinuousEngine(cfg, SamplingParams(), attn_impl="pallas", device="cuda")
    make_policy_train_step(cfg, None, None, attn_impl="pallas", device="cuda")
    make_logprob_fn(cfg, attn_impl="pallas", device="cuda")


def _row_splits(length, page_size, pps):
    """The page ranges [first, end) of the splits that do work for a row of
    ``length`` tokens, by the rule of csrc/paged_attention.cu: split s
    covers pages [s pps, min((s + 1) pps, n)) of the row's n, and a split
    whose first page is past the last returns at once."""
    n = -(-length // page_size)
    return [(lo, min(lo + pps, n)) for lo in range(0, n, pps)]


@pytest.mark.parametrize("rows,max_pages,sms", [(128, 48, 132), (16, 48, 132), (2, 5, 132),
                                                (128, 1, 132), (300, 48, 132)])
def test_k10_split_plan_covers_every_valid_page_once(rows, max_pages, sms):
    """Every valid page of every row lies in exactly one split that works, a
    row of length 0 has none, the splits span the table, and the grid
    covers the SMs CTAS_PER_SM times unless that would cut splits below
    MIN_SPLIT_UNITS pages (split_plan is K3's too)."""
    pps, splits = PA.split_plan(rows, max_pages, sms)
    assert pps * splits >= max_pages > pps * (splits - 1)
    assert rows * splits >= DA.CTAS_PER_SM * sms or pps == min(max_pages, DA.MIN_SPLIT_UNITS)
    r = np.random.default_rng(rows + max_pages)
    for page_size in (8, 16, 32):
        full = max_pages * page_size                       # the kernel clamps lengths to it
        lengths = [0, 1, page_size, min(page_size + 1, full), full,
                   *r.integers(0, full + 1, 20)]
        for length in lengths:
            ranges = _row_splits(int(length), page_size, pps)
            covered = [p for lo, hi in ranges for p in range(lo, hi)]
            assert covered == list(range(-(-int(length) // page_size)))
            assert len(ranges) <= splits
            assert all(lo % pps == 0 and lo < hi for lo, hi in ranges)
            if length == 0:
                assert ranges == []
