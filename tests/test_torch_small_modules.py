"""The port's small LLM-side modules against the JAX package's, on the CPU:
GRPO down-sampling, the loss-scale stages, the priority store, the parity
harness, the model registry, ``token_logprobs_from_logits``, the FLOP and
roofline counts, the step profiler, the metric logger's backends and the
packages' exports.

Inputs are made from a seed with numpy. The numpy modules must agree
exactly (f32 arrays within 1e-6); ``token_logprobs_from_logits`` within
1e-5 in f32; every FLOP count and roofline time within 1e-12 relative on
the same explicit ``ChipSpec`` values.
"""

import dataclasses
import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlinf_tpu.algorithms import loss_scales as jls
from rlinf_tpu.data import down_sampling as jdown
from rlinf_tpu.data import priority_store as jps
from rlinf_tpu.models.llm import LLMConfig as JLLMConfig
from rlinf_tpu.ops import logprobs as jlogprobs
from rlinf_tpu.utils import flops as jflops
from rlinf_tpu.utils import metrics as jmetrics
from rlinf_tpu.utils import parity as jparity
from rlinf_tpu_torch import models as tmodels
from rlinf_tpu_torch.algorithms import loss_scales as tls
from rlinf_tpu_torch.data import down_sampling as tdown
from rlinf_tpu_torch.data import priority_store as tps
from rlinf_tpu_torch.models.llm.config import LLMConfig
from rlinf_tpu_torch.ops import logprobs as tlogprobs
from rlinf_tpu_torch.utils import flops as tflops
from rlinf_tpu_torch.utils import metrics as tmetrics
from rlinf_tpu_torch.utils import parity as tparity
from rlinf_tpu_torch.utils.profiler import ProfilerConfig, StepProfiler, annotate

# ---------------------------------------------------------------------------
# down-sampling
# ---------------------------------------------------------------------------

TEXTS = [
    "<tool_response>ok</tool_response><answer>1</answer>",
    "<tool_response>Error: x</tool_response><tool_response>fine</tool_response>",
    "<|im_start|>assistant <answer>2</answer><|im_end|>",
    "<|im_start|>assistant a<|im_end|><|im_start|>assistant <answer>3</answer><|im_end|>",
    "<answer>1</answer><answer>2</answer>",
    "<answer>open",
    "",
    "no tags at all",
]

DOWN_CFGS = [
    {}, {"reject_equal_reward": True}, {"down_sample_to_n": 2},
    {"down_sample_to_n": 3, "roc_error_ratio": True, "roc_answer_format": True},
    {"down_sample_to_n": 2, "min_zero_reward_trace_num": 1, "min_non_zero_reward_trace_num": 1},
    {"reject_equal_reward": True, "down_sample_to_n": 4, "roc_error_ratio": True},
    {"down_sample_to_n": 5}, {"down_sample_to_n": 1, "min_zero_reward_trace_num": 3},
]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("cfg", DOWN_CFGS)
def test_down_sampling_matches_jax(seed, cfg):
    rng = np.random.default_rng(seed)
    group = 4
    rewards = rng.choice([0.0, 0.0, 1.0, 0.5], size=24).astype(np.float32)
    rewards[:4] = 1.0                      # one group of equal rewards
    texts = [TEXTS[i] for i in rng.integers(0, len(TEXTS), 24)]
    for with_texts in (True, False):
        t = texts if with_texts else None
        got = tdown.down_sample_mask(rewards, group, cfg, t)
        np.testing.assert_array_equal(got, jdown.down_sample_mask(rewards, group, cfg, t))
    np.testing.assert_array_equal(tdown.reject_equal_reward_mask(rewards, group),
                                  jdown.reject_equal_reward_mask(rewards, group))
    np.testing.assert_array_equal(tdown.group_uids(24, group), jdown.group_uids(24, group))


@pytest.mark.parametrize("text", TEXTS)
def test_down_sampling_penalties_match_jax(text):
    assert tdown.tool_error_ratio(text) == jdown.tool_error_ratio(text)
    assert tdown.answer_tag_penalty(text) == jdown.answer_tag_penalty(text)
    assert tdown.answer_tag_penalty(text, ["<answer>"]) == jdown.answer_tag_penalty(
        text, ["<answer>"])


# ---------------------------------------------------------------------------
# loss scales
# ---------------------------------------------------------------------------


def _scale_batch(seed):
    rng = np.random.default_rng(seed)
    n = 20
    return {
        "idx_to_traj": np.sort(rng.integers(0, 5, n)),
        "idx_to_sub_traj": rng.integers(0, 3, n),
        "advantages": rng.normal(size=(n, 7)).astype(np.float32),
        "response_mask": rng.random((n, 7)) < 0.6,
    }


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("names", [["group_level"], ["group_level", "agent_level"],
                                   ["group_level", "agent_level", "turn_level"]])
def test_loss_scales_match_jax(seed, names):
    ctx = {"actor_global_batch_size": 32, "data_parallel_world_size": 2}
    got = tls.apply_loss_scales(names, dict(ctx), _scale_batch(seed))
    want = jls.apply_loss_scales(names, dict(ctx), _scale_batch(seed))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0, err_msg=k)
    assert got["loss_scales"].dtype == np.float32


@pytest.mark.parametrize("names", [["agent_level"], ["group_level", "turn_level"],
                                   ["group_level", "group_level"], ["nope"]])
def test_loss_scale_ordering_contract_matches_jax(names):
    errors = []
    for mod in (tls, jls):
        with pytest.raises((AssertionError, KeyError)) as e:
            mod.apply_loss_scales(names, {"actor_global_batch_size": 8}, _scale_batch(0))
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1]
    assert sorted(tls._LOSS_SCALE_REGISTRY) == sorted(jls._LOSS_SCALE_REGISTRY)


# ---------------------------------------------------------------------------
# priority store
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Traj:
    versions: np.ndarray


@pytest.mark.parametrize("seed", range(4))
def test_priority_store_matches_jax(seed):
    rng = np.random.default_rng(seed)
    stores = [tps.PriorityStore(6), jps.PriorityStore(6)]
    outs = [[], []]
    for step in range(60):
        op = rng.integers(0, 10)
        prio = (float(rng.integers(0, 5)), float(rng.integers(0, 5)))
        data = Traj(rng.integers(0, 4, (2, 3)).astype(np.float32))
        n, thr = int(rng.integers(1, 4)), float(rng.integers(0, 4))
        for s, out in zip(stores, outs):
            if op < 6:
                out.append(s.add(prio, (step, data)))
            elif op < 8:
                out.append([d[0] for d in s.topn(n)])
            elif op < 9:
                s.remove_below(thr)
            metric = s.get_metric()
            out.append((len(s), json.dumps(
                {str(k): v for k, v in metric.items()}, sort_keys=True)))
    assert outs[0] == outs[1]
    assert any(isinstance(o, bool) and not o for o in outs[0])   # some adds refused


# ---------------------------------------------------------------------------
# parity harness
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_parity_harness_matches_jax(seed, tmp_path):
    rng = np.random.default_rng(seed)
    base = np.cumsum(rng.normal(0.1, 0.3, 40))
    run = base + rng.normal(0, 0.4, 40) - (0.5 if seed == 2 else 0.0)
    for kw in ({}, {"smooth_window": 1}, {"min_spearman": 0.95, "max_final_gap": 0.01}):
        got = tparity.compare_to_baseline(run[: 30 + seed], base, **kw)
        want = jparity.compare_to_baseline(run[: 30 + seed], base, **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    ties = np.round(run, 0)
    assert tparity.spearman(ties, base) == jparity.spearman(ties, base)
    assert tparity.spearman([1.0], [2.0]) != tparity.spearman([1.0], [2.0])   # nan
    assert tparity.spearman([1, 1, 1], [2, 2, 2]) == jparity.spearman([1, 1, 1], [2, 2, 2]) == 1.0
    path = tmp_path / "metrics.jsonl"
    path.write_text("".join(json.dumps({"step": i, **({"r": float(v)} if i % 3 else {})}) + "\n"
                            for i, v in enumerate(run)))
    for a, b in zip(tparity.load_metric_series(str(path), "r"),
                    jparity.load_metric_series(str(path), "r")):
        np.testing.assert_array_equal(a, b)
    tparity.save_baseline(str(tmp_path / "b" / "base.json"), base, {"seed": seed})
    assert tparity.load_baseline(str(tmp_path / "b" / "base.json")) == jparity.load_baseline(
        str(tmp_path / "b" / "base.json")) == [float(v) for v in base]
    for log in ("CUDA out of memory", "loss=nan here", "Traceback (most recent call last):",
                "all good", "RESOURCE_EXHAUSTED"):
        assert tparity.classify_log(log) == jparity.classify_log(log)


# ---------------------------------------------------------------------------
# model registry, logprobs
# ---------------------------------------------------------------------------


def test_model_registry():
    import rlinf_tpu.models as jmodels

    for mod in (tmodels, jmodels):
        @mod.register_model("port_test_model")
        def factory(width, *, depth=1):
            return ("model", width, depth)

        assert mod.get_model("port_test_model", 8, depth=2) == ("model", 8, 2)
        assert "port_test_model" in mod.list_models()
        assert mod.list_models() == sorted(mod.list_models())
    with pytest.raises(KeyError) as got:
        tmodels.get_model("nope_model")
    with pytest.raises(KeyError) as want:
        jmodels.get_model("nope_model")
    assert str(got.value).split(";")[0] == str(want.value).split(";")[0]


@pytest.mark.parametrize("temperature", [1.0, 0.7])
@pytest.mark.parametrize("shape", [(5, 33), (2, 3, 64)])
def test_token_logprobs_from_logits_matches_jax(temperature, shape):
    rng = np.random.default_rng(len(shape))
    logits = (rng.normal(size=shape) * 3).astype(np.float32)
    targets = rng.integers(0, shape[-1], shape[:-1]).astype(np.int32)
    got = tlogprobs.token_logprobs_from_logits(torch.from_numpy(logits),
                                               torch.from_numpy(targets), temperature)
    want = jlogprobs.token_logprobs_from_logits(jnp.asarray(logits), jnp.asarray(targets),
                                                temperature)
    assert got.dtype == torch.float32 and got.shape == targets.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    half = tlogprobs.token_logprobs_from_logits(torch.from_numpy(logits).bfloat16(),
                                                torch.from_numpy(targets).long())
    assert half.dtype == torch.float32


# ---------------------------------------------------------------------------
# FLOP counts and rooflines
# ---------------------------------------------------------------------------

FLOP_CONFIGS = [
    dict(),                                                       # Qwen2.5-0.5B's defaults
    dict(vocab_size=151936, hidden_size=1536, intermediate_size=8960, num_layers=28,
         num_heads=12, num_kv_heads=2),
    dict(vocab_size=1000, hidden_size=64, intermediate_size=96, num_layers=3, num_heads=4,
         num_kv_heads=2, head_dim=32, num_experts=8, num_experts_per_token=2),
]


def _close(a, b):
    assert a == pytest.approx(b, rel=1e-12, abs=0), (a, b)


@pytest.mark.parametrize("kw", FLOP_CONFIGS)
def test_flops_match_jax(kw):
    tcfg, jcfg = LLMConfig(**kw), JLLMConfig(**kw)
    spec = dict(name="card", bf16_flops=7.5e14, hbm_bw=2.5e12, hbm_bytes=64e9)
    tchip, jchip = tflops.ChipSpec(**spec), jflops.ChipSpec(**spec)
    _close(tflops.model_matmul_flops_per_token(tcfg), jflops.model_matmul_flops_per_token(jcfg))
    _close(tflops.trunk_flops_per_token(tcfg), jflops.trunk_flops_per_token(jcfg))
    for s, kv in ((1, 17.5), (512, 256.0)):
        _close(tflops.attention_flops(tcfg, s, kv), jflops.attention_flops(jcfg, s, kv))
    for b, s in ((1, 128), (64, 768)):
        for name in ("train_step_flops", "prefill_flops"):
            _close(getattr(tflops, name)(tcfg, b, s), getattr(jflops, name)(jcfg, b, s))
        _close(tflops.decode_step_bytes(tcfg, b, s), jflops.decode_step_bytes(jcfg, b, s))
        _close(tflops.decode_sol_time(tcfg, tchip, b, s), jflops.decode_sol_time(jcfg, jchip, b, s))
        _close(tflops.train_sol_time(tcfg, tchip, b, s), jflops.train_sol_time(jcfg, jchip, b, s))
        _close(tflops.train_mfu(tcfg, tchip, b, s, 0.37), jflops.train_mfu(jcfg, jchip, b, s, 0.37))
    _close(tflops.vit_encode_flops(768, 12, 256), jflops.vit_encode_flops(768, 12, 256))
    _close(tflops.vit_encode_flops(384, 6, 64, 3), jflops.vit_encode_flops(384, 6, 64, 3))
    pi0 = dict(batch=4, num_patches=256, text_len=48, expert_hidden=1024, expert_ffn=4096,
               action_chunk=50, num_flow_steps=10, vit_hidden=1152, vit_layers=27,
               param_bytes=6.5e9)
    _close(tflops.pi0_rollout_sol_time(tcfg, tchip, **pi0),
           jflops.pi0_rollout_sol_time(jcfg, jchip, **pi0))
    vla = dict(batch=2, num_patches=256, text_len=32, action_tokens=7, vit_hidden=1024,
               vit_layers=24, n_vits=2)
    _close(tflops.openvla_decode_sol_time(tcfg, tchip, **vla),
           jflops.openvla_decode_sol_time(jcfg, jchip, **vla))


def test_h100_chip_spec():
    chip = tflops.ChipSpec.h100()
    assert (chip.bf16_flops, chip.hbm_bw, chip.hbm_bytes) == (989e12, 3.35e12, 80e9)
    assert [f.name for f in dataclasses.fields(chip)] == [
        f.name for f in dataclasses.fields(jflops.ChipSpec)]
    assert not hasattr(tflops.ChipSpec, "v5e") and not hasattr(tflops.ChipSpec, "v5p")


# ---------------------------------------------------------------------------
# the step profiler and the metric logger
# ---------------------------------------------------------------------------


def _steps(prof, n):
    x = torch.ones(64, 64)
    for i in range(n):
        prof.step_start()
        with annotate(f"my_step_{i}"):
            x = (x @ x).tanh()
        prof.step_end()


@pytest.mark.parametrize("start,num", [(1, 2), (0, 1), (3, 5)])
def test_step_profiler_traces_its_window_only(tmp_path, start, num):
    """A trace of steps [start, start + num), one file, holding the
    annotations of those steps and no others; ``close`` ends a window the
    run did not reach the end of."""
    prof = StepProfiler(ProfilerConfig(enabled=True, output_dir=str(tmp_path), start_step=start,
                                       num_steps=num))
    _steps(prof, 4)
    prof.close()
    last = min(start + num, 4) - 1
    assert os.listdir(tmp_path) == [f"trace_steps_{start}-{last}.json"]
    assert prof.trace_path == str(tmp_path / f"trace_steps_{start}-{last}.json")
    names = {e.get("name") for e in json.loads(open(prof.trace_path).read())["traceEvents"]}
    assert {f"my_step_{i}" for i in range(4)} & names == {
        f"my_step_{i}" for i in range(start, last + 1)}
    assert any(e.key == f"my_step_{start}" for e in prof.profile.key_averages())


def test_step_profiler_disabled_or_never_reached(tmp_path):
    for cfg in (ProfilerConfig(enabled=False, output_dir=str(tmp_path / "a"), start_step=0),
                ProfilerConfig(enabled=True, output_dir=str(tmp_path / "b"), start_step=9)):
        prof = StepProfiler(cfg)
        _steps(prof, 4)
        prof.close()
        assert not os.path.exists(cfg.output_dir) and prof.trace_path is None
    assert [f.name for f in dataclasses.fields(ProfilerConfig)] == [
        "enabled", "output_dir", "start_step", "num_steps"]
    assert ProfilerConfig() == ProfilerConfig(False, "profiles", 3, 2)


def test_metric_logger_backends(tmp_path):
    """TensorBoard writes its event file beside metrics.jsonl; an unknown
    backend raises as in the JAX package; tensors and unconvertible values
    are handled."""
    log = tmetrics.MetricLogger(str(tmp_path), use_tensorboard=True, print_every=0)
    assert log._tb is not None
    log.log({"a": 1.5, "b": torch.tensor(2.0), "c": np.float32(3.0), "skip": "text"}, 1)
    log.log({"a": 2.5}, 2)
    log.close()
    assert any(n.startswith("events.out.tfevents") for n in os.listdir(tmp_path))
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [{k: v for k, v in r.items() if k != "time"} for r in rows] == [
        {"step": 1, "a": 1.5, "b": 2.0, "c": 3.0}, {"step": 2, "a": 2.5}]
    errors = []
    for mod in (tmetrics, jmetrics):
        with pytest.raises(ValueError) as e:
            mod.MetricLogger(str(tmp_path), backends=["tensorboard", "mlflow"])
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "mlflow" in errors[0]
    assert tmetrics.MetricLogger.supported_backends == jmetrics.MetricLogger.supported_backends
    quiet = tmetrics.MetricLogger(None, backends=["tensorboard"])
    assert quiet._tb is None and quiet._jsonl is None


# ---------------------------------------------------------------------------
# the packages' exports
# ---------------------------------------------------------------------------

#: names the port leaves to a later slice, by JAX module: each is named in
#: the port package's docstring (none at present)
NOT_YET = {}


def _public(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n, v in vars(mod).items() if not n.startswith("_") and callable(v)
                 and getattr(v, "__module__", "") == mod.__name__]
    return set(names)


@pytest.mark.parametrize("package", ["ops", "data", "models", "agents", "algorithms",
                                     "algorithms.rewards", "training", "models.llm",
                                     "models.vlm", "models.embodiment", "runners", "rollout",
                                     "parallel", "utils", "toolkits", "envs"])
def test_exports_match_the_jax_package(package):
    jmod = importlib.import_module(f"rlinf_tpu.{package}")
    tmod = importlib.import_module(f"rlinf_tpu_torch.{package}")
    want = _public(jmod) - NOT_YET.get(jmod.__name__, set())
    missing = sorted(n for n in want if not hasattr(tmod, n))
    assert not missing, f"rlinf_tpu_torch.{package} lacks {missing}"
    assert want <= _public(tmod) | set(dir(tmod))
    doc = tmod.__doc__ or ""
    for name in NOT_YET.get(jmod.__name__, ()):
        assert name in doc, name
