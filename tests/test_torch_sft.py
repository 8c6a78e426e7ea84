"""The port's SFT (``training/sft.py``, ``runners/sft_runner.py`` and
``main_sft``) against the JAX package's, on the CPU at ``LLMConfig.tiny``
(2 layers, D=64) and ``grpo_demo_tiny.yaml`` (fp32, byte tokenizer).

One JAX init feeds both sides through ``params_from_numpy``; batches are
drawn with numpy from a seed. Tolerances are stated per test: fp32 on both
sides, so the two agree to summation-order rounding.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlinf_tpu import config as jconfig
from rlinf_tpu.data.datasets import PromptDataset as JDataset
from rlinf_tpu.data.datasets import PromptExample as JExample
from rlinf_tpu.data.tokenizers import ByteTokenizer as JTokenizer
from rlinf_tpu.models.llm import init_params as jinit_params
from rlinf_tpu.models.llm.config import LLMConfig as JConfig
from rlinf_tpu.runners.sft_runner import SFTRunner as JSFTRunner
from rlinf_tpu.training import sft as JSFT
from rlinf_tpu.training import train_state as JS
from rlinf_tpu_torch import config as tconfig
from rlinf_tpu_torch import main_sft
from rlinf_tpu_torch.data.datasets import PromptDataset, PromptExample
from rlinf_tpu_torch.data.tokenizers import ByteTokenizer
from rlinf_tpu_torch.models.llm.config import LLMConfig as TConfig
from rlinf_tpu_torch.models.llm.convert import params_from_numpy
from rlinf_tpu_torch.runners import SFTRunner
from rlinf_tpu_torch.training import sft as TSFT
from rlinf_tpu_torch.training import train_state as TS
from rlinf_tpu_torch.utils.checkpoint import flatten

torch.set_num_threads(2)

YAML = "examples/reasoning/config/grpo_demo_tiny.yaml"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _batch(cfg, B=4, T=24, seed=0):
    """SFT rows: a prompt then an answer, right-padded; the loss on the
    answer's tokens."""
    r = np.random.default_rng(seed)
    lens = r.integers(T // 2, T + 1, B)
    lens[0] = T
    attn = np.arange(T)[None, :] < lens[:, None]
    prompt = r.integers(2, 8, B)
    loss_mask = attn & (np.arange(T)[None, :] >= prompt[:, None] - 1)
    ids = np.where(attn, r.integers(0, cfg.vocab_size, (B, T)), 0).astype(np.int32)
    return {"input_ids": ids, "attention_mask": attn, "loss_mask": loss_mask,
            "target_ids": np.concatenate([ids[:, 1:], np.zeros((B, 1), np.int32)], 1)}


@pytest.mark.parametrize("num_microbatches", [1, 2])
def test_sft_train_step_three_steps_match_jax(num_microbatches):
    """Three make_sft_train_step calls (f32, adamw with eps 1e-3, remat)
    from one init on the same batches: every metric within 1e-5 relative
    (1e-7 absolute), the params after each step within 1e-5."""
    jcfg = dataclasses.replace(JConfig.tiny(), dtype="float32")
    tcfg = TConfig(**dataclasses.asdict(jcfg))
    opt = dict(lr=1e-3, eps=1e-3)
    jtx, ttx = JS.make_optimizer(JS.OptimizerConfig(**opt)), TS.make_optimizer(TS.OptimizerConfig(**opt))
    jp = jinit_params(jcfg, jax.random.PRNGKey(4))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    jstep = JSFT.make_sft_train_step(jcfg, jtx, num_microbatches=num_microbatches)
    tstep = TSFT.make_sft_train_step(tcfg, ttx, num_microbatches=num_microbatches,
                                     device="cpu")
    jstate = JS.TrainState(jnp.zeros((), jnp.int32), jp, jtx.init(jp))
    tstate = TS.TrainState(0, tp, ttx.init(tp))
    for step in range(3):
        b = _batch(tcfg, seed=20 + step)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, b)
        assert sorted(tm) == sorted(jm) == ["sft/grad_norm", "sft/loss", "sft/ppl",
                                            "sft/valid_tokens"]
        for k in jm:
            np.testing.assert_allclose(_np(tm[k]), _np(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)
        for got, want in zip(TS.tree_leaves(tstate.params),
                             jax.tree_util.tree_leaves(jstate.params)):
            np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)
    assert tstate.step == 3 and float(tm["sft/loss"]) > 0


def _examples(n=12):
    r = np.random.default_rng(7)
    return [(f"Q{i}: " + "word " * int(r.integers(1, 9)), "answer " * int(r.integers(1, 5)))
            for i in range(n)]


@pytest.mark.parametrize("seq_bucket", [8, 64])
def test_build_batch_equals_the_jax_runners(seq_bucket):
    """SFTRunner._build_batch on the same examples gives the JAX runner's
    arrays: prompts cut to max_prompt_len (20 bytes here), the answer and
    eos, T rounded up to seq_bucket, the loss from the last prompt token."""
    ov = ["data.max_prompt_len=20", "runner.log_dir=null", "runner.rollout_batch_size=4"]
    ex = _examples()
    jcfg = jconfig.load_config(YAML, ov)
    jr = JSFTRunner(jcfg, JTokenizer(), JDataset([JExample(p, a) for p, a in ex]),
                    seq_bucket=seq_bucket)
    tr = SFTRunner(tconfig.load_config(YAML, ov), ByteTokenizer(),
                   PromptDataset([PromptExample(p, a) for p, a in ex]), seq_bucket=seq_bucket,
                   device="cpu")
    for rows in (ex[:4], ex[4:]):
        want = jr._build_batch([JExample(p, a) for p, a in rows])
        got = tr._build_batch([PromptExample(p, a) for p, a in rows])
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
            assert got[k].dtype == np.asarray(want[k]).dtype
        assert got["input_ids"].shape[1] % seq_bucket == 0


def test_sft_runner_step_matches_the_jax_runner():
    """One run_step of both runners from one init on the same dataset: the
    same examples, every sft/* metric within 1e-5 relative, the params
    within 1e-5."""
    ov = ["runner.log_dir=null", "runner.rollout_batch_size=4", "optimizer.warmup_steps=0",
          "optimizer.lr=1e-3", "optimizer.eps=1e-3"]
    ex = _examples()
    jcfg = jconfig.load_config(YAML, ov)
    params = jinit_params(jcfg.model, jax.random.PRNGKey(0))
    jr = JSFTRunner(jcfg, JTokenizer(), JDataset([JExample(p, a) for p, a in ex]),
                    init_params_override=lambda rng: params)
    tcfg = tconfig.load_config(YAML, ov)
    tr = SFTRunner(tcfg, ByteTokenizer(), PromptDataset([PromptExample(p, a) for p, a in ex]),
                   device="cpu", init_params_override=lambda seed: params_from_numpy(
                       jax.tree_util.tree_map(np.asarray, params), tcfg.model, device="cpu"))
    assert tr.iterator.state_dict() == jr.iterator.state_dict()
    jm, tm = jr.run_step(), tr.run_step()
    assert set(jm) == set(tm)
    for k in jm:
        if k.startswith("sft/"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-7, err_msg=k)
    for got, want in zip(TS.tree_leaves(tr.state.params), jax.tree_util.tree_leaves(jr.state.params)):
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


def test_main_sft_runs_resumes_and_refuses_a_model_path(tmp_path):
    """main_sft on a jsonl of prompt/answer rows: two steps on the CPU with a
    checkpoint each and a metrics file; run again to step 3 it resumes at
    step 2 (the state bitwise the saved one) and takes one step; a
    ``--model-path`` that holds no checkpoint raises."""
    data = tmp_path / "sft.jsonl"
    data.write_text("\n".join(json.dumps({"prompt": p, "answer": a}) for p, a in _examples()))
    common = ["--config", YAML, "--data-path", str(data), "--device", "cpu",
              "runner.rollout_batch_size=4", "runner.save_interval=1",
              f"runner.checkpoint_dir={tmp_path / 'ck'}", f"runner.log_dir={tmp_path / 'logs'}"]
    first = main_sft.main([*common, "runner.max_steps=2"])
    assert len(first) == 2 and all(np.isfinite(h["sft/loss"]) for h in first)
    rows = [json.loads(line) for line in (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2]
    saved = torch.load(tmp_path / "ck" / "global_step_2" / "state.pt", weights_only=True)
    cfg = tconfig.load_config(YAML, common[7:])
    resumed = SFTRunner(cfg, ByteTokenizer(), PromptDataset.from_jsonl(str(data)), device="cpu")
    assert resumed.global_step == 2
    for k, v in flatten(resumed.state).items():
        assert torch.equal(v, saved[k]) if isinstance(v, torch.Tensor) else v == saved[k], k
    third = main_sft.main([*common, "runner.max_steps=3"])
    assert len(third) == 1 and np.isfinite(third[0]["sft/loss"])
    with pytest.raises(FileNotFoundError, match="config.json"):
        main_sft.main([*common, "--model-path", str(tmp_path)])


def test_gsm_synth_copy_gives_the_examples_problems():
    """The port's copy of gsm_synth gives the problems and SFT examples of
    examples/reasoning/gsm_synth.py for the same seeds."""
    import importlib.util
    import random
    from pathlib import Path

    from rlinf_tpu_torch.data import gsm_synth as T

    path = Path(__file__).resolve().parents[1] / "examples" / "reasoning" / "gsm_synth.py"
    spec = importlib.util.spec_from_file_location("gsm_synth_reference", path)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    for seed in range(3):
        a, b = random.Random(seed), random.Random(seed)
        assert [T.make_problem(a) for _ in range(50)] == [ref.make_problem(b) for _ in range(50)]
    got, want = T.build_sft_examples(40, seed=5), ref.build_sft_examples(40, seed=5)
    assert [(e.prompt, e.answer) for e in got] == [(e.prompt, e.answer) for e in want]
