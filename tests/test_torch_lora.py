"""The port's LoRA (``models/llm/lora.py``, ``training/lora_learner.py`` and
the reasoning runner's LoRA mode) against the JAX package's, on the CPU at
``LLMConfig.tiny`` (2 layers, D=64) and ``grpo_demo_tiny.yaml``.

The JAX side's adapters and base params, as numpy arrays, feed both sides:
the port draws its fresh adapters from a ``torch.Generator``, not JAX's
threefry. Tolerances are stated per test: f32 paths agree to
summation-order rounding.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlinf_tpu import config as jconfig
from rlinf_tpu.data import io_struct as jio
from rlinf_tpu.data.tokenizers import ByteTokenizer as JTokenizer
from rlinf_tpu.models.llm import init_params as jinit_params
from rlinf_tpu.models.llm import lora as JLORA
from rlinf_tpu.models.llm.config import LLMConfig as JConfig
from rlinf_tpu.runners.reasoning_runner import ReasoningRunner as JRunner
from rlinf_tpu.training import lora_learner as JLL
from rlinf_tpu.training import train_state as JS
from rlinf_tpu.training.learner import PolicyLossConfig as JLossConfig
from rlinf_tpu_torch import config as tconfig
from rlinf_tpu_torch import main_grpo
from rlinf_tpu_torch.data import io_struct as tio
from rlinf_tpu_torch.data.tokenizers import ByteTokenizer
from rlinf_tpu_torch.models.llm import lora as TLORA
from rlinf_tpu_torch.models.llm.config import LLMConfig as TConfig
from rlinf_tpu_torch.models.llm.convert import params_from_numpy
from rlinf_tpu_torch.runners import ReasoningRunner
from rlinf_tpu_torch.training import lora_learner as TLL
from rlinf_tpu_torch.training import train_state as TS
from rlinf_tpu_torch.training.learner import PolicyLossConfig
from rlinf_tpu_torch.utils.checkpoint import flatten

torch.set_num_threads(2)

YAML = "examples/reasoning/config/grpo_demo_tiny.yaml"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _configs(dtype="float32", tie=True):
    jcfg = dataclasses.replace(JConfig.tiny(), dtype=dtype, tie_word_embeddings=tie)
    return jcfg, TConfig(**dataclasses.asdict(jcfg))


def _adapters(jcfg, lcfg, seed):
    """JAX-initialised adapters with ``b`` drawn non-zero too, so that the
    merge adds a delta and ``a`` has a gradient from the first step."""
    lp = JLORA.init_lora_params(jcfg, lcfg, jax.random.PRNGKey(seed))
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: x if x.ndim and np.asarray(x).any() else
        jnp.asarray(r.normal(size=x.shape) * 0.05, x.dtype), lp)


def _tree_close(got, want, **tol):
    assert sorted(flatten(got)) == sorted(flatten(_to_numpy(want)))
    for k, v in flatten(_to_numpy(want)).items():
        np.testing.assert_allclose(_np(flatten(got)[k]), np.asarray(v, np.float32),
                                   err_msg=k, **tol)


MERGE_CASES = {
    # (dtype, tied lm head, targets)
    "f32_tied_default": ("float32", True, JLORA.DEFAULT_TARGETS),
    "f32_untied_lm_head": ("float32", False, JLORA.DEFAULT_TARGETS + ("lm_head",)),
    "f32_tied_lm_head": ("float32", True, ("wq", "down", "lm_head")),
    "bf16_untied_lm_head": ("bfloat16", False, JLORA.DEFAULT_TARGETS + ("lm_head",)),
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_lora_matches_jax(case):
    """merge_lora on the same base and adapters: f32 within rtol=1e-6
    (atol=1e-7); bf16 within one bf16 step (the f32 sums agree to 1e-6
    before the cast). Non-target leaves are the base's own tensors; a tied
    model with an lm_head target gains an explicit lm_head [D, V]."""
    dtype, tie, targets = MERGE_CASES[case]
    jcfg, tcfg = _configs(dtype, tie)
    lcfg = JLORA.LoRAConfig(enabled=True, rank=4, alpha=8.0, targets=targets)
    tlcfg = TLORA.LoRAConfig(**dataclasses.asdict(lcfg))
    jbase = jinit_params(jcfg, jax.random.PRNGKey(0))
    jl = _adapters(jcfg, lcfg, 1)
    tbase = params_from_numpy(_to_numpy(jbase), tcfg, device="cpu")
    tl = params_from_numpy({"embed": np.zeros((tcfg.vocab_size, tcfg.hidden_size)),
                            **_to_numpy(jl)}, tcfg, device="cpu")
    del tl["embed"]
    got = TLORA.merge_lora(tbase, tl, tlcfg)
    want = JLORA.merge_lora(jbase, jl, lcfg)
    tol = dict(rtol=1e-6, atol=1e-7) if dtype == "float32" else dict(rtol=2 ** -7, atol=1e-6)
    _tree_close(got, want, **tol)
    assert got["embed"] is tbase["embed"] and got["blocks"]["attn_norm"] is tbase["blocks"]["attn_norm"]
    assert ("lm_head" in got) == ("lm_head" in targets or not tie)
    if "lm_head" in targets:
        assert got["lm_head"].shape == (tcfg.hidden_size, tcfg.vocab_size)
        assert got["lm_head"].dtype == tcfg.compute_dtype


@pytest.mark.parametrize("targets", [JLORA.DEFAULT_TARGETS, ("wv", "up", "lm_head")])
def test_init_lora_params_shapes_and_zero_b(targets):
    """Fresh adapters have the JAX package's shapes and dtypes, b = 0 (the
    merged model is the base, bitwise), a ~ N(0, 1/d_in); the count of
    trainable params is the JAX package's; an unknown target raises on
    both sides."""
    jcfg, tcfg = _configs("bfloat16")
    lcfg = JLORA.LoRAConfig(enabled=True, rank=8, targets=targets)
    tlcfg = TLORA.LoRAConfig(**dataclasses.asdict(lcfg))
    want = jax.eval_shape(lambda: JLORA.init_lora_params(jcfg, lcfg, jax.random.PRNGKey(0)))
    got = TLORA.init_lora_params(tcfg, tlcfg, torch.Generator().manual_seed(0), device="cpu")
    fw, fg = flatten(_to_numpy(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                                      want))), flatten(got)
    assert sorted(fw) == sorted(fg)
    for k, v in fw.items():
        assert tuple(fg[k].shape) == v.shape and fg[k].dtype == torch.bfloat16, k
        if k.endswith("/b"):
            assert not fg[k].any(), k
        else:
            d_in = fg[k].shape[-2]
            assert abs(fg[k].float().std().item() * np.sqrt(d_in) - 1) < 0.2, k
    assert TLORA.lora_num_params(got) == sum(v.size for v in fw.values())
    base = params_from_numpy(_to_numpy(jinit_params(jcfg, jax.random.PRNGKey(0))), tcfg,
                             device="cpu")
    merged = TLORA.merge_lora(base, got, tlcfg)
    for name in got["blocks"]:
        assert torch.equal(merged["blocks"][name], base["blocks"][name])
    bad = TLORA.LoRAConfig(enabled=True, targets=("wq", "conv"))
    with pytest.raises(KeyError, match="conv"):
        TLORA.init_lora_params(tcfg, bad, torch.Generator(), device="cpu")
    with pytest.raises(KeyError, match="conv"):
        JLORA.init_lora_params(jcfg, JLORA.LoRAConfig(targets=("wq", "conv")),
                               jax.random.PRNGKey(0))


def _batch(cfg, B=4, T=16, seed=0):
    """Right-padded rows (as build_train_batch lays them out)."""
    r = np.random.default_rng(seed)
    lens = r.integers(T // 2, T + 1, B)
    lens[0] = T
    attn = np.arange(T)[None, :] < lens[:, None]
    loss_mask = attn & (r.random((B, T)) > 0.3)
    return {
        "input_ids": np.where(attn, r.integers(0, cfg.vocab_size, (B, T)), 0).astype(np.int32),
        "target_ids": r.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
        "attention_mask": attn,
        "loss_mask": loss_mask,
        "old_logprobs": np.where(loss_mask, -np.log(cfg.vocab_size) + r.normal(size=(B, T)) * 0.1,
                                 0).astype(np.float32),
        "advantages": (r.normal(size=(B, T)) * loss_mask).astype(np.float32),
    }


@pytest.mark.parametrize("num_microbatches", [1, 2])
@pytest.mark.parametrize("targets", ["default", "lm_head"])
def test_lora_train_step_three_steps_match_jax(num_microbatches, targets):
    """Three make_lora_policy_train_step calls (f32, adamw with eps 1e-3,
    remat) from the same base, adapters and batches: the adapters within
    rtol=1e-5 (atol=1e-7), loss and grad norm within 1e-5 relative; the
    base params bitwise unchanged."""
    jcfg, tcfg = _configs("float32", tie=targets == "default")
    tgt = JLORA.DEFAULT_TARGETS + (("lm_head",) if targets == "lm_head" else ())
    lcfg = JLORA.LoRAConfig(enabled=True, rank=4, alpha=8.0, targets=tgt)
    tlcfg = TLORA.LoRAConfig(**dataclasses.asdict(lcfg))
    opt = dict(lr=1e-3, eps=1e-3)
    jtx, ttx = JS.make_optimizer(JS.OptimizerConfig(**opt)), TS.make_optimizer(TS.OptimizerConfig(**opt))
    jbase = jinit_params(jcfg, jax.random.PRNGKey(2))
    jl = _adapters(jcfg, lcfg, 3)
    tbase = params_from_numpy(_to_numpy(jbase), tcfg, device="cpu")
    base0 = {k: v.clone() for k, v in flatten(tbase).items()}
    tl = {k: v for k, v in params_from_numpy(
        {"embed": np.zeros((tcfg.vocab_size, tcfg.hidden_size)), **_to_numpy(jl)}, tcfg,
        device="cpu").items() if k != "embed"}
    jstep = JLL.make_lora_policy_train_step(jcfg, JLossConfig(), jtx, lcfg,
                                            num_microbatches=num_microbatches, remat=True)
    tstep = TLL.make_lora_policy_train_step(tcfg, PolicyLossConfig(), ttx, tlcfg,
                                            num_microbatches=num_microbatches, remat=True,
                                            device="cpu")
    jstate = JS.TrainState(jnp.zeros((), jnp.int32), jl, jtx.init(jl))
    tstate = TS.TrainState(0, tl, ttx.init(tl))
    for step in range(3):
        b = _batch(tcfg, seed=10 + step)
        jstate, jm = jstep(jstate, jbase, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, tbase, b)
        for k in ("actor/loss", "actor/grad_norm"):
            np.testing.assert_allclose(_np(tm[k]), _np(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)
        assert sorted(tm) == sorted(jm)
    _tree_close(tstate.params, jstate.params, rtol=1e-5, atol=1e-7)
    assert tstate.step == 3
    for k, v in flatten(tbase).items():
        assert torch.equal(v, base0[k]), k


# --- the runner -----------------------------------------------------------------

# 16 rows a step, the recompute on (so that it reads the merged params), 2
# minibatches, static microbatches (LoRA refuses the token budget), no
# metrics file
BASE = ["runner.rollout_batch_size=2", "algorithm.recompute_logprobs=true",
        "runner.num_mini_batches=2", "runner.log_dir=null", "lora.enabled=true",
        "lora.rank=4", "lora.alpha=8", "optimizer.warmup_steps=0", "optimizer.lr=1e-3",
        "optimizer.eps=1e-3"]


def rule_reward(texts, answers):
    """1.0 where more than half of a text's characters have an odd code
    point, else 0.0."""
    return [float(sum(ord(c) % 2 for c in t) * 2 > len(t)) for t in texts]


def _examples(n=32):
    return [(f"Compute {i} + {i + 3}. Final answer: ", str(2 * i + 3)) for i in range(n)]


def _datasets():
    from rlinf_tpu.data.datasets import PromptDataset as JDataset
    from rlinf_tpu.data.datasets import PromptExample as JExample
    from rlinf_tpu_torch.data.datasets import PromptDataset, PromptExample

    ex = _examples()
    return (JDataset([JExample(p, a) for p, a in ex]),
            PromptDataset([PromptExample(p, a) for p, a in ex]))


def _rollout_arrays(seed=0):
    """2 prompts x 8 rows: left-padded prompts, right-padded responses of
    1-16 tokens, behaviour logprobs."""
    r = np.random.default_rng(seed)
    tok = JTokenizer()
    prompts = [tok.encode(p) for p, _ in _examples(2)]
    B, P, N = 16, 64, 16
    prompt_ids = np.zeros((B, P), np.int32)
    prompt_mask = np.zeros((B, P), bool)
    for i in range(B):
        p = prompts[i // 8]
        prompt_ids[i, P - len(p):] = p
        prompt_mask[i, P - len(p):] = True
    lens = r.integers(1, N + 1, B)
    response_mask = np.arange(N)[None, :] < lens[:, None]
    response_ids = np.where(response_mask, r.integers(2, 258, (B, N)), 0).astype(np.int32)
    lps = np.where(response_mask, r.uniform(-6.0, -0.1, (B, N)), 0).astype(np.float32)
    answers = [a for _, a in _examples(2) for _ in range(8)]
    return dict(prompt_ids=prompt_ids, prompt_mask=prompt_mask, response_ids=response_ids,
                response_mask=response_mask, response_logprobs=lps, answers=answers)


def test_lora_runner_step_matches_the_jax_runner(monkeypatch):
    """One ``_train_on_result`` of the reasoning runner in LoRA mode
    (grpo_demo_tiny.yaml, f32): the JAX runner's base params and adapters
    feed the port's runner; one rollout and one permutation feed both. The
    recompute (on the merged params) within 1e-5; every ``actor/*`` metric
    within 1e-4 relative (1e-6 absolute); the adapters after the step
    within 1e-5; the base params untouched; the train state holds the
    adapters alone."""
    jdata, tdata = _datasets()
    jcfg = jconfig.load_config(YAML, BASE)
    params = jinit_params(jcfg.model, jax.random.PRNGKey(0))
    jr = JRunner(jcfg, JTokenizer(), jdata, init_params_override=lambda rng: params,
                 reward_fn=rule_reward)
    jl = _adapters(jcfg.model, jcfg.lora, 5)
    jr.state = JS.TrainState(jr.state.step, jl, jr.tx.init(jl))
    tcfg = tconfig.load_config(YAML, BASE)
    tr = ReasoningRunner(
        tcfg, ByteTokenizer(), tdata, reward_fn=rule_reward, device="cpu",
        init_params_override=lambda seed: params_from_numpy(_to_numpy(params), tcfg.model,
                                                            device="cpu"))
    tl = {k: v for k, v in params_from_numpy(
        {"embed": np.zeros((tcfg.model.vocab_size, tcfg.model.hidden_size)), **_to_numpy(jl)},
        tcfg.model, device="cpu").items() if k != "embed"}
    tr.state = TS.create_train_state(lambda: tl, tr.tx)
    assert "embed" not in flatten(tr.state.params) and tr.base_params is not None
    base0 = {k: v.clone() for k, v in flatten(tr.base_params).items()}

    perm = np.random.default_rng(3).permutation(16)
    monkeypatch.setattr(jax.random, "permutation", lambda key, n: jnp.asarray(perm[:n]))
    monkeypatch.setattr(tr, "_permutation", lambda n: perm[:n])
    lps = {"jax": [], "torch": []}
    for side, r in (("jax", jr), ("torch", tr)):
        fn = r.logprob_fn
        monkeypatch.setattr(r, "logprob_fn", lambda p, b, fn=fn, log=lps[side]:
                            log.append(fn(p, b)) or log[-1])
    arrays = _rollout_arrays()
    jm = jr._train_on_result(jio.RolloutResult(**copy.deepcopy(arrays)))
    tm = tr._train_on_result(tio.RolloutResult(**copy.deepcopy(arrays)))
    np.testing.assert_allclose(_np(lps["torch"][0][0]), _np(lps["jax"][0][0]), atol=1e-5)
    actor = sorted(k for k in jm if k.startswith("actor/"))
    assert actor == sorted(k for k in tm if k.startswith("actor/")) and set(tm) == set(jm)
    for k in actor:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert jm["actor/grad_norm"] > 0
    _tree_close(tr.state.params, jr.state.params, atol=1e-5, rtol=0)
    for k, v in flatten(tr.base_params).items():
        assert torch.equal(v, base0[k]), k
    merged = tr._policy_params()
    assert not torch.equal(merged["blocks"]["wq"], tr.base_params["blocks"]["wq"])


def test_lora_checkpoints_hold_the_adapters_and_restore_bitwise(tmp_path):
    """main_grpo with lora.enabled for two steps (a checkpoint each): the
    checkpoint holds the adapter state alone; a runner with resume=auto
    restores it bitwise at step 2 and takes step 3 (saved beside it); a
    fresh runner (another checkpoint directory) with ``lora.path`` at those
    checkpoints starts at step 0 from the latest adapters (step 3's),
    bitwise."""
    common = ["--config", YAML, "--device", "cpu", *BASE, "runner.save_interval=1",
              f"runner.checkpoint_dir={tmp_path / 'ck'}"]
    history = main_grpo.main([*common, "runner.max_steps=2"])
    assert len(history) == 2 and all(np.isfinite(h["actor/loss"]) for h in history)
    saved = torch.load(tmp_path / "ck" / "global_step_2" / "state.pt", weights_only=True)
    assert saved and not any("embed" in k or "norm" in k for k in saved)
    assert any(k.endswith("/a") for k in saved) and any(k.endswith("/b") for k in saved)
    _, tdata = _datasets()
    cfg = tconfig.load_config(YAML, common[4:])
    resumed = ReasoningRunner(cfg, ByteTokenizer(), tdata, device="cpu")
    assert resumed.global_step == 2
    for k, v in flatten(resumed.state).items():
        want = saved[k]
        assert (torch.equal(v, want) and v.dtype == want.dtype) if isinstance(v, torch.Tensor) \
            else v == want, k
    assert any(saved[k].any() for k in saved if k.endswith("/b"))
    (m,) = resumed.run(3)
    assert np.isfinite(m["actor/loss"]) and resumed.global_step == 3
    fresh = ReasoningRunner(tconfig.load_config(YAML, [
        *BASE, f"runner.checkpoint_dir={tmp_path / 'other'}", f"lora.path={tmp_path / 'ck'}"]),
        ByteTokenizer(), tdata, device="cpu")
    assert fresh.global_step == 0
    step3 = flatten(fresh.state.params)
    latest = torch.load(tmp_path / "ck" / "global_step_3" / "state.pt", weights_only=True)
    for k, v in step3.items():
        assert torch.equal(v, latest["/1" + k]), k


def test_lora_refuses_a_critic_and_the_token_budget():
    """As the JAX package: lora.enabled with adv_type=gae fails the config's
    validator on both sides; with loss.max_tokens_per_mb > 0 the runner
    refuses it."""
    ov = ["lora.enabled=true", "algorithm.adv_type=gae", "algorithm.group_size=1"]
    for load in (jconfig.load_config, tconfig.load_config):
        with pytest.raises(ValueError, match="gae"):
            load(YAML, ov)
    _, tdata = _datasets()
    cfg = tconfig.load_config(YAML, ["lora.enabled=true", "loss.max_tokens_per_mb=128",
                                     "runner.log_dir=null"])
    with pytest.raises(NotImplementedError, match="max_tokens_per_mb"):
        ReasoningRunner(cfg, ByteTokenizer(), tdata, device="cpu")
