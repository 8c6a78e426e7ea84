"""The port's reasoning runner and ``main_grpo`` entry point against the JAX
package's, on the CPU at ``examples/reasoning/config/grpo_demo_tiny.yaml``
(2 layers, D=64, fp32, byte tokenizer), cut to 2 prompts a step (16 rows).

One JAX init feeds both runners through ``params_from_numpy``; one
``RolloutResult`` made with numpy from a seed feeds both ``_train_on_result``
calls, with a rule ``reward_fn`` on the decoded texts so that the advantages
are not all zero (the math verifier scores random text 0). Tolerances are
stated per test: fp32 on both sides, so the two agree to summation-order
rounding.
"""

import copy
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlinf_tpu import config as jconfig
from rlinf_tpu.data import io_struct as jio
from rlinf_tpu.data.datasets import PromptDataset as JDataset
from rlinf_tpu.data.datasets import PromptExample as JExample
from rlinf_tpu.data.tokenizers import ByteTokenizer as JTokenizer
from rlinf_tpu.models.llm import init_params as jinit_params
from rlinf_tpu.runners.reasoning_runner import ReasoningRunner as JRunner
from rlinf_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from rlinf_tpu_torch import config as tconfig
from rlinf_tpu_torch import main_grpo
from rlinf_tpu_torch.data import io_struct as tio
from rlinf_tpu_torch.data.tokenizers import ByteTokenizer
from rlinf_tpu_torch.models.llm.convert import params_from_numpy
from rlinf_tpu_torch.runners import ReasoningRunner
from rlinf_tpu_torch.training.train_state import create_train_state, tree_leaves
from rlinf_tpu_torch.utils.checkpoint import flatten

torch.set_num_threads(2)

YAML = "examples/reasoning/config/grpo_demo_tiny.yaml"
# 16 rows a step; the recompute on (it resolves off on the CPU), so that the
# runner's recompute branch runs; a token budget of 128 that packs the rows
# (30-45 tokens each) into several microbatches; no metrics file (the yaml's
# log_dir is a directory of the repo)
BASE = ["runner.rollout_batch_size=2", "algorithm.recompute_logprobs=true",
        "loss.max_tokens_per_mb=128", "runner.num_mini_batches=2", "runner.log_dir=null"]


def rule_reward(texts, answers):
    """1.0 where more than half of a text's characters have an odd code
    point, else 0.0."""
    return [float(sum(ord(c) % 2 for c in t) * 2 > len(t)) for t in texts]


def _examples(n=32):
    return [(f"Compute {i} + {i + 3}. Final answer: ", str(2 * i + 3)) for i in range(n)]


def _datasets():
    from rlinf_tpu_torch.data.datasets import PromptDataset, PromptExample

    ex = _examples()
    return (JDataset([JExample(p, a) for p, a in ex]),
            PromptDataset([PromptExample(p, a) for p, a in ex]))


def _overrides(max_tokens_per_mb, num_mini_batches):
    return BASE + [f"loss.max_tokens_per_mb={max_tokens_per_mb}",
                   f"runner.num_mini_batches={num_mini_batches}"]


def _rollout_arrays(seed=0):
    """A rollout of the 2 prompts x 8 in the engines' layout: left-padded
    prompts, right-padded responses of 1-16 tokens, behaviour logprobs."""
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


@pytest.fixture(scope="module")
def jax_side():
    """The JAX runner (built once), its initial state and params as numpy,
    and the metric keys of one whole step (rollout and update) on BASE."""
    cfg = jconfig.load_config(YAML, BASE)
    jdata, _ = _datasets()
    params = jinit_params(cfg.model, jax.random.PRNGKey(0))
    runner = JRunner(cfg, JTokenizer(), jdata, init_params_override=lambda rng: params,
                     reward_fn=rule_reward)
    s0 = jax.tree_util.tree_map(jnp.copy, runner.state)
    np_params = jax.tree_util.tree_map(np.asarray, s0.params)
    step_keys = set(runner.run_step())
    return {"runner": runner, "cfg": cfg, "s0": s0, "np_params": np_params,
            "step_keys": step_keys}


def _recording(fn, log):
    def run(*a, **kw):
        out = fn(*a, **kw)
        log.append(out)
        return out
    return run


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("num_mini_batches", [1, 2])
@pytest.mark.parametrize("max_tokens_per_mb", [0, 128])
def test_train_on_result_matches_the_jax_runner(jax_side, monkeypatch, max_tokens_per_mb,
                                                num_mini_batches):
    """One ``_train_on_result`` from one init on one rollout, both runners,
    static and token-budget microbatching, 1 and 2 minibatches (the same
    permutation injected on both sides). Rewards and advantages equal; the
    recompute logprobs within 1e-5; every ``actor/*`` metric within 1e-4
    relative (1e-6 absolute); the params after the step within 1e-5 (adam's
    first step moves each by lr = 3e-3 times the sign of its gradient)."""
    ov = _overrides(max_tokens_per_mb, num_mini_batches)
    jcfg = jconfig.load_config(YAML, ov)
    jr = jax_side["runner"]
    jr.cfg = dataclasses.replace(jr.cfg, loss=jcfg.loss, runner=jcfg.runner)
    jr.state = jax.tree_util.tree_map(jnp.copy, jax_side["s0"])
    _, tdata = _datasets()
    tcfg = tconfig.load_config(YAML, ov)
    tr = ReasoningRunner(
        tcfg, ByteTokenizer(), tdata, reward_fn=rule_reward, device="cpu",
        init_params_override=lambda seed: params_from_numpy(jax_side["np_params"], tcfg.model,
                                                            device="cpu"))
    assert tr.recompute_logprobs and tr.logprob_fn is not None

    perm = np.random.default_rng(3).permutation(16)
    monkeypatch.setattr(jax.random, "permutation", lambda key, n: jnp.asarray(perm[:n]))
    monkeypatch.setattr(tr, "_permutation", lambda n: perm[:n])
    logs = {side: {"adv": [], "lp": []} for side in ("jax", "torch")}
    for side, r in (("jax", jr), ("torch", tr)):
        monkeypatch.setattr(r, "_compute_advantages",
                            _recording(r._compute_advantages, logs[side]["adv"]))
        monkeypatch.setattr(r, "logprob_fn", _recording(r.logprob_fn, logs[side]["lp"]))

    arrays = _rollout_arrays()
    jres = jio.RolloutResult(**copy.deepcopy(arrays))
    tres = tio.RolloutResult(**copy.deepcopy(arrays))
    jm = jr._train_on_result(jres)
    tm = tr._train_on_result(tres)

    np.testing.assert_array_equal(tres.rewards, jres.rewards)
    assert 0 < tres.rewards.sum() < len(tres.rewards)
    np.testing.assert_array_equal(logs["torch"]["adv"][0], logs["jax"]["adv"][0])
    assert np.abs(logs["torch"]["adv"][0]).max() > 0
    np.testing.assert_allclose(_np(logs["torch"]["lp"][0][0]), _np(logs["jax"]["lp"][0][0]),
                               atol=1e-5)
    actor = sorted(k for k in jm if k.startswith("actor/"))
    assert actor == sorted(k for k in tm if k.startswith("actor/"))
    for k in actor:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert jm["actor/grad_norm"] > 0
    assert set(tm) == set(jm)
    if max_tokens_per_mb:
        assert tm["actor/num_dyn_microbatches"] > 1
    for got, want in zip(tree_leaves(tr.state.params),
                         jax.tree_util.tree_leaves(jr.state.params)):
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


PPO_YAML = "examples/reasoning/config/ppo_separate_critic.yaml"
# the shipped PPO config in fp32 (so that both sides agree to rounding), no
# lr warmup, the recompute on, 2 minibatches; adam's eps at 1e-3, as the
# policy-step test takes it (an entry whose gradient is rounding noise on
# both sides would otherwise move by up to lr either way)
PPO_BASE = ["model.dtype=float32", "runner.log_dir=null", "algorithm.recompute_logprobs=true",
            "runner.num_mini_batches=2", "optimizer.warmup_steps=0", "optimizer.lr=1e-3",
            "algorithm.critic_lr=3e-3", "optimizer.eps=1e-3"]


@pytest.mark.parametrize("critic,warmup", [("separate", 0), ("separate", 1), ("shared", 0)])
def test_critic_runner_step_matches_the_jax_runner(monkeypatch, critic, warmup):
    """One ``_train_on_result`` of the PPO runner with a learned critic
    (ppo_separate_critic.yaml in fp32): a separate critic with its own
    optimizer and ``critic_lr``, with and without a warmup step (the actor
    update skipped), and a value head on the shared trunk. The JAX runner's
    initial actor (and critic) params are converted into the port's runner;
    one rollout and one permutation feed both. GAE advantages within 1e-5;
    every ``actor/*`` and ``critic/*`` metric within 1e-4 relative (1e-5
    absolute; the clip ratio, a count at a threshold, within 4 of its 1024
    entries); the actor's and the critic's params after the step within
    1e-5."""
    ov = PPO_BASE + [f"algorithm.critic={critic}", f"algorithm.critic_warmup_steps={warmup}"]
    jcfg = jconfig.load_config(PPO_YAML, ov)
    jdata, tdata = _datasets()
    params = jinit_params(jcfg.model, jax.random.PRNGKey(0))
    jr = JRunner(jcfg, JTokenizer(), jdata, init_params_override=lambda rng: params,
                 reward_fn=rule_reward)
    tcfg = tconfig.load_config(PPO_YAML, ov)
    tr = ReasoningRunner(tcfg, ByteTokenizer(), tdata, reward_fn=rule_reward, device="cpu")
    assert tr.with_critic and tr.separate_critic == (critic == "separate")
    np_actor = jax.tree_util.tree_map(np.array, jr.state.params)
    tr.state = create_train_state(
        lambda: params_from_numpy(np_actor, tcfg.model, device="cpu"), tr.tx)
    assert ("value_head" in tr.state.params) == (critic == "shared")
    if critic == "separate":
        np_critic = jax.tree_util.tree_map(np.array, jr.critic_state.params)
        tr.critic_state = create_train_state(
            lambda: params_from_numpy(np_critic, tcfg.model, device="cpu"), tr.critic_tx)

    perm = np.random.default_rng(3).permutation(16)
    monkeypatch.setattr(jax.random, "permutation", lambda key, n: jnp.asarray(perm[:n]))
    monkeypatch.setattr(tr, "_permutation", lambda n: perm[:n])
    logs = {"jax": [], "torch": []}
    for side, r in (("jax", jr), ("torch", tr)):
        monkeypatch.setattr(r, "_gae_token_advantages",
                            _recording(r._gae_token_advantages, logs[side]))
    arrays = _rollout_arrays()
    jm = jr._train_on_result(jio.RolloutResult(**copy.deepcopy(arrays)))
    tm = tr._train_on_result(tio.RolloutResult(**copy.deepcopy(arrays)))

    for k in ("advantages", "returns", "prev_values"):
        np.testing.assert_allclose(logs["torch"][0][k], logs["jax"][0][k], atol=1e-5, err_msg=k)
    assert np.abs(logs["torch"][0]["advantages"]).max() > 0
    assert set(tm) == set(jm)
    assert ("actor/warmup_skipped" in tm) == (warmup > 0)
    for k in sorted(k for k in jm if k.startswith(("actor/", "critic/"))):
        # the clip ratio counts |clip(v - prev) + prev - prev| > value_clip
        # over the minibatch's 1024 entries: an entry clipped to exactly the
        # bound lands a rounding either side of it, so a few may count apart
        atol = 4 / 1024 if k == "critic/value_clip_ratio" else 1e-5
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, atol=atol, err_msg=k)
    assert any(k.startswith("critic/") for k in tm)
    for got, want in zip(tree_leaves(tr.state.params),
                         jax.tree_util.tree_leaves(jr.state.params)):
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)
    if critic == "separate":
        moved = [not np.allclose(_np(a), b) for a, b in
                 zip(tree_leaves(tr.critic_state.params), jax.tree_util.tree_leaves(np_critic))]
        assert any(moved)
        for got, want in zip(tree_leaves(tr.critic_state.params),
                             jax.tree_util.tree_leaves(jr.critic_state.params)):
            np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


def test_separate_critic_checkpoints_beside_the_actor(tmp_path):
    """main_grpo on ppo_separate_critic.yaml (bf16, as shipped) for two
    steps with a warmup step saves the critic under ``checkpoint_dir +
    "_critic"``; a runner resumed from it holds both states bitwise equal
    to a second run's after the same two steps."""
    ck = tmp_path / "ck"
    common = ["--config", PPO_YAML, "--device", "cpu", "runner.rollout_batch_size=4",
              "algorithm.critic_warmup_steps=1", f"runner.checkpoint_dir={ck}",
              "runner.save_interval=1", "runner.log_dir=null"]
    first = main_grpo.main([*common, "runner.max_steps=2"])
    assert first[0]["actor/warmup_skipped"] == 1.0 and "actor/warmup_skipped" not in first[1]
    assert (tmp_path / "ck_critic").is_dir()
    tdata = main_grpo.synthetic_dataset()
    cfg = tconfig.load_config(PPO_YAML, common[4:])
    resumed = ReasoningRunner(cfg, ByteTokenizer(), tdata, device="cpu")
    assert resumed.global_step == 2
    full = ReasoningRunner(tconfig.load_config(PPO_YAML, [c.replace(str(ck), str(tmp_path / "b"))
                                                          for c in common[4:]]),
                           ByteTokenizer(), tdata, device="cpu")
    full.run(2)
    for a, b in ((resumed.state.params, full.state.params),
                 (resumed.critic_state.params, full.critic_state.params)):
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_grpo_demo_tiny_step_in_f32_as_shipped(tmp_path):
    """grpo_demo_tiny.yaml as shipped (fp32, Hd=16, 16 prompts x 8) takes
    one whole step through main_grpo: finite metrics, the actor updated."""
    history = main_grpo.main(["--config", YAML, "--device", "cpu", "runner.max_steps=1",
                              f"runner.log_dir={tmp_path}"])
    (m,) = history
    assert all(np.isfinite(v) for v in m.values())
    assert m["actor/grad_norm"] >= 0 and m["rollout/response_len_mean"] > 0


def test_main_grpo_cli_writes_the_jax_runners_metrics(jax_side, tmp_path):
    """``main_grpo.main`` on the CPU runs two whole steps and writes
    ``metrics.jsonl`` rows whose keys are the JAX runner's step keys (and
    ``step``, ``time``) on the same config."""
    history = main_grpo.main(["--config", YAML, "--device", "cpu", *BASE,
                              "runner.max_steps=2", f"runner.log_dir={tmp_path}"])
    rows = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [row["step"] for row in rows] == [1, 2] and len(history) == 2
    for row, h in zip(rows, history):
        assert set(row) == jax_side["step_keys"] | {"step", "time"}
        assert set(h) == jax_side["step_keys"]
        assert all(np.isfinite(v) for v in h.values())


def test_main_grpo_reads_a_jsonl_and_refuses_a_model_path(tmp_path):
    data = tmp_path / "d.jsonl"
    data.write_text("\n".join(json.dumps({"question": f"{i} + 1 =", "answer": str(i + 1)})
                              for i in range(4)))
    history = main_grpo.main(["--config", YAML, "--device", "cpu", "--data-path", str(data),
                              "runner.rollout_batch_size=2", "runner.max_steps=1",
                              "runner.log_dir=null"])
    assert len(history) == 1 and history[0]["rollout/prompt_len_max"] <= len("3 + 1 =")
    with pytest.raises(FileNotFoundError, match="config.json"):
        main_grpo.main(["--config", YAML, "--device", "cpu", "--model-path", str(tmp_path),
                        "runner.log_dir=null"])


def test_synthetic_dataset_is_the_jax_entry_points():
    import random

    rng = random.Random(0)
    want = []
    for _ in range(512):
        a, b = rng.randint(2, 99), rng.randint(2, 99)
        want.append((f"Compute {a} + {b}. Final answer: ", str(a + b)))
    got = main_grpo.synthetic_dataset()
    assert [(e.prompt, e.answer) for e in got.examples] == want


def _port_runner(tmp_path, *extra, **kw):
    _, tdata = _datasets()
    cfg = tconfig.load_config(YAML, BASE + [f"runner.checkpoint_dir={tmp_path / 'ck'}",
                                            "runner.save_interval=1", *extra])
    return ReasoningRunner(cfg, ByteTokenizer(), tdata, reward_fn=rule_reward, device="cpu", **kw)


def test_auto_resume_restores_the_state_and_the_next_batch(tmp_path):
    """Two steps with a checkpoint each; a new runner on the same directory
    starts at step 2 with the first runner's state (bitwise) and hands out
    the batch an uninterrupted run would; then it takes step 3."""
    r1 = _port_runner(tmp_path)
    r1.run(2)
    r2 = _port_runner(tmp_path)
    assert r2.global_step == 2
    a, b = flatten(r1.state), flatten(r2.state)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k
    assert r2.iterator.state_dict() == r1.iterator.state_dict()
    assert ([e.prompt for e in copy.deepcopy(r2.iterator).next_batch()]
            == [e.prompt for e in copy.deepcopy(r1.iterator).next_batch()])
    (m,) = r2.run(3)
    assert r2.global_step == 3 and np.isfinite(m["actor/loss"])
    assert r2.ckpt.latest_step() == 3


def test_run_pipelined_rolls_out_on_a_snapshot(tmp_path, monkeypatch):
    """``run_pipelined(2)`` gives two histories with ``run``'s keys; the
    second rollout reads a clone of the params taken before step 1's
    in-place update, not the live params."""
    seen = []
    r = _port_runner(tmp_path, "runner.save_interval=50")
    p0 = [t.clone() for t in tree_leaves(r.state.params)]
    rollout = r._rollout_phase

    def spy(params):
        seen.append(params)
        return rollout(params)

    monkeypatch.setattr(r, "_rollout_phase", spy)
    hist = r.run_pipelined(2)
    ref = _port_runner(tmp_path / "b", "runner.save_interval=50").run(1)
    assert len(hist) == 2 and all(set(h) == set(ref[0]) for h in hist)
    assert len(seen) == 2
    live = tree_leaves(r.state.params)
    snap = tree_leaves(seen[1])
    assert all(s.data_ptr() != t.data_ptr() for s, t in zip(snap, live))
    assert all(torch.equal(s, t) for s, t in zip(snap, p0))
    assert any(not torch.equal(s, t) for s, t in zip(live, p0))


@pytest.mark.parametrize("override, kwargs, error, match", [
    ("optimizer.name=sgd", {}, ValueError, "must be adamw"),
    ("runner.seed=0", {"mesh": make_mesh(MeshConfig(data=1, expert=2), ranks=[0, 1],
                                         device_type="cpu")}, ValueError, "no experts"),
])
def test_unported_options_raise(override, kwargs, error, match):
    """What the runner still refuses: an optimizer other than adamw and
    adafactor, and a mesh with an expert axis for a model without experts
    (the JAX config's check). (Adafactor and LoRA run:
    tests/test_torch_lora.py and the optimizer's cases in
    tests/test_torch_training.py; the runner on a data x fsdp x tensor
    mesh: tests/test_torch_mesh_e2e.py; a context axis with ring attention:
    tests/test_torch_cp_training.py; LoRA, the token budget, adafactor and
    MoE on a mesh: tests/test_torch_mesh_configs.py; the expert axis:
    tests/test_torch_expert_axis.py.)"""
    _, tdata = _datasets()
    cfg = tconfig.load_config(YAML, [override, "runner.log_dir=null"])
    with pytest.raises(error, match=match):
        ReasoningRunner(cfg, ByteTokenizer(), tdata, device="cpu", **kwargs)


def test_the_card_is_the_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tdata = _datasets()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReasoningRunner(tconfig.load_config(YAML, ["runner.log_dir=null"]), ByteTokenizer(), tdata)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_grpo.main(["--config", YAML, "runner.max_steps=1", "runner.log_dir=null"])


def test_adafactor_and_dots_run_and_resume_bitwise(tmp_path):
    """main_grpo with optimizer.name=adafactor and remat="dots" (the tiny
    yaml in bf16 at D=128, so that the [L, 128, 256] weights factor) takes
    two steps with a checkpoint each; a resumed runner holds the state,
    adafactor's factored and unfactored statistics included, bitwise, and
    takes step 3."""
    common = ["--config", YAML, "--device", "cpu", *BASE, "optimizer.name=adafactor",
              "remat=dots", "model.dtype=bfloat16", f"runner.checkpoint_dir={tmp_path / 'ck'}",
              "runner.save_interval=1", "model.hidden_size=128", "model.intermediate_size=256",
              "model.max_seq_len=256"]
    history = main_grpo.main([*common, "runner.max_steps=2"])
    assert len(history) == 2 and all(np.isfinite(h["actor/loss"]) for h in history)
    _, tdata = _datasets()
    cfg = tconfig.load_config(YAML, common[4:])
    assert cfg.remat == "dots" and cfg.optimizer.name == "adafactor"
    r = ReasoningRunner(cfg, ByteTokenizer(), tdata, reward_fn=rule_reward, device="cpu")
    assert r.global_step == 2
    saved = torch.load(tmp_path / "ck" / "global_step_2" / "state.pt", weights_only=True)
    flat = flatten(r.state)
    assert sorted(flat) == sorted(saved)
    assert any("/v_row/" in k and flat[k].numel() > 1 for k in flat)
    for k, v in flat.items():
        if isinstance(v, torch.Tensor):
            assert v.dtype == saved[k].dtype and torch.equal(v, saved[k]), k
    (m,) = r.run(3)
    assert np.isfinite(m["actor/loss"]) and r.global_step == 3
