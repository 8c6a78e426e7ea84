"""The port's ``AgentLightningRunner`` against the JAX package's, on the CPU.

grpo_demo_tiny.yaml's model (f32, 2 layers, D=64, byte vocabulary) with an
untied lm head, greedy decoding, 2 prompts x 4 tasks a step, one JAX init
on both sides (``params_from_numpy``). The agent program calls
``complete`` once or twice a task and returns a reward for some tasks and None for
the others, so the fallback ``reward_fn`` (``batch_f1_rewards``) or the
fill value scores those. A step's metrics must have the same keys; the
``agent/*`` values are equal, every other value but the ``time/*`` ones
agrees within 1e-4 relative (1e-6 absolute), adam's first moment within
1e-4 of each leaf's largest, and the agent saw the same completions.
"""

import jax
import numpy as np
import pytest
import torch

from rlinf_tpu import config as jconfig
from rlinf_tpu.algorithms.rewards.qa_metrics import batch_f1_rewards as jf1
from rlinf_tpu.data.datasets import PromptDataset as JDataset
from rlinf_tpu.data.datasets import PromptExample as JExample
from rlinf_tpu.data.tokenizers import ByteTokenizer as JTokenizer
from rlinf_tpu.models.llm import init_params as jinit_params
from rlinf_tpu.runners.agentlightning_runner import AgentLightningRunner as JRunner
from rlinf_tpu_torch import config as tconfig
from rlinf_tpu_torch.algorithms.rewards.qa_metrics import batch_f1_rewards
from rlinf_tpu_torch.data.datasets import PromptDataset, PromptExample
from rlinf_tpu_torch.data.tokenizers import ByteTokenizer
from rlinf_tpu_torch.models.llm.convert import params_from_numpy
from rlinf_tpu_torch.runners.agentlightning_runner import AgentLightningRunner
from rlinf_tpu_torch.training.train_state import tree_leaves

torch.set_num_threads(2)

YAML = "examples/reasoning/config/grpo_demo_tiny.yaml"
OV = ["model.tie_word_embeddings=false", "sampling.greedy=true", "sampling.max_new_tokens=12",
      "algorithm.group_size=4", "runner.rollout_batch_size=2", "runner.log_dir=null",
      "optimizer.lr=1e-4"]


def _examples():
    return [(f"compute {i}+{i}: ", str(2 * i)) for i in range(8)]


def make_agent(seen: list):
    """The user's agent program: two completions a task (one in every
    fourth task, so that the rows differ in length and the loss's terms do
    not cancel), the second prompt naming the call's index (so that the
    rows of a group differ); a reward for two tasks in three, None (the
    fallback's) for the third."""
    def agent_fn(complete, task):
        n = len(seen)
        a = complete(task.prompt)
        b = complete(f" #{n} then {a[:6]}: ") if n % 4 != 3 else ""
        seen.append((task.prompt, a, b))
        if n % 3 == 2:
            return None
        return float((n + len(a + b)) % 2)
    return agent_fn


@pytest.fixture(scope="module")
def configs():
    jcfg = jconfig.load_config(YAML, OV)
    tcfg = tconfig.load_config(YAML, OV)
    np_params = jax.tree_util.tree_map(np.asarray, jinit_params(jcfg.model, jax.random.PRNGKey(0)))
    return jcfg, tcfg, np_params


def _runners(configs, jseen, tseen, **kw):
    jcfg, tcfg, np_params = configs
    jkw = {k: (jf1 if v is batch_f1_rewards else v) for k, v in kw.items()}
    jrun = JRunner(jcfg, JTokenizer(), JDataset([JExample(p, a) for p, a in _examples()]),
                   make_agent(jseen), max_total_len=64,
                   init_params_override=lambda rng: jax.tree_util.tree_map(
                       jax.numpy.asarray, np_params), **jkw)
    trun = AgentLightningRunner(
        tcfg, ByteTokenizer(), PromptDataset([PromptExample(p, a) for p, a in _examples()]),
        make_agent(tseen), max_total_len=64, device="cpu",
        init_params_override=lambda seed: params_from_numpy(np_params, tcfg.model, device="cpu"),
        **kw)
    return jrun, trun


def _adam_mu(opt_state):
    """The first moment in optax's chained state."""
    nodes = jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu"))
    return next(n.mu for n in nodes if hasattr(n, "mu"))


def _same_metrics(jm, tm):
    assert set(tm) == set(jm)
    for k in sorted(jm):
        if k.startswith("agent/"):
            assert tm[k] == jm[k], k
        elif not k.startswith("time/"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_run_step_matches_the_jax_runner(configs):
    """One greedy step with the f1 fallback: the same completions, metrics
    and gradients."""
    jseen, tseen = [], []
    jrun, trun = _runners(configs, jseen, tseen, reward_fn=batch_f1_rewards)
    jm, tm = jrun.run_step(), trun.run_step()
    assert tseen == jseen and len(tseen) == 8
    _same_metrics(jm, tm)
    for k in ("agent/reward_mean", "agent/external_reward_rate", "agent/llm_calls_mean",
              "time/rollout", "time/reward", "time/training", "time/step"):
        assert k in tm, k
    assert tm["agent/llm_calls_mean"] == 1.75
    assert tm["agent/external_reward_rate"] == 0.75
    assert tm["actor/grad_norm"] > 1e-3
    jmu = jax.tree_util.tree_leaves(_adam_mu(jrun.state.opt_state))
    for got, want in zip(tree_leaves(trun.state.opt_state["mu"]), jmu):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


def test_fillna_and_checkpoints_match_jax(configs, tmp_path):
    """No reward_fn: the tasks the agent left unscored take
    ``reward_fillna_value``. Two steps; the runner checkpoints at its
    ``save_interval``."""
    jcfg, tcfg, np_params = configs
    jseen, tseen = [], []
    jrun, trun = _runners(configs, jseen, tseen, reward_fillna_value=0.25)
    for _ in range(2):
        tm = trun.run_step()
        _same_metrics(jrun.run_step(), tm)
    assert tseen == jseen and len(tseen) == 16 and trun.global_step == 2
    assert tm["agent/reward_mean"] == pytest.approx(_filled_mean(tseen[8:], 8, 0.25))

    cfg = tconfig.load_config(YAML, OV + [f"runner.checkpoint_dir={tmp_path}",
                                          "runner.save_interval=2"])
    seen = []
    run = AgentLightningRunner(cfg, ByteTokenizer(),
                               PromptDataset([PromptExample(p, a) for p, a in _examples()]),
                               make_agent(seen), max_total_len=64, reward_fillna_value=0.25,
                               device="cpu")
    history = run.run(2)
    assert len(history) == 2 and run.ckpt.latest_step() == 2
    assert history[1]["agent/reward_mean"] == pytest.approx(_filled_mean(seen[8:], 8, 0.25))


def _filled_mean(seen, start, fill):
    """The mean reward of ``make_agent``'s tasks from its call ``start`` on,
    ``fill`` where it returned None."""
    rewards = [fill if n % 3 == 2 else float((n + len(a + b)) % 2)
               for n, (_, a, b) in enumerate(seen, start=start)]
    return float(np.mean(rewards, dtype=np.float32))


def test_the_card_is_the_default(configs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg, _ = configs
    ds = PromptDataset([PromptExample(p, a) for p, a in _examples()])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AgentLightningRunner(tcfg, ByteTokenizer(), ds, make_agent([]))
    run = AgentLightningRunner(tcfg, ByteTokenizer(), ds, make_agent([]), device="cpu")
    assert run.device == torch.device("cpu") and run.cfg.attn_impl == "xla"
