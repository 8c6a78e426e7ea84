"""The port's eval runner (LLM half) against the JAX package's, on the CPU.

``evaluate_reasoning`` decodes greedily through each package's static engine
from one JAX init (``params_from_numpy``; f32, 2 layers, D=64, byte
vocabulary): accuracy, lengths and every per-example record must be equal.
``pass_at_k`` must equal the JAX estimator on a table of (n, c, k) to
1e-12. The sampled pass@k eval draws other tokens (torch's generator, not
threefry), so it is held with a reward that reads only the answers: every
metric but the seconds must be equal.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from rlinf_tpu.data.datasets import PromptDataset as JDataset
from rlinf_tpu.data.datasets import PromptExample as JExample
from rlinf_tpu.data.tokenizers import ByteTokenizer as JTokenizer
from rlinf_tpu.models.llm import LLMConfig as JConfig
from rlinf_tpu.models.llm import SamplingParams as JSampling
from rlinf_tpu.models.llm import init_params as jinit_params
from rlinf_tpu.runners import eval_runner as jev
from rlinf_tpu_torch.data.datasets import PromptDataset, PromptExample
from rlinf_tpu_torch.data.tokenizers import ByteTokenizer
from rlinf_tpu_torch.models.llm.config import LLMConfig
from rlinf_tpu_torch.models.llm.convert import params_from_numpy
from rlinf_tpu_torch.models.llm.sampler import SamplingParams
from rlinf_tpu_torch.runners import eval_runner as tev

torch.set_num_threads(2)

JCFG = JConfig(vocab_size=258, hidden_size=64, intermediate_size=128, num_layers=2,
               num_heads=4, num_kv_heads=2, max_seq_len=256, dtype="float32",
               qkv_bias=False, rope_theta=1e4, tie_word_embeddings=False)
TCFG = LLMConfig(**dataclasses.asdict(JCFG))
EXAMPLES = [(f"Compute {i} + {i + 1}. Final answer: ", str(2 * i + 1)) for i in range(11)]


@pytest.fixture(scope="module")
def params():
    jp = jinit_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), TCFG, device="cpu")


def _datasets():
    return (JDataset([JExample(p, a) for p, a in EXAMPLES]),
            PromptDataset([PromptExample(p, a) for p, a in EXAMPLES]))


def text_reward(texts, answers):
    """Mixed scores on random text: 1.0 where the text has an even number
    of characters."""
    return [float(len(t) % 2 == 0) for t in texts]


@pytest.mark.parametrize("reward", ["math", "text"])
def test_evaluate_reasoning_matches_jax(params, reward):
    """11 examples in batches of 4 (the last one padded), greedy, 10 new
    tokens: the JAX package's default reward (the math verifier) and a text
    rule that gives mixed scores."""
    jp, tp = params
    jdata, tdata = _datasets()
    kw = dict(batch_size=4, max_examples=11)
    if reward == "text":
        kw["reward_fn"] = text_reward
    want = jev.evaluate_reasoning(jp, JCFG, JTokenizer(), jdata,
                                  sampling=JSampling(max_new_tokens=10, greedy=True), **kw)
    got = tev.evaluate_reasoning(tp, TCFG, ByteTokenizer(), tdata,
                                 sampling=SamplingParams(max_new_tokens=10, greedy=True),
                                 device="cpu", **kw)
    assert got.num_examples == want.num_examples == 11
    assert (got.accuracy, got.mean_response_len) == (want.accuracy, want.mean_response_len)
    assert got.per_example == want.per_example
    if reward == "text":
        assert 0 < got.accuracy < 1
    assert got.seconds > 0


@pytest.mark.parametrize("n, c, k", [(1, 0, 1), (1, 1, 1), (8, 0, 1), (8, 3, 1), (8, 3, 4),
                                     (8, 5, 4), (8, 8, 8), (10, 1, 5), (16, 7, 2), (5, 2, 5)])
def test_pass_at_k_matches_jax(n, c, k):
    assert tev.pass_at_k(n, c, k) == pytest.approx(jev.pass_at_k(n, c, k), abs=1e-12)


def test_pass_at_k_refuses_k_above_n():
    with pytest.raises(ValueError, match="k=5 > n=4"):
        tev.pass_at_k(4, 1, 5)


def test_pass_at_k_eval_matches_jax_on_an_answer_reward(params):
    """4 samples a prompt, 7 prompts, batches of 8 rows: the reward reads
    only the answers (every third one right), so the metrics must be equal
    whatever tokens each package draws."""
    jp, tp = params
    jdata, tdata = _datasets()

    def answer_reward(texts, answers):
        return [float(int(a) % 3 == 0) for a in answers]

    kw = dict(n_samples=4, ks=[1, 2, 4], max_new_tokens=6, reward_fn=answer_reward,
              batch_size=8, max_examples=7)
    want = jev.evaluate_reasoning_pass_at_k(jp, JCFG, JTokenizer(), jdata, **kw)
    got = tev.evaluate_reasoning_pass_at_k(tp, TCFG, ByteTokenizer(), tdata, device="cpu",
                                           **kw)
    assert set(got) == set(want)
    for key in want:
        if key != "seconds":
            assert got[key] == pytest.approx(want[key], abs=1e-12), key
    assert 0 < got["pass@4"] < 1


def test_tables_print_as_jax(capsys):
    results = {"gsm8k": tev.EvalResult(0.25, 8, 12.5, 3.25, []),
               "a_longer_task_name": tev.EvalResult(1.0, 120, 7.0, 10.0, [])}
    metrics = {"pass@1": 0.5, "n_samples": 8.0, "steps": 3, "a_very_long_metric_key": 1e-3}
    out = []
    for mod in (tev, jev):
        mod.print_eval_table({k: mod.EvalResult(**dataclasses.asdict(v))
                              for k, v in results.items()})
        mod.print_metrics_table(metrics, title="val", step=7)
        out.append(capsys.readouterr().out)
    assert out[0] == out[1] and "gsm8k" in out[0]


def test_embodied_eval_waits_for_the_env_loop():
    """The episodic embodied eval runs over the port's EnvLoop (it raised
    until the loop was ported), with the JAX test's checks
    (tests/test_eval_runners.py test_embodied_episodic_eval)."""
    from rlinf_tpu_torch.envs.toy import PointReachEnv
    from rlinf_tpu_torch.models.embodiment import MLPGaussianPolicy

    policy = MLPGaussianPolicy(obs_dim=4, action_dim=2)
    params = policy.init(torch.Generator().manual_seed(0), device="cpu")
    metrics = tev.evaluate_embodied_episodes([PointReachEnv(num_envs=8, seed=0)], policy,
                                             params, num_steps=64, seed=0, device="cpu")
    assert metrics["episodes"] > 0
    assert "success_once" in metrics and "episode_return_mean" in metrics
    assert metrics["episode_len_mean"] > 0


def test_the_card_is_the_default(monkeypatch, params):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tdata = _datasets()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tev.evaluate_reasoning(params[1], TCFG, ByteTokenizer(), tdata)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tev.evaluate_reasoning_pass_at_k(params[1], TCFG, ByteTokenizer(), tdata)
