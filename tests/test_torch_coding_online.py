"""The port's online coding runner and code-execution verifier against the
JAX package's, on the CPU at ``examples/reasoning/config/grpo_demo_tiny.yaml``
(2 layers, D=64, fp32, byte tokenizer) with ``loss.loss_type=decoupled``,
cut to 2 tasks a step (16 rows).

The verifier's functions must return what the JAX ones return on a table
of snippets. One version-stamped ``RolloutResult`` whose responses are
Python snippets (right, wrong, failing, no code) feeds both runners'
``_train_on_result`` with their default reward (the exec verifier, partial
credit), from one init, with one permutation injected on both sides:
rewards equal, ``actor/*`` metrics within 1e-4 relative (1e-6 absolute),
as in test_torch_runner.py; the params after the step within 1e-5 but for
at most one element in a thousand (see the test).
"""

import copy
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlinf_tpu import config as jconfig
from rlinf_tpu.algorithms.rewards import code_verifier as jcv
from rlinf_tpu.data import io_struct as jio
from rlinf_tpu.data.tokenizers import ByteTokenizer as JTokenizer
from rlinf_tpu.runners import coding_online_runner as jcor
from rlinf_tpu_torch import config as tconfig
from rlinf_tpu_torch.algorithms.rewards import code_verifier as tcv
from rlinf_tpu_torch.data import io_struct as tio
from rlinf_tpu_torch.data.tokenizers import ByteTokenizer
from rlinf_tpu_torch.models.llm.convert import params_from_numpy
from rlinf_tpu_torch.runners import coding_online_runner as tcor
from rlinf_tpu_torch.training.train_state import tree_leaves

torch.set_num_threads(2)

YAML = "examples/reasoning/config/grpo_demo_tiny.yaml"
OV = ["runner.rollout_batch_size=2", "loss.loss_type=decoupled", "runner.num_mini_batches=2",
      "runner.log_dir=null"]

SNIPPETS = [
    "```python\nprint(int(input()) * 2)\n```",
    "here:\n```\nprint(int(input()) * 2)\n```\nand\n```python\nprint(7)\n```",
    "def f(x):\n    return x\nprint(f(4))",
    "print( 4 )   \n",
    "no code at all",
    "```python\nimport sys\nsys.exit(3)\n```",
    "```python\nprint(1/0)\n```",
    "```python\nx = input()\nprint(x)\nprint(x)\n```",
    "```python\nprint(input()[::-1])\n```",
]
CASES = [
    [{"input": "3\n", "output": "6"}, {"input": "5\n", "output": "10\n"}],
    [{"input": "", "output": "4"}],
    [{"input": "ab\n", "output": "ab\nab"}, {"input": "c\n", "output": "c\r\nc  "}],
    [{"input": "abc\n", "output": "cba"}, {"input": "xy\n", "output": "yy"}],
    [],
]


def test_extract_code_matches_jax():
    for text in SNIPPETS + ["```py\nprint(1)\n```", "", "input() only", "```\n```"]:
        assert tcv.extract_code(text) == jcv.extract_code(text), text


#: the timeout a snippet that ends gets: a loaded machine (six test
#: workers) can take most of a second to start an interpreter, and a slow
#: start must not turn a pass into a timeout
ENDS_S = 10.0


@pytest.mark.parametrize("code, stdin, want, timeout_s", [
    ("print(int(input()) * 2)", "3\n", "6", ENDS_S),
    ("print(int(input()) * 2)", "3\n", "7", ENDS_S),
    ("print('a  ')\nprint('b')", "", "a\nb\n", ENDS_S),
    ("import sys\nsys.exit(1)", "", "", ENDS_S),
    ("print(", "", "", ENDS_S),
    ("while True:\n    pass", "", "", 0.5),
])
def test_run_test_case_matches_jax(code, stdin, want, timeout_s):
    """Right and wrong output, whitespace normalisation, a non-zero exit, a
    syntax error, and the timeout (0.5 s) on a snippet that never ends, on
    both packages."""
    got = tcv.run_test_case(code, stdin, want, timeout_s=timeout_s)
    assert got == jcv.run_test_case(code, stdin, want, timeout_s=timeout_s)


def test_code_reward_matches_jax_on_a_table():
    """Every snippet against every case list with partial credit, and a
    batch all-or-nothing. Every snippet ends, so each gets ENDS_S (the
    timeout is held in test_run_test_case_matches_jax)."""
    seen = set()
    for text in SNIPPETS:
        for cases in CASES:
            got = tcv.code_reward(text, cases, timeout_s=ENDS_S, partial_credit=True)
            assert got == jcv.code_reward(text, cases, timeout_s=ENDS_S,
                                          partial_credit=True), (text, cases)
            seen.add(got)
    assert {0.0, 0.5, 1.0} <= seen
    texts, lists = SNIPPETS[:4] + SNIPPETS[8:], CASES[:2] * 2 + CASES[2:4]
    got = tcv.batch_code_rewards(texts, lists, timeout_s=ENDS_S)
    assert got == jcv.batch_code_rewards(texts, lists, timeout_s=ENDS_S)
    assert set(got) == {0.0, 1.0}


def _tasks(mod):
    return [mod.CodingTask(prompt=f"write a program that prints {i}:",
                           test_cases=[{"input": "", "output": str(i)}]) for i in range(8)]


def _port_runner(np_params=None, *extra, **kw):
    cfg = tconfig.load_config(YAML, OV + list(extra))
    init = None if np_params is None else (
        lambda seed: params_from_numpy(np_params, cfg.model, device="cpu"))
    return tcor.CodingOnlineRunner(cfg, ByteTokenizer(), _tasks(tcor), device="cpu",
                                   init_params_override=init, **kw)


def test_refuses_plain_ppo():
    cfg = tconfig.load_config(YAML, ["runner.log_dir=null"])
    assert cfg.loss.loss_type == "ppo"
    with pytest.raises(ValueError, match="decoupled"):
        tcor.CodingOnlineRunner(cfg, ByteTokenizer(), _tasks(tcor), device="cpu")


def test_the_card_is_the_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcor.CodingOnlineRunner(tconfig.load_config(YAML, OV), ByteTokenizer(), _tasks(tcor))


def test_version_stamps_flow_into_batch():
    runner = _port_runner()
    try:
        runner._sync_weights()
        request, futures, version = runner._submit_batch()
        result = runner._collect(request, futures, version)
        assert result.version == 1 and result.response_ids.shape == (16, 16)
        assert result.response_mask.all()
        runner.param_version = 3
        batch = {"loss_mask": torch.ones((4, 8), dtype=torch.bool)}
        runner._augment_batch(batch, result)
        assert batch["versions"].dtype == torch.float32 and batch["versions"].shape == (4, 8)
        assert torch.equal(batch["versions"], torch.full((4, 8), 1.0))
        assert torch.equal(batch["current_version"], torch.full((4,), 3.0))
    finally:
        runner.server.stop()


def test_the_server_never_holds_the_learners_tensors():
    """After ``_sync_weights`` the server's params are a copy: an in-place
    update of the state (as the train step makes) leaves them unchanged."""
    runner = _port_runner()
    try:
        runner._sync_weights()
        served = runner.server._params
        before = [t.clone() for t in tree_leaves(served)]
        live = tree_leaves(runner.state.params)
        assert all(s.data_ptr() != t.data_ptr() for s, t in zip(tree_leaves(served), live))
        with torch.no_grad():
            for t in live:
                t.add_(1.0)
        assert all(torch.equal(s, b) for s, b in zip(tree_leaves(served), before))
        assert runner.param_version == 1
    finally:
        runner.server.stop()


def _rollout_arrays(seed=0):
    """16 rows (2 tasks x 8): left-padded prompts; responses that are Python
    snippets, right, wrong, failing or no code, as byte tokens; behaviour
    logprobs; the tasks' test cases as answers."""
    r = np.random.default_rng(seed)
    tok = JTokenizer()
    tasks = _tasks(jcor)[:2]
    B, P, N = 16, 64, 16
    prompt_ids = np.zeros((B, P), np.int32)
    prompt_mask = np.zeros((B, P), bool)
    response_ids = np.zeros((B, N), np.int32)
    response_mask = np.zeros((B, N), bool)
    for i in range(B):
        t = i // 8
        p = tok.encode(tasks[t].prompt)
        prompt_ids[i, P - len(p):] = p
        prompt_mask[i, P - len(p):] = True
        text = [f"print({t})", f"print({t + 1})", "print(1/0)", "hi there",
                f"print(0+{t})", "x=(", f"print({t})\n", "def"][i % 8]
        ids = tok.encode(text)
        response_ids[i, :len(ids)] = ids
        response_mask[i, :len(ids)] = True
    lps = np.where(response_mask, r.uniform(-6.0, -0.1, (B, N)), 0).astype(np.float32)
    answers = [tasks[i // 8].answer for i in range(B)]
    return dict(prompt_ids=prompt_ids, prompt_mask=prompt_mask, response_ids=response_ids,
                response_mask=response_mask, response_logprobs=lps, answers=answers)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def test_train_on_result_matches_the_jax_runner(monkeypatch):
    """One ``_train_on_result`` on one rollout stamped version 1 with the
    learner at version 2, both runners, from the JAX runner's init, with
    the default reward (the exec verifier on every response)."""
    jcfg = jconfig.load_config(YAML, OV)
    jr = jcor.CodingOnlineRunner(jcfg, JTokenizer(), _tasks(jcor))
    try:
        np_params = jax.tree_util.tree_map(np.asarray, jr.state.params)
        tr = _port_runner(np_params)
        try:
            assert tr.recompute_logprobs and tr.logprob_fn is not None
            calls = {"jax": 0, "torch": 0}
            for side, mod in (("jax", jcv), ("torch", tcv)):
                real = mod.run_test_case

                def counting(*a, side=side, real=real, **kw):
                    calls[side] += 1
                    return real(*a, **kw)

                monkeypatch.setattr(mod, "run_test_case", counting)
            perm = np.random.default_rng(3).permutation(16)
            monkeypatch.setattr(jax.random, "permutation", lambda key, n: jnp.asarray(perm[:n]))
            monkeypatch.setattr(tr, "_permutation", lambda n: perm[:n])
            jr.param_version = tr.param_version = 2
            arrays = _rollout_arrays()
            jres = jio.RolloutResult(**copy.deepcopy(arrays), version=1)
            tres = tio.RolloutResult(**copy.deepcopy(arrays), version=1)
            jm = jr._train_on_result(jres)
            tm = tr._train_on_result(tres)
        finally:
            tr.server.stop()
    finally:
        jr.server.stop()

    np.testing.assert_array_equal(tres.rewards, jres.rewards)
    assert sorted(set(tres.rewards.tolist())) == [0.0, 1.0]
    # the verifier ran every response that holds code (3 of the 8 kinds hold none)
    assert calls["torch"] == calls["jax"] == 10
    actor = sorted(k for k in jm if k.startswith("actor/"))
    assert actor == sorted(k for k in tm if k.startswith("actor/"))
    for k in actor:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert jm["actor/grad_norm"] > 0
    assert set(tm) == set(jm)
    # adam's first step moves a weight by lr * g / (|g| + eps), at most lr
    # (3e-3): where |g| is within float rounding of zero the two packages
    # may take different fractions of that step. Elsewhere within 1e-5.
    off = total = 0
    for got, want in zip(tree_leaves(tr.state.params),
                         jax.tree_util.tree_leaves(jr.state.params)):
        d = np.abs(_np(got) - _np(want))
        assert d.max() <= 3e-3
        off, total = off + int((d > 1e-5).sum()), total + d.size
    assert off <= 1e-3 * total, (off, total)


def test_online_run_stamps_versions_and_runs_the_verifier():
    """Two overlapped online steps: the verifier scores every response, the
    param version is 3 (the first sync and one a step), the lag at most 2,
    and the metrics are finite."""
    texts = []

    def reward_fn(t, answers):
        texts.extend(t)
        return tcv.batch_code_rewards(t, answers, timeout_s=2.0, partial_credit=True)

    history = _port_runner(None, reward_fn=reward_fn).run(2)
    assert len(history) == 2 and len(texts) == 2 * 16
    assert history[-1]["online/param_version"] == 3.0
    assert all(h["online/version_lag"] <= 2.0 for h in history)
    assert all(np.isfinite(v) for h in history for v in h.values())


def test_the_verifier_runs_code_textwrapped():
    """A multi-line program with a function, read from stdin, on both."""
    code = textwrap.dedent("""
        def double(x):
            return 2 * x
        n = int(input())
        for i in range(n):
            print(double(i))
    """)
    for mod in (tcv, jcv):
        assert mod.code_reward(f"```python\n{code}```", [{"input": "3", "output": "0\n2\n4"}])
