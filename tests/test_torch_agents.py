"""The port's agentic path (tool-call parsers, tools, ``AgentLoop``, the
train-batch builders, ``AgentRunner``, ``main_agent_grpo``) and its
``serve_openai`` entry point against the JAX package's, on the CPU.

Greedy static engines on both sides from one JAX init (``params_from_numpy``;
f32, 2 layers, D=64, byte vocabulary). A scripted parse forces tool calls
(random weights never write a tag). Tokens, masks, turn spans and turn
errors must be equal; logprobs agree within 1e-5 (summation order only);
the train-batch arrays are equal; a runner step's ``actor/*`` metrics agree
within 1e-4 relative (1e-6 absolute), its ``agent/*`` metrics exactly, its
gradients (adam's first moment) within 1e-4 of each leaf's largest.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from rlinf_tpu import config as jconfig
from rlinf_tpu.agents import agent_loop as jal
from rlinf_tpu.agents import tools as jtools
from rlinf_tpu.algorithms import toolcall_parsers as jtp
from rlinf_tpu.data.datasets import PromptDataset as JDataset
from rlinf_tpu.data.datasets import PromptExample as JExample
from rlinf_tpu.data.tokenizers import ByteTokenizer as JTokenizer
from rlinf_tpu.models.llm import init_params as jinit_params
from rlinf_tpu.rollout.engine import RolloutEngine as JEngine
from rlinf_tpu.runners.agent_runner import AgentRunner as JRunner
from rlinf_tpu_torch import config as tconfig
from rlinf_tpu_torch import main_agent_grpo, serve_openai
from rlinf_tpu_torch.agents import agent_loop as tal
from rlinf_tpu_torch.agents import tools as ttools
from rlinf_tpu_torch.algorithms import toolcall_parsers as ttp
from rlinf_tpu_torch.data.datasets import PromptDataset, PromptExample
from rlinf_tpu_torch.data.tokenizers import ByteTokenizer
from rlinf_tpu_torch.models.llm.convert import params_from_numpy
from rlinf_tpu_torch.rollout.engine import RolloutEngine
from rlinf_tpu_torch.runners.agent_runner import AgentRunner
from rlinf_tpu_torch.training.train_state import tree_leaves

torch.set_num_threads(2)

YAML = "examples/reasoning/config/grpo_demo_tiny.yaml"
# greedy, 12 new tokens a turn, 2 prompts x 4 a step; an untied lm head (with
# the tied one, greedy decoding of random weights repeats the last token)
OV = ["model.tie_word_embeddings=false", "sampling.greedy=true", "sampling.max_new_tokens=12",
      "algorithm.group_size=4", "runner.rollout_batch_size=2", "runner.log_dir=null", "optimizer.lr=1e-4"]
LP_TOL = 1e-5


# ---------------------------------------------------------------------------
# parsers and tools
# ---------------------------------------------------------------------------

TEXTS = [
    "thinking... <tool=calc>2+3*4</tool> trailing junk",
    "<tool=web-search>  capital of France \n</tool><tool=calc>1</tool>",
    "no tools here",
    "I should look up <search>capital of France</search> now",
    "<search></search>",
    '<tool_call>{"name": "calc", "arguments": {"x": 1}}</tool_call> after',
    '<tool_call>\n{"name": 3}\n</tool_call>',
    "<tool_call>not json</tool_call>",
    "<tool=calc>unterminated",
    "",
]


@pytest.mark.parametrize("name", ["tag", "search_tags", "json"])
@pytest.mark.parametrize("text", TEXTS)
def test_parsers_match_jax(name, text):
    got, want = ttp.get_toolcall_parser(name)(text), jtp.get_toolcall_parser(name)(text)
    assert (got is None) == (want is None)
    if got is not None:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_unknown_parser_raises_as_jax():
    with pytest.raises(KeyError, match="Unknown toolcall parser"):
        ttp.get_toolcall_parser("nope")
    assert sorted(ttp._PARSER_REGISTRY) == sorted(jtp._PARSER_REGISTRY)


@pytest.mark.parametrize("args", [
    "2+3*4", "(1+2)**2 / 3", "-7 // 2", "10 % 4", "+2.5 * 2", "1/0",
    "__import__('os')", "open('x')", "2 if 1 else 3", "x + 1", "[1, 2]", "'a' * 3", "1 +",
])
def test_calculator_matches_jax(args):
    """Through each registry: arithmetic, errors, and unsafe input refused."""
    got = ttools.ToolRegistry([ttools.CalculatorTool()]).call("calc", args)
    assert got == jtools.ToolRegistry([jtools.CalculatorTool()]).call("calc", args)


def test_registry_echo_search_and_sessions_match_jax():
    corpus = {"france": "Paris is the capital of France.", "Mars": "the red planet"}

    class Counter:
        name, stateful = "count", True

        def __init__(self):
            self.seen = {}

        def __call__(self, args, session=None):
            self.seen[session] = self.seen.get(session, 0) + 1
            return f"{session}:{self.seen[session]}"

    regs = [mod.ToolRegistry([mod.EchoTool(), mod.DictSearchTool(corpus), Counter()])
            for mod in (ttools, jtools)]
    calls = [("echo", " hi "), ("search", "capital of FRANCE"), ("search", "zanzibar"),
             ("search", "mars"), ("count", ""), ("count", ""), ("nope", "x")]
    for session in (0, 1, 0):
        got = [regs[0].call(n, a, session=session) for n, a in calls]
        assert got == [regs[1].call(n, a, session=session) for n, a in calls]
    assert "echo" in regs[0] and "nope" not in regs[0]


# ---------------------------------------------------------------------------
# the agent loop and the train batches
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    jcfg = jconfig.load_config(YAML, OV)
    tcfg = tconfig.load_config(YAML, OV)
    jp = jinit_params(jcfg.model, jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    tp = params_from_numpy(np_params, tcfg.model, device="cpu")
    return jcfg, tcfg, jp, tp, np_params


def _scripted(mod):
    """A parse that fires on any text: calc(1+1) where the text's code
    points have an even sum, else a tool no registry holds (an error
    observation)."""
    def parse(text):
        if not text:
            return None
        tool = "calc" if sum(map(ord, text)) % 2 == 0 else "nope"
        return mod.ToolCall(tool=tool, args="1+1", raw=text[:3], end_pos=min(3, len(text)))
    return parse


def _loops(setup, max_turns=3, scripted=True):
    jcfg, tcfg, jp, tp, _ = setup
    lc = dict(max_turns=max_turns, max_total_len=96)
    jloop = jal.AgentLoop(JEngine(jcfg.model, jcfg.sampling, prompt_bucket=32), JTokenizer(),
                          jtools.ToolRegistry([jtools.CalculatorTool()]),
                          jal.AgentLoopConfig(**lc))
    tloop = tal.AgentLoop(RolloutEngine(tcfg.model, tcfg.sampling, prompt_bucket=32,
                                        device="cpu"), ByteTokenizer(),
                          ttools.ToolRegistry([ttools.CalculatorTool()]),
                          tal.AgentLoopConfig(**lc))
    if scripted:
        jloop.parse, tloop.parse = _scripted(jtp), _scripted(ttp)
    return jloop, tloop


PROMPTS = [f"question {i}: " for i in range(6)]


@pytest.fixture(scope="module")
def rollouts(setup):
    jloop, tloop = _loops(setup)
    tok = JTokenizer()
    prompts = [tok.encode(p) for p in PROMPTS]
    jr = jloop.run(setup[2], prompts, jax.random.PRNGKey(0))
    tr = tloop.run(setup[3], prompts, torch.Generator().manual_seed(0))
    return jr, tr


@pytest.mark.parametrize("scripted", [True, False])
def test_agent_loop_matches_jax(setup, rollouts, scripted):
    """Three turns with the scripted parse (calls in turns 1 and 2, some of
    them errors), or the tag parser (no call in random text): equal tokens,
    masks, spans, errors, counts and final text; logprobs within 1e-5; the
    observation tokens masked off with logprob 0."""
    if scripted:
        jr, tr = rollouts
    else:
        jloop, tloop = _loops(setup, scripted=False)
        prompts = [JTokenizer().encode(p) for p in PROMPTS[:3]]
        jr = jloop.run(setup[2], prompts, jax.random.PRNGKey(0))
        tr = tloop.run(setup[3], prompts, torch.Generator())
    for j, t in zip(jr, tr):
        assert t.token_ids == [int(x) for x in j.token_ids]
        assert t.loss_mask == j.loss_mask
        np.testing.assert_allclose(t.logprobs, j.logprobs, atol=LP_TOL)
        assert t.turn_spans == j.turn_spans and t.turn_errors == j.turn_errors
        assert (t.num_turns, t.num_tool_calls, t.prompt_len, t.final_text) == (
            j.num_turns, j.num_tool_calls, j.prompt_len, j.final_text)
        off = [i for i in range(t.prompt_len, len(t.token_ids)) if not t.loss_mask[i]]
        assert all(t.logprobs[i] == 0.0 for i in off)
    if scripted:
        assert all(t.num_turns == 3 and t.num_tool_calls == 2 for t in tr)
        errs = [e for t in tr for e in t.turn_errors]
        assert True in errs and errs.count(False) > len(tr)
        assert any("<result>2</result>" in t.final_text for t in tr)
    else:
        assert all(t.num_turns == 1 and t.num_tool_calls == 0 for t in tr)


def _as_port(r):
    return tal.AgentRollout(**{f.name: getattr(r, f.name) for f in dataclasses.fields(r)})


@pytest.mark.parametrize("seq_bucket", [32, 128])
def test_agent_train_batch_matches_jax(rollouts, seq_bucket):
    jr, _ = rollouts
    adv = np.asarray([1.0, -1.0, 0.5, -0.5, 0.25, 0.0], np.float32)
    want = jal.build_agent_train_batch(jr, adv, pad_id=0, seq_bucket=seq_bucket)
    got = tal.build_agent_train_batch([_as_port(r) for r in jr], adv, pad_id=0,
                                      seq_bucket=seq_bucket)
    for k, v in want.to_dict().items():
        np.testing.assert_array_equal(got.to_dict()[k], np.asarray(v), err_msg=k)
    assert np.all(got.advantages[~got.loss_mask] == 0)


@pytest.mark.parametrize("mode", ["turn", "trajectory"])
def test_turn_level_train_batch_matches_jax(rollouts, mode):
    """Per-turn grpo_dynamic advantages over 3 questions x 2, exact up to
    f32 rounding of the normalisation (1e-6)."""
    jr, _ = rollouts
    turn_rewards = [[float((i * 7 + k * 3) % 5) for k in range(r.num_turns)]
                    for i, r in enumerate(jr)]
    want = jal.build_turn_level_train_batch(jr, turn_rewards, 2, pad_id=0,
                                            advantage_mode=mode, seq_bucket=32)
    got = tal.build_turn_level_train_batch([_as_port(r) for r in jr], turn_rewards, 2,
                                           pad_id=0, advantage_mode=mode, seq_bucket=32)
    for k, v in want.to_dict().items():
        np.testing.assert_allclose(got.to_dict()[k], np.asarray(v), atol=1e-6, err_msg=k)
    assert np.abs(got.advantages).max() > 0


# ---------------------------------------------------------------------------
# the runner and the entry points
# ---------------------------------------------------------------------------


def _examples():
    return [(f"compute {i}+{i}: ", str(2 * i)) for i in range(8)]


def reward_rule(texts, answers):
    """1.0 where a row's index plus its text's code points is a multiple of
    3: greedy rows of one group are equal, so the index is what mixes the
    rewards inside a group (and makes the advantages non-zero)."""
    return [float((i + sum(map(ord, t))) % 3 == 0) for i, t in enumerate(texts)]


def _session_calc(mod):
    """The calculator, its answer tagged with the conversation: greedy rows
    of one group then differ from their second turn on, so that GRPO's
    gradient does not cancel over the group."""
    class SessionCalc(mod.CalculatorTool):
        stateful = True

        def __call__(self, args, session=None):
            return f"{super().__call__(args)} #{session}"
    return SessionCalc()


def test_run_step_matches_the_jax_runner(setup):
    """One greedy ``run_step`` (2 prompts x 4, 2 turns, the scripted parse)
    from one init: the same texts, rewards and ``agent/*`` metrics, the
    ``actor/*`` metrics within 1e-4, adam's first moment within 1e-4 of
    each leaf's largest, the params after it as stated below."""
    jcfg, tcfg, _, _, np_params = setup
    lc = dict(max_turns=2, max_total_len=96)
    jrun = JRunner(jcfg, JTokenizer(), JDataset([JExample(p, a) for p, a in _examples()]),
                   jtools.ToolRegistry([_session_calc(jtools)]), reward_rule,
                   loop_cfg=jal.AgentLoopConfig(**lc),
                   init_params_override=lambda rng: jax.tree_util.tree_map(
                       jax.numpy.asarray, np_params))
    trun = AgentRunner(tcfg, ByteTokenizer(),
                       PromptDataset([PromptExample(p, a) for p, a in _examples()]),
                       ttools.ToolRegistry([_session_calc(ttools)]), reward_rule,
                       loop_cfg=tal.AgentLoopConfig(**lc), device="cpu",
                       init_params_override=lambda seed: params_from_numpy(
                           np_params, tcfg.model, device="cpu"))
    jrun.loop.parse, trun.loop.parse = _scripted(jtp), _scripted(ttp)
    texts = {}
    for side, r in (("jax", jrun), ("torch", trun)):
        real = r.reward_fn
        r.reward_fn = lambda t, a, side=side, real=real: (texts.setdefault(side, list(t)),
                                                          real(t, a))[1]
    jm, tm = jrun.run_step(), trun.run_step()
    assert texts["torch"] == texts["jax"]
    assert set(tm) == set(jm)
    for k in sorted(jm):
        if k.startswith("agent/"):
            assert tm[k] == jm[k], k
        elif k.startswith("actor/"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert 0 < jm["agent/reward_mean"] < 1 and jm["agent/num_turns_mean"] == 2.0
    assert jm["actor/grad_norm"] > 1e-3
    assert len(set(texts["jax"][:4])) > 1
    # the gradients, through adam's first moment (0.1 g): within 1e-4 of each
    # leaf's largest. Adam's first step moves a weight by lr * g / (|g| + eps),
    # which is ill-conditioned where |g| is near rounding: the params after
    # the step agree to one step (lr = 1e-4), and within 1e-5 elsewhere.
    jmu = jax.tree_util.tree_leaves(_adam_mu(jrun.state.opt_state))
    for got, want in zip(tree_leaves(trun.state.opt_state["mu"]), jmu):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    off = total = 0
    for got, want in zip(tree_leaves(trun.state.params),
                         jax.tree_util.tree_leaves(jrun.state.params)):
        d = np.abs(got.numpy() - np.asarray(want))
        assert d.max() <= 1e-4
        off, total = off + int((d > 1e-5).sum()), total + d.size
    assert off <= 1e-2 * total, (off, total)


def _adam_mu(opt_state):
    """The first moment in optax's chained state."""
    nodes = jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu"))
    return next(n.mu for n in nodes if hasattr(n, "mu"))


def test_main_agent_grpo_runs_on_the_cpu(tmp_path):
    history = main_agent_grpo.main(["--device", "cpu", "runner.max_steps=2",
                                    f"runner.log_dir={tmp_path}"])
    assert len(history) == 2 and all(np.isfinite(v) for h in history for v in h.values())
    assert (tmp_path / "metrics.jsonl").exists()


def test_main_agent_grpo_config_is_the_jax_examples():
    cfg = main_agent_grpo.trainer_config()
    assert cfg.model.vocab_size == 258 and cfg.model.max_seq_len == 512
    assert (cfg.sampling.max_new_tokens, cfg.optimizer.lr, cfg.algorithm.group_size,
            cfg.runner.rollout_batch_size, cfg.runner.max_steps) == (24, 1e-4, 4, 4, 20)
    cfg = main_agent_grpo.trainer_config("qwen2_0_5b", ["runner.max_steps=3"])
    assert cfg.model.hidden_size == 896 and cfg.runner.max_steps == 3
    args = main_agent_grpo.parse_args(["--preset", "qwen2_0_5b", "a.b=1"])
    assert (args.device, args.preset, args.overrides) == ("cuda", "qwen2_0_5b", ["a.b=1"])


def test_serve_openai_flags_and_model_path():
    args = serve_openai.parse_args([])
    assert (args.device, args.preset, args.port, args.max_new_tokens, args.model) == (
        "cuda", "tiny", 8000, 256, None)
    assert serve_openai.model_config("tiny").vocab_size == 300
    assert serve_openai.model_config("qwen2_1_5b").hidden_size == 1536
    with pytest.raises(ValueError, match="unknown LLMConfig preset"):
        serve_openai.model_config("nope")
    with pytest.raises(FileNotFoundError, match="config.json"):
        serve_openai.main(["--device", "cpu", "--model", "/nowhere"])


def test_serve_openai_serves_on_the_cpu():
    import json
    import urllib.request

    server, http = serve_openai.build_server(serve_openai.parse_args(
        ["--device", "cpu", "--port", "0", "--max-new-tokens", "8"]))
    try:
        req = urllib.request.Request(
            http.url + "/v1/completions",
            data=json.dumps({"prompt": "hi", "max_tokens": 5}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
        assert out["usage"] == {"prompt_tokens": 2, "completion_tokens": 5, "total_tokens": 7}
        assert server.engine.num_slots == 32 and server.engine.cfg.vocab_size == 300
    finally:
        http.stop()
        server.stop()


def test_the_card_is_the_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_agent_grpo.main(["runner.max_steps=1", "runner.log_dir=null"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_openai.main(["--port", "0"])
