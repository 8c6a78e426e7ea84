"""The port's agent recipes (Search-R1 over a local retrieval server,
rStar2 with its Python session tools, the WideSeek-R1 team and its train
batch, failed-turn masking, the external-agent adapter) against the JAX
package's, on the CPU.

The tiny model of the JAX package's ``tests/test_agent_recipes.py`` (f32, 2
layers, D=32, byte vocabulary) with an untied lm head, one JAX init on both
sides (``params_from_numpy``), greedy static engines. Random weights never
write a tool tag, so a scripted parse (the same on both sides) makes the
calls. Token ids, loss masks, turn spans, turn errors, counts and final text
must be equal; logprobs agree within 1e-5 (summation order only); the
WideSeek team batches are equal, their advantages within 1e-6 and their
behaviour logprobs within 1e-5. The tools
(BM25 index and server, both Python tools) give equal outputs.
"""

import dataclasses
import json
from urllib.request import Request, urlopen

import jax
import numpy as np
import pytest
import torch

from rlinf_tpu.agents import agent_loop as jal
from rlinf_tpu.agents import recipes as jrec
from rlinf_tpu.agents import retrieval as jret
from rlinf_tpu.agents import rstar2 as jrs2
from rlinf_tpu.algorithms import toolcall_parsers as jtp
from rlinf_tpu.data.tokenizers import ByteTokenizer as JTokenizer
from rlinf_tpu.models.llm import LLMConfig as JLLMConfig
from rlinf_tpu.models.llm import SamplingParams as JSamplingParams
from rlinf_tpu.models.llm import init_params as jinit_params
from rlinf_tpu.rollout.engine import RolloutEngine as JEngine
from rlinf_tpu_torch.agents import agent_loop as tal
from rlinf_tpu_torch.agents import recipes as trec
from rlinf_tpu_torch.agents import retrieval as tret
from rlinf_tpu_torch.agents import rstar2 as trs2
from rlinf_tpu_torch.algorithms import toolcall_parsers as ttp
from rlinf_tpu_torch.data.tokenizers import ByteTokenizer
from rlinf_tpu_torch.models.llm.config import LLMConfig
from rlinf_tpu_torch.models.llm.convert import params_from_numpy
from rlinf_tpu_torch.models.llm.sampler import SamplingParams
from rlinf_tpu_torch.rollout.engine import RolloutEngine

torch.set_num_threads(2)

MODEL = dict(vocab_size=258, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2,
             num_kv_heads=2, max_seq_len=512, dtype="float32", qkv_bias=False, rope_theta=1e4,
             tie_word_embeddings=False)
SAMPLING = dict(max_new_tokens=16, eos_token_id=-1, pad_token_id=0, greedy=True)
LP_TOL = 1e-5

CORPUS = {f"doc{i}": f"Fact {i}: the {w} of {c} is {v}."
          for i, (w, c, v) in enumerate([
              ("capital", "France", "Paris"), ("capital", "Japan", "Tokyo"),
              ("river", "Egypt", "the Nile"), ("currency", "Japan", "the yen"),
              ("capital", "Italy", "Rome"), ("mountain", "Nepal", "Everest")])}
QUESTIONS = ["capital of France?", "capital of Japan?", "river of Egypt?", "currency of Japan?"]
ANSWERS = ["Paris", "Tokyo", "the Nile", "yen"]


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = JLLMConfig(**MODEL), LLMConfig(**MODEL)
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    return (JEngine(jcfg, JSamplingParams(**SAMPLING)), jp,
            RolloutEngine(tcfg, SamplingParams(**SAMPLING), device="cpu"), tp)


def scripted(mod, plan):
    """A parse that calls ``plan(k, text)`` on its k-th use: a (tool, args)
    pair makes a call that keeps the turn's first 3 characters, None none."""
    seen = {"k": 0}

    def parse(text):
        k = seen["k"]
        seen["k"] += 1
        call = plan(k, text) if text else None
        if call is None:
            return None
        return mod.ToolCall(tool=call[0], args=call[1], raw=text[:3], end_pos=min(3, len(text)))
    return parse


def assert_same(jr, tr):
    assert len(jr) == len(tr)
    for j, t in zip(jr, tr):
        assert t.token_ids == [int(x) for x in j.token_ids]
        assert t.loss_mask == list(j.loss_mask)
        np.testing.assert_allclose(t.logprobs, j.logprobs, atol=LP_TOL)
        assert t.turn_spans == j.turn_spans and t.turn_errors == j.turn_errors
        assert (t.num_turns, t.num_tool_calls, t.prompt_len, t.final_text) == (
            j.num_turns, j.num_tool_calls, j.prompt_len, j.final_text)
        off = [i for i in range(t.prompt_len, len(t.token_ids)) if not t.loss_mask[i]]
        assert all(t.logprobs[i] == 0.0 for i in off)


def prompts(texts):
    tok = ByteTokenizer()
    return [tok.encode(t) for t in texts]


# ---------------------------------------------------------------------------
# retrieval: BM25, the server, the HTTP tool
# ---------------------------------------------------------------------------

QUERIES = ["capital of France", "JAPAN capital currency", "the", "", "zanzibar nile",
           "fact 3 of japan", "Everest!! nepal?"]


@pytest.mark.parametrize("query", QUERIES)
@pytest.mark.parametrize("topk", [1, 3, 10])
def test_bm25_matches_jax(query, topk):
    got = tret.BM25Index(CORPUS).search(query, topk=topk)
    assert got == jret.BM25Index(CORPUS).search(query, topk=topk)
    assert all(s > 0 for _, _, s in got)


def test_retrieval_servers_and_tools_match_jax():
    """Both servers answer /retrieve, /health and a bad request with the same
    JSON; the HTTP tools format the same documents."""
    servers = [tret.RetrievalServer(CORPUS).start(), jret.RetrievalServer(CORPUS).start()]
    try:
        assert all(s.url.startswith("http://127.0.0.1:") for s in servers)

        def post(url, body):
            req = Request(url + "/retrieve", data=body, headers={"Content-Type": "application/json"})
            try:
                with urlopen(req, timeout=10) as r:
                    return r.status, json.loads(r.read())
            except Exception as e:  # noqa: BLE001  (the 400's body)
                return e.code, json.loads(e.read())

        for q in QUERIES:
            body = json.dumps({"query": q, "topk": 2}).encode()
            assert post(servers[0].url, body) == post(servers[1].url, body)
        bad = b'{"query": "x", "topk": "many"}'
        assert post(servers[0].url, bad)[0] == 400 == post(servers[1].url, bad)[0]
        health = [json.loads(urlopen(s.url + "/health", timeout=10).read()) for s in servers]
        assert health[0] == health[1] == {"ok": True, "num_docs": len(CORPUS)}
        tools = [tret.HTTPSearchTool(servers[0].url, topk=2, max_doc_chars=20),
                 jret.HTTPSearchTool(servers[1].url, topk=2, max_doc_chars=20)]
        for q in QUERIES:
            assert tools[0](q) == tools[1](q)
        assert tools[0]("zanzibar") == "no results"
    finally:
        for s in servers:
            s.stop()


# ---------------------------------------------------------------------------
# Search-R1
# ---------------------------------------------------------------------------


def _search_plan(k, text):
    """Turn 1 of conversation k searches its question; later turns answer."""
    return ("search", QUESTIONS[k]) if k < len(QUESTIONS) else None


@pytest.mark.parametrize("source", ["server", "retriever", "corpus"])
def test_searchr1_matches_jax(tiny, source):
    jeng, jp, teng, tp = tiny
    server = tret.RetrievalServer(CORPUS).start() if source == "server" else None
    index = tret.BM25Index(CORPUS)
    kw = {"server": dict(search_url=server.url if server else None),
          "retriever": dict(retriever=lambda q: index.search(q, topk=1)[0][1]),
          "corpus": {}}[source]
    try:
        recipes = [mod.SearchR1Recipe(max_turns=3, max_total_len=256) for mod in (jrec, trec)]
        jloop = recipes[0].make_loop(jeng, JTokenizer(), CORPUS, **kw)
        tloop = recipes[1].make_loop(teng, ByteTokenizer(), CORPUS, **kw)
        jloop.parse, tloop.parse = scripted(jtp, _search_plan), scripted(ttp, _search_plan)
        ps = prompts(f"Q: {q}\n" for q in QUESTIONS)
        jr = jloop.run(jp, ps, jax.random.PRNGKey(0))
        tr = tloop.run(tp, ps, torch.Generator().manual_seed(0))
    finally:
        if server:
            server.stop()
    assert_same(jr, tr)
    assert all(t.num_turns == 2 and t.num_tool_calls == 1 for t in tr)
    want = {"server": "<result>Doc 1: Fact 0", "retriever": "<result>Fact 0",
            "corpus": "<result>"}[source]
    assert want in tr[0].final_text
    for metric, bonus in (("em", 0.0), ("f1", 0.0), ("f1", 0.5)):
        jrc = jrec.SearchR1Recipe(reward_metric=metric, format_bonus=bonus)
        trc = trec.SearchR1Recipe(reward_metric=metric, format_bonus=bonus)
        assert trc.batch_rewards(tr, ANSWERS) == jrc.batch_rewards(jr, ANSWERS)
    good = tal.AgentRollout([], [], [], final_text="x <answer>Paris</answer>")
    assert trec.SearchR1Recipe(format_bonus=0.5).reward(good, "Paris") == 1.5


# ---------------------------------------------------------------------------
# rStar2
# ---------------------------------------------------------------------------

RSTAR2_TURN2 = ["print(x)", "print(x * 2)", "1/0", "while True: pass"]


def _rstar2_plan(k, text):
    """Turn 1 of conversation i assigns x = 7 (i + 1); turn 2 prints it,
    doubles it, divides by zero or loops past the timeout."""
    n = len(RSTAR2_TURN2)
    if k < n:
        return "python", f"x = {7 * (k + 1)}"
    if k < 2 * n:
        return "python", RSTAR2_TURN2[k - n]
    return None


def test_rstar2_matches_jax(tiny):
    jeng, jp, teng, tp = tiny
    recipes = [mod.RStar2Recipe(max_turns=3, max_total_len=256, timeout_s=1.0)
               for mod in (jrec, trec)]
    jloop = recipes[0].make_loop(jeng, JTokenizer())
    tloop = recipes[1].make_loop(teng, ByteTokenizer())
    jloop.parse, tloop.parse = scripted(jtp, _rstar2_plan), scripted(ttp, _rstar2_plan)
    ps = prompts([f"Compute {i} * 7.\n" for i in range(1, 5)])
    jr = jloop.run(jp, ps, jax.random.PRNGKey(1))
    tr = tloop.run(tp, ps, torch.Generator().manual_seed(1))
    assert_same(jr, tr)
    assert "<result>(no output)</result>" in tr[0].final_text    # turn 1 prints nothing
    assert "<result>7</result>" in tr[0].final_text.split("(no output)")[1]
    assert "<result>28</result>" in tr[1].final_text         # state carried over
    assert "<result>error: ZeroDivisionError: division by zero</result>" in tr[2].final_text
    assert "<result>error: execution timed out</result>" in tr[3].final_text
    assert [t.turn_errors for t in tr] == [[False, False, False]] * 2 + [[False, True, False]] * 2
    answers = ["7", "28", "21", "28"]
    assert recipes[1].batch_rewards(tr, answers) == recipes[0].batch_rewards(jr, answers)
    good = tal.AgentRollout([], [], [], final_text="The answer is \\boxed{42}")
    bad = tal.AgentRollout([], [], [], final_text="<result>error: boom</result> \\boxed{42}")
    assert recipes[1].reward(good, "42") == 1.0
    assert recipes[1].reward(bad, "42") == pytest.approx(0.9) == recipes[0].reward(bad, "42")


def test_python_session_tool_matches_jax():
    """The recipe's tool: state across calls, isolated sessions, a failed
    snippet kept out of the session, only new stdout, the timeout."""
    tools = [trec.PythonSessionTool(timeout_s=1.0), jrec.PythonSessionTool(timeout_s=1.0)]
    calls = [("x = 21", 0), ("print(x * 2)", 0), ("print(x)", 1), ("print(x + 1)", 0),
             ("print('a')", 2), ("print('b')", 2), ("raise ValueError('no')", 2),
             ("while True: pass", 0), ("print(x)", 0)]
    got = [tools[0](a, session=s) for a, s in calls]
    assert got == [tools[1](a, session=s) for a, s in calls]
    assert got[:2] == ["(no output)", "42"] and got[3] == "22" and got[5] == "b"
    assert got[2].startswith("error:") and got[6] == "error: ValueError: no"
    assert got[7] == "error: execution timed out" and got[8] == "21"
    tools[0].reset()
    assert tools[0]("print(x)", session=0).startswith("error:")


def test_session_python_tool_matches_jax():
    """rStar2's forked executor: Jupyter echo, isolated sessions, the
    timeout survived, a crash, output truncation."""
    tools = [trs2.SessionPythonTool(timeout_s=1.0, max_output_chars=40),
             jrs2.SessionPythonTool(timeout_s=1.0, max_output_chars=40)]
    calls = [("x = 5", "s1"), ("x + 1", "s1"), ("x + 1", "s2"), ("while True: pass", "s1"),
             ("x", "s1"), ("print('y' * 100)", "s1"), ("import os; os._exit(3)", "s3"),
             ("def f(:", "s1"), ("s = input()\nprint(repr(s))", "s1")]
    got = [tools[0](a, session=s) for a, s in calls]
    assert got == [tools[1](a, session=s) for a, s in calls]
    assert got[:2] == ["", "6"] and got[3] == "error: timeout" and got[4] == "5"
    assert got[2].startswith("error:") and "NameError" in got[2]
    assert got[5] == "y" * 40 + "...[truncated]" and got[6] == "error: crashed"
    assert got[7].startswith("error: SyntaxError")
    for name in ("split_code",):
        for code in ("x = 1\ny = 2\nx + y", "print(3)", "x = 1", ""):
            assert getattr(trs2, name)(code) == getattr(jrs2, name)(code)
    ex = [trs2.PersistentExecutor(), jrs2.PersistentExecutor()]
    for code, stdin in (("a = 21", ""), ("a * 2", ""), ("print(a)\na + 1", ""), ("1/0", ""),
                        ("s = input()\nprint(s.upper())", "hi\n")):
        assert ex[0].execute(code, stdin) == ex[1].execute(code, stdin)
    assert ex[0].history == ex[1].history


# ---------------------------------------------------------------------------
# WideSeek-R1 and failed-turn masking
# ---------------------------------------------------------------------------


def _team_plan(k, text):
    """Every parse asks for a search, every third one of an unknown tool (a
    failed turn); only the searchers have a turn that may call."""
    return ("nope" if k % 3 == 2 else "search", "capital of " + text[:4])


@pytest.fixture(scope="module")
def teams(tiny):
    jeng, jp, teng, tp = tiny
    questions = ["capital of France?", "capital of France?", "river of Egypt?",
                 "river of Egypt?"]
    out = []
    for mod, loopmod, tp_mod, eng, params, tok, gen in (
            (jrec, jal, jtp, jeng, jp, JTokenizer(), jax.random.PRNGKey(2)),
            (trec, tal, ttp, teng, tp, ByteTokenizer(), torch.Generator().manual_seed(2))):
        real = loopmod.get_toolcall_parser
        plan = scripted(tp_mod, _team_plan)
        loopmod.get_toolcall_parser = lambda name, plan=plan: plan
        try:
            recipe = mod.WideSeekR1Recipe(num_searchers=2, max_total_len=256)
            out.append((recipe, recipe.run_team(eng, tok, params, questions, CORPUS, gen)))
        finally:
            loopmod.get_toolcall_parser = real
    return out


def test_wideseek_team_matches_jax(teams):
    (_, jt), (trc, tt) = teams
    for role in ("planner", "searcher", "summarizer"):
        assert_same(jt[role], tt[role])
    assert tt["_owner"] == jt["_owner"] == [0, 0, 1, 1, 2, 2, 3, 3]
    assert [len(tt[r]) for r in ("planner", "searcher", "summarizer")] == [4, 8, 4]
    errs = [e for r in tt["searcher"] for e in r.turn_errors]
    assert True in errs and False in errs
    assert any("<result>" in r.final_text for r in tt["searcher"])
    answers = ["Paris", "Paris", "the Nile", "the Nile"]
    assert trc.team_rewards(tt, answers) == teams[0][0].team_rewards(jt, answers)


@pytest.mark.parametrize("normalize", [True, False])
def test_team_batch_matches_jax(teams, normalize):
    """Every role of every team in one batch, GRPO over 2 teams a question,
    failed turns masked out: the arrays equal, advantages within 1e-6."""
    (jrc, jt), (trc, tt) = teams
    answers = ["Paris", "Paris", "the Nile", "the Nile"]
    # two teams answer right so that the advantages are not all zero
    good = "<answer>Paris</answer>"
    jt = {**jt, "summarizer": [dataclasses.replace(jt["summarizer"][0], final_text=good)]
          + jt["summarizer"][1:]}
    tt = {**tt, "summarizer": [dataclasses.replace(tt["summarizer"][0], final_text=good)]
          + tt["summarizer"][1:]}
    jb, jroles, jm = jrc.build_team_batch(jt, answers, group_size=2, pad_id=0,
                                          normalize_advantages=normalize)
    tb, troles, tm = trc.build_team_batch(tt, answers, group_size=2, pad_id=0,
                                          normalize_advantages=normalize)
    assert troles == jroles and tm == jm
    assert len(troles) == 16 and tm["agent/failed_turns_masked"] > 0
    jd, td = jb.to_dict(), tb.to_dict()
    for k, v in jd.items():
        if k in ("advantages", "old_logprobs"):
            tol = 1e-6 if k == "advantages" else LP_TOL
            np.testing.assert_allclose(td[k], np.asarray(v), atol=tol, err_msg=k)
        else:
            np.testing.assert_array_equal(td[k], np.asarray(v), err_msg=k)
    assert np.abs(td["advantages"]).max() > 0
    for i in range(len(troles)):
        assert len(set(np.round(td["advantages"][i][td["loss_mask"][i]], 6).tolist())) <= 1


def test_mask_failed_turns_matches_jax():
    kw = dict(token_ids=list(range(10)), loss_mask=[False] * 2 + [True] * 8,
              logprobs=[0.0] * 10, num_turns=2, turn_spans=[(2, 5), (7, 10)])
    for errors in ([True, False], [False, True], [], [True, True]):
        r = tal.AgentRollout(**kw, turn_errors=errors)
        out = trec.mask_failed_turns(r)
        assert out.loss_mask == jrec.mask_failed_turns(jal.AgentRollout(**kw, turn_errors=errors)
                                                       ).loss_mask
        assert r.loss_mask == kw["loss_mask"]          # the original untouched
    out = trec.mask_failed_turns(tal.AgentRollout(**kw, turn_errors=[True, False]))
    assert out.loss_mask[2:5] == [False] * 3 and out.loss_mask[7:10] == [True] * 3


# ---------------------------------------------------------------------------
# the external-agent adapter
# ---------------------------------------------------------------------------


def _agent(complete):
    a = complete("step one: ")
    b = complete("step two given " + a[:10] + ": ")
    return a + b


@pytest.mark.parametrize("max_total_len", [2048, 40])
def test_external_agent_adapter_matches_jax(tiny, max_total_len):
    """Two completions by a plain-Python agent: the same texts and rollout;
    the prompt scaffolding masked off with logprob 0; with a short
    ``max_total_len`` the engine sees only the last tokens."""
    jeng, jp, teng, tp = tiny
    ja = jrec.ExternalAgentAdapter(jeng, JTokenizer(), jp, jax.random.PRNGKey(3),
                                   max_total_len=max_total_len)
    ta = trec.ExternalAgentAdapter(teng, ByteTokenizer(), tp, torch.Generator().manual_seed(3),
                                   max_total_len=max_total_len)
    jfinal, tfinal = _agent(ja.complete), _agent(ta.complete)
    assert tfinal == jfinal
    for final in (tfinal, None):
        jr, tr = ja.finish(final), ta.finish(final)
        if final is None:
            assert tr.final_text == "" and not tr.token_ids
            continue
        assert_same([jr], [tr])
        assert tr.num_turns == 2 and len(tr.turn_spans) == 2
        assert sum(e - s for s, e in tr.turn_spans) == sum(tr.loss_mask) == 32
        assert tr.prompt_len == len("step one: ")
    # finish() with no final text decodes everything after the first prompt
    _agent(ja.complete), _agent(ta.complete)
    jr, tr = ja.finish(), ta.finish()
    assert_same([jr], [tr])
    batch = tal.build_agent_train_batch([tr], np.asarray([1.0], np.float32), pad_id=0)
    assert batch.input_ids.shape[0] == 1 and batch.loss_mask.sum() == 32
