"""Per-recipe agent packages: Search-R1, rStar2, WideSeek-R1, and the
external-agent (AgentLightning-style) adapter.

Port of ``rlinf_tpu/agents/recipes.py``. Reference analog:
rlinf/agents/{searchr1,rstar2,wideseek_r1,agentlightning}. Each recipe
composes the round-batched AgentLoop (agents/agent_loop.py) with its tools
and its fused reward, so one rollout engine serves every recipe — no
per-recipe server processes.

Randomness: where the JAX recipes split a random key, the port takes one
seeded ``torch.Generator`` and passes it on (the WideSeek-R1 team's three
roles in order; every ``complete`` of the external-agent adapter).
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from rlinf_tpu_torch.agents.agent_loop import AgentLoop, AgentLoopConfig, AgentRollout
from rlinf_tpu_torch.agents.tools import DictSearchTool, ToolRegistry
from rlinf_tpu_torch.algorithms.rewards.qa_metrics import (
    exact_match,
    extract_final_answer,
    f1_score,
)


# ---------------------------------------------------------------------------
# Search-R1: search-augmented QA RL
# ---------------------------------------------------------------------------

SEARCHR1_SYSTEM = (
    "Answer the question. You may call <tool=search>QUERY</tool> to "
    "retrieve facts; finish with <answer>ANSWER</answer>.\n"
)


@dataclasses.dataclass
class SearchR1Recipe:
    """Multi-turn search agent + EM/F1 terminal reward.

    Reference analog: rlinf/agents/searchr1 (searchr1_agent_loop.py,
    search_tool_worker.py:66 retrieval server, EM/F1 scorers). The retrieval
    server becomes any callable ``retriever(query) -> passage``; tests and
    offline runs use the DictSearchTool corpus stand-in.
    """

    max_turns: int = 3
    max_total_len: int = 1024
    reward_metric: str = "em"  # em | f1
    format_bonus: float = 0.0  # bonus for emitting a well-formed <answer>

    def make_loop(self, engine, tokenizer, corpus: Dict[str, str],
                  retriever: Optional[Callable[[str], str]] = None,
                  search_url: Optional[str] = None) -> AgentLoop:
        """``search_url``: endpoint of a running RetrievalServer
        (agents/retrieval.py BM25 service) — the reference's retrieval-
        server deployment; falls back to the in-process corpus tool."""
        if search_url is not None:
            from rlinf_tpu_torch.agents.retrieval import HTTPSearchTool

            tool = HTTPSearchTool(search_url)
        elif retriever is not None:
            tool = type("RetrieverTool", (), {
                "name": "search",
                "__call__": staticmethod(lambda args: retriever(args)),
            })()
        else:
            tool = DictSearchTool(corpus)
        return AgentLoop(
            engine, tokenizer, ToolRegistry([tool]),
            AgentLoopConfig(
                max_turns=self.max_turns, parser="tag",
                max_total_len=self.max_total_len,
            ),
        )

    def reward(self, rollout: AgentRollout, answer: str) -> float:
        pred = extract_final_answer(rollout.final_text)
        score = (
            exact_match(pred, answer)
            if self.reward_metric == "em"
            else f1_score(pred, answer)
        )
        if self.format_bonus and "<answer>" in rollout.final_text:
            score += self.format_bonus
        return float(score)

    def batch_rewards(self, rollouts: Sequence[AgentRollout],
                      answers: Sequence[str]) -> List[float]:
        return [self.reward(r, a) for r, a in zip(rollouts, answers)]


# ---------------------------------------------------------------------------
# rStar2: code-interpreter-augmented math RL
# ---------------------------------------------------------------------------

class PythonSessionTool:
    """Stateful per-conversation Python execution sessions.

    Reference analog: rlinf/agents/rstar2/http_code_judge_tool.py +
    tool sessions (rstar2_agent_loop.py:98-133) — a remote judge keeps one
    interpreter session per conversation. Here a session is the accumulated
    code history, re-executed in an isolated ``python -I`` subprocess each
    call: state persists across turns (variables carry over) while every
    execution stays hermetic and time-bounded. Only NEW stdout is returned.
    """

    name = "python"
    stateful = True

    def __init__(self, timeout_s: float = 4.0, max_output_chars: int = 512):
        self.timeout_s = timeout_s
        self.max_output_chars = max_output_chars
        self._sessions: Dict[object, List[str]] = {}
        self._prev_stdout: Dict[object, str] = {}

    def reset(self):
        self._sessions.clear()
        self._prev_stdout.clear()

    def __call__(self, args: str, session: object = None) -> str:
        history = self._sessions.setdefault(session, [])
        source = "\n".join(history + [args])
        try:
            proc = subprocess.run(
                [sys.executable, "-I", "-c", source],
                capture_output=True, text=True, timeout=self.timeout_s,
            )
        except subprocess.TimeoutExpired:
            return "error: execution timed out"
        if proc.returncode != 0:
            # failed snippet is NOT added to the session (reference judge
            # keeps the session at the last good state)
            err = proc.stderr.strip().splitlines()
            return f"error: {err[-1] if err else 'execution failed'}"
        prev = self._prev_stdout.get(session, "")
        new_out = proc.stdout[len(prev):] if proc.stdout.startswith(prev) else proc.stdout
        history.append(args)
        self._prev_stdout[session] = proc.stdout
        return new_out.strip()[-self.max_output_chars:] or "(no output)"


@dataclasses.dataclass
class RStar2Recipe:
    """Math RL with a Python tool and a fused scorer.

    Reference analog: rlinf/agents/rstar2 (rStar2-Agent recipe: code-judge
    tool sessions + fused scorer including the prime_math grader and
    tool-format penalties, SURVEY.md §2.4 rewards row).
    """

    max_turns: int = 4
    max_total_len: int = 2048
    tool_error_penalty: float = 0.1   # per failed tool call
    timeout_s: float = 4.0

    def make_loop(self, engine, tokenizer) -> AgentLoop:
        self.tool = PythonSessionTool(timeout_s=self.timeout_s)
        return AgentLoop(
            engine, tokenizer, ToolRegistry([self.tool]),
            AgentLoopConfig(
                max_turns=self.max_turns, parser="tag",
                max_total_len=self.max_total_len,
            ),
        )

    def reward(self, rollout: AgentRollout, answer: str) -> float:
        """Fused scorer: the full prime_math grading ladder
        (algorithms/rewards/rstar2_score.py — reference
        fused_compute_score/compute_score.py:22), penalized by tool errors
        surfaced in the transcript."""
        from rlinf_tpu_torch.algorithms.rewards.rstar2_score import rstar2_reward

        base = rstar2_reward(rollout.final_text, answer)
        n_errors = rollout.final_text.count("<result>error:")
        return float(base - self.tool_error_penalty * n_errors)

    def batch_rewards(self, rollouts, answers) -> List[float]:
        return [self.reward(r, a) for r, a in zip(rollouts, answers)]


# ---------------------------------------------------------------------------
# WideSeek-R1: multi-role deep-search team
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WideSeekR1Recipe:
    """Planner -> N searchers -> summarizer team over one shared engine.

    Reference analog: rlinf/agents/wideseek_r1 (wideseek_r1.py:58
    WideSeekR1AgentLoopWorker on MultiAgentLoopWorker: per-role max-turn
    budgets (:254), tool-augmented searcher roles, failed-turn masking
    (:309), and a final judged answer). The reference's Serper/Jina web
    clients become the injected retriever; roles run as separate AgentLoop
    passes so each role's tokens carry its own loss mask and turn spans —
    ready for per-turn grpo_dynamic advantages.
    """

    num_searchers: int = 2
    planner_turns: int = 1
    searcher_turns: int = 2
    summarizer_turns: int = 1
    max_total_len: int = 1024
    reward_metric: str = "f1"

    def _loop(self, engine, tokenizer, tools, turns) -> AgentLoop:
        return AgentLoop(
            engine, tokenizer, tools,
            AgentLoopConfig(max_turns=turns, parser="tag",
                            max_total_len=self.max_total_len),
        )

    def run_team(
        self,
        engine,
        tokenizer,
        params,
        questions: Sequence[str],
        corpus: Dict[str, str],
        generator: torch.Generator,
    ) -> Dict[str, List[AgentRollout]]:
        """One team episode per question. Returns per-role rollouts; every
        role's rollouts are trainable (loss masks set per role). The roles
        draw from ``generator`` in turn: planner, searchers, summarizer."""
        tools = ToolRegistry([DictSearchTool(corpus)])
        no_tools = ToolRegistry([])
        enc = tokenizer.encode

        planner = self._loop(engine, tokenizer, no_tools, self.planner_turns)
        plans = planner.run(
            params,
            [enc(f"Plan {self.num_searchers} search queries for: {q}\n")
             for q in questions],
            generator,
        )

        searcher = self._loop(engine, tokenizer, tools, self.searcher_turns)
        search_prompts, owner = [], []
        for qi, (q, plan) in enumerate(zip(questions, plans)):
            for s in range(self.num_searchers):
                search_prompts.append(enc(
                    f"Question: {q}\nPlan: {plan.final_text[:200]}\n"
                    f"You are searcher {s}. Use <tool=search>query</tool> "
                    "and report findings.\n"
                ))
                owner.append(qi)
        searches = searcher.run(params, search_prompts, generator)

        summarizer = self._loop(engine, tokenizer, no_tools, self.summarizer_turns)
        sum_prompts = []
        for qi, q in enumerate(questions):
            findings = " | ".join(
                s.final_text[:150] for s, o in zip(searches, owner) if o == qi
            )
            sum_prompts.append(enc(
                f"Question: {q}\nFindings: {findings}\n"
                "Give the final <answer>ANSWER</answer>.\n"
            ))
        summaries = summarizer.run(params, sum_prompts, generator)

        return {"planner": plans, "searcher": searches,
                "summarizer": summaries, "_owner": owner}

    def team_rewards(self, team: Dict[str, List[AgentRollout]],
                     answers: Sequence[str]) -> Dict[str, List[float]]:
        """Terminal answer score broadcast to every role of the team
        (cooperative credit assignment; per-turn shaping then comes from
        grpo_dynamic over turn spans)."""
        metric = exact_match if self.reward_metric == "em" else f1_score
        final_scores = [
            float(metric(extract_final_answer(s.final_text), a))
            for s, a in zip(team["summarizer"], answers)
        ]
        owner = team["_owner"]
        return {
            "planner": list(final_scores),
            "searcher": [final_scores[o] for o in owner],
            "summarizer": list(final_scores),
        }

    def build_team_batch(
        self,
        team: Dict[str, List[AgentRollout]],
        answers: Sequence[str],
        *,
        group_size: int = 1,
        pad_id: int = 0,
        normalize_advantages: bool = True,
    ):
        """ALL roles of every team episode as ONE training batch.

        Reference analog: MultiAgentLoopWorker collecting per-role
        single_turn_outputs into one RolloutResult for the actor
        (reference rlinf/workers/agent/agent_loop.py:432 + the
        ma_megatron_actor_worker training path): each row is one role
        member's full sequence with its own per-turn loss mask, the TEAM's
        terminal score is group-normalized over the ``group_size`` team
        episodes of each question (GRPO), and FAILED turns (tool errors /
        context overflows — reference wideseek_r1.py:309
        _mark_role_failed_turns) are masked out of the loss.

        Returns (TrainBatch, role_names [B], metrics).
        """
        from rlinf_tpu_torch.agents.agent_loop import build_agent_train_batch
        from rlinf_tpu_torch.algorithms import get_advantage_fn

        n_teams = len(team["summarizer"])
        assert n_teams % group_size == 0, (n_teams, group_size)
        scores = np.asarray(
            list(self.team_rewards(team, answers)["summarizer"]), np.float32)

        adv_fn = get_advantage_fn("grpo")
        adv, _ = adv_fn(
            rewards=torch.as_tensor(scores),
            loss_mask=torch.ones((1, n_teams), dtype=torch.float32),
            group_size=group_size,
            normalize_advantages=normalize_advantages,
        )
        team_adv = adv[0].numpy()              # [n_teams]

        owner = team["_owner"]
        rollouts, roles, seq_adv = [], [], []
        n_masked_turns = 0
        for role in ("planner", "searcher", "summarizer"):
            for j, r in enumerate(team[role]):
                t = owner[j] if role == "searcher" else j
                r = mask_failed_turns(r)
                n_masked_turns += r.num_turns - sum(
                    1 for s, e in r.turn_spans
                    if any(r.loss_mask[s:e]))
                rollouts.append(r)
                roles.append(role)
                seq_adv.append(team_adv[t])
        batch = build_agent_train_batch(
            rollouts, np.asarray(seq_adv, np.float32), pad_id=pad_id)
        metrics = {
            "agent/team_score_mean": float(scores.mean()),
            "agent/rows": float(len(rollouts)),
            "agent/failed_turns_masked": float(n_masked_turns),
        }
        return batch, roles, metrics


def mask_failed_turns(rollout: AgentRollout) -> AgentRollout:
    """Zero the loss mask over MODEL turns whose tool feedback errored —
    the reference's failed-turn masking (wideseek_r1.py:309): a turn whose
    tool call failed still appears in the context (later turns condition on
    it) but contributes no gradient."""
    mask = list(rollout.loss_mask)
    errors = rollout.turn_errors or [False] * len(rollout.turn_spans)
    for (s, e), failed in zip(rollout.turn_spans, errors):
        if failed:
            for i in range(s, e):
                mask[i] = False
    return dataclasses.replace(rollout, loss_mask=mask)


# ---------------------------------------------------------------------------
# External-agent adapter (AgentLightning analog)
# ---------------------------------------------------------------------------

class ExternalAgentAdapter:
    """Train on trajectories produced by a user's OWN agent framework.

    Reference analog: rlinf/agents/agentlightning (entrypoint.py +
    algorithm.py adapt AgentLightning agents: the external framework calls
    an LLM endpoint, RLinf records the resulting spans and trains on them).
    Here the adapter hands the external agent a ``complete(prompt) -> text``
    callable backed by the rollout engine (on the engine's device); every
    completion's tokens are recorded with loss masks and turn spans, and
    ``finish()`` assembles a standard AgentRollout — so any Python agent
    loop becomes trainable. Every ``complete`` draws from ``generator``.
    """

    def __init__(self, engine, tokenizer, params, generator: torch.Generator,
                 max_total_len: int = 2048):
        self.engine = engine
        self.tokenizer = tokenizer
        self.params = params
        self.generator = generator
        self.max_total_len = max_total_len
        self._rollout = AgentRollout(token_ids=[], loss_mask=[], logprobs=[])

    def complete(self, prompt: str) -> str:
        """LLM endpoint handed to the external agent."""
        from rlinf_tpu_torch.data.io_struct import RolloutRequest

        prompt_ids = self.tokenizer.encode(prompt)
        r = self._rollout
        if not r.token_ids:
            r.prompt_len = len(prompt_ids)
        # external tokens (prompt scaffolding) are env tokens: mask off
        r.token_ids.extend(prompt_ids)
        r.loss_mask.extend([False] * len(prompt_ids))
        r.logprobs.extend([0.0] * len(prompt_ids))

        result = self.engine.rollout(
            self.params, RolloutRequest(prompt_ids=[r.token_ids[-self.max_total_len:]]),
            self.generator,
        )
        rlen = int(result.response_lengths[0])
        ids = result.response_ids[0, :rlen].tolist()
        lps = result.response_logprobs[0, :rlen].tolist()
        start = len(r.token_ids)
        r.token_ids.extend(ids)
        r.loss_mask.extend([True] * len(ids))
        r.logprobs.extend(lps)
        r.turn_spans.append((start, len(r.token_ids)))
        r.num_turns += 1
        return self.tokenizer.decode(ids)

    def finish(self, final_text: Optional[str] = None) -> AgentRollout:
        r = self._rollout
        r.final_text = final_text if final_text is not None else (
            self.tokenizer.decode(r.token_ids[r.prompt_len:])
        )
        self._rollout = AgentRollout(token_ids=[], loss_mask=[], logprobs=[])
        return r
