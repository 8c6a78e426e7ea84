"""Online coding RL: server-mode rollout + sandboxed code-exec rewards.

Port of ``rlinf_tpu/runners/coding_online_runner.py``. The rollout side is
the in-process ``GenerationServer`` (continuous-batching engine + live
weight swap between decode chunks); the runner submits coding prompts as
futures, and rewards come from the code-execution verifier
(algorithms/rewards/code_verifier.py).

Online semantics: responses are generated under a stale param version
while the learner moves; the loss is decoupled PPO keyed on version stamps,
with the proximal anchor recomputed on the training path
(``loss.loss_type="decoupled"``, the recompute forced on).

The train step updates the params in place, so the server is always handed
a clone (``_frozen_policy_params``), taken on the default stream, which
orders it before the serving thread's reads of it. The kernels are built
before the serving thread starts.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from rlinf_tpu_torch.algorithms.rewards.code_verifier import batch_code_rewards
from rlinf_tpu_torch.config import TrainerConfig
from rlinf_tpu_torch.data.datasets import PromptDataset, PromptExample
from rlinf_tpu_torch.data.io_struct import RolloutRequest
from rlinf_tpu_torch.rollout.continuous_engine import ContinuousBatchingEngine
from rlinf_tpu_torch.rollout.server import GenerationServer
from rlinf_tpu_torch.runners.reasoning_runner import ReasoningRunner
from rlinf_tpu_torch.training.learner import make_logprob_fn
from rlinf_tpu_torch.training.train_state import tree_map


@dataclasses.dataclass(frozen=True)
class CodingTask:
    """One coding problem: prompt + I/O test cases."""

    prompt: str
    test_cases: Sequence[Dict[str, str]]  # [{"input": ..., "output": ...}]

    @property
    def answer(self):  # PromptExample-compatible
        return list(self.test_cases)


class CodingOnlineRunner(ReasoningRunner):
    """Server-mode online RL on coding tasks.

    Differences from the base runner:
      * generation goes through a continuously-serving ``GenerationServer``
        (requests as futures; weights swapped live between decode chunks);
      * each batch is version-stamped at submit time; training uses the
        decoupled-PPO loss (cfg.loss.loss_type must be "decoupled");
      * the default reward is the sandboxed code-exec verifier over the
        task's test cases.
    """

    def __init__(
        self,
        cfg: TrainerConfig,
        tokenizer,
        tasks: Sequence[CodingTask],
        *,
        reward_fn=None,
        partial_credit: bool = True,
        exec_timeout_s: float = 4.0,
        init_params_override=None,
        device="cuda",
    ):
        if cfg.loss.loss_type != "decoupled":
            raise ValueError(
                "online server rollout trains against live-swapped weights; "
                "set loss.loss_type=decoupled (online RL recomputes the "
                "proximal logprobs)"
            )
        if reward_fn is None:
            def reward_fn(texts, answers):
                return batch_code_rewards(
                    texts, answers,
                    timeout_s=exec_timeout_s,
                    partial_credit=partial_credit,
                )

        dataset = PromptDataset(
            [PromptExample(t.prompt, t.answer) for t in tasks]
        )
        super().__init__(cfg, tokenizer, dataset, reward_fn=reward_fn,
                         init_params_override=init_params_override, device=device)
        if not isinstance(self.engine, ContinuousBatchingEngine):
            raise ValueError(
                "coding online RL needs the continuous engine "
                "(cfg.rollout.engine='continuous' or 'auto')"
            )
        if self.logprob_fn is None:
            # Online RL must recompute the proximal anchor even when the
            # decode path is numerically identical to training: the server
            # swaps weights mid-stream. self.cfg (not the ctor arg): the base
            # runner resolved attn_impl='auto' there.
            self.recompute_logprobs = True
            self.logprob_fn = make_logprob_fn(
                self.cfg.model,
                chunk_size=self.cfg.loss.logprob_chunk_size,
                attn_impl=self.cfg.attn_impl,
                temperature=self.cfg.sampling.temperature,
                device=self.device,
            )
        if self.device.type == "cuda":
            from rlinf_tpu_torch.ops.cuda import build

            build()
        self.server = GenerationServer(
            self.engine, self._frozen_policy_params(),
            seed=cfg.runner.seed + 31337,
        )
        self.server.start()
        self.param_version = 0
        self._behavior_version = 0

    # ------------------------------------------------------------------
    def _frozen_policy_params(self):
        """A copy for the serving thread: the train step updates the
        state's params in place, so the server must never hold them."""
        with torch.no_grad():
            return tree_map(lambda t: t.clone(), self._policy_params())

    def _sync_weights(self):
        """Live weight swap: the server picks the new params up between
        decode chunks, no pause needed."""
        self.server.update_params(self._frozen_policy_params())
        self.param_version += 1

    def _augment_batch(self, batch_dict, result):
        B, T = batch_dict["loss_mask"].shape
        v = float(getattr(result, "version", self._behavior_version))
        batch_dict["versions"] = torch.full(
            (B, T), v, dtype=torch.float32, device=self.device)
        batch_dict["current_version"] = torch.full(
            (B,), float(self.param_version), dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------
    def _submit_batch(self):
        """Submit one rollout batch's prompts to the serving loop and return
        (request, futures, version): the 'online clients' side."""
        examples = self.iterator.next_batch()
        request = self._make_request(examples)
        futures = [
            self.server.submit(p, self.cfg.sampling.max_new_tokens)
            for p in request.prompt_ids
        ]
        return request, futures, self.param_version

    def _collect(self, request: RolloutRequest, futures, version: int):
        tokens = []
        lps = []
        for f in futures:
            res = f.result(timeout=600.0)
            tokens.append(res["tokens"])
            lps.append(res["logprobs"])
        result = self.engine._pack_results(request, tokens, lps)
        result.version = version
        return result

    def _rollout_phase(self, params):
        request, futures, version = self._submit_batch()
        result = self._collect(request, futures, version)
        self._behavior_version = version
        return result

    # ------------------------------------------------------------------
    def run(self, max_steps: Optional[int] = None) -> List[Dict[str, float]]:
        """Overlapped online loop: batch N+1's requests stream through the
        server while the learner trains on batch N."""
        n = max_steps or self.cfg.runner.max_steps
        history: List[Dict[str, float]] = []
        try:
            self._sync_weights()
            pending = self._submit_batch()
            while self.global_step < n:
                request, futures, version = pending
                with self.timers.scope("rollout"):
                    result = self._collect(request, futures, version)
                self._behavior_version = version
                if self.global_step + 1 < n:
                    pending = self._submit_batch()
                metrics = self._train_on_result(result)
                self._sync_weights()
                metrics["online/param_version"] = float(self.param_version)
                metrics["online/version_lag"] = float(
                    self.param_version - version
                )
                history.append(metrics)
        finally:
            self.server.stop()
        return history

    run_pipelined = run
