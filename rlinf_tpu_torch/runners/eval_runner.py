"""Standalone evaluation: greedy decode + rule-based scoring over a dataset.

Port of ``rlinf_tpu/runners/eval_runner.py``: accuracy and
pass@k over a prompt dataset through the static rollout engine, and the
aggregated tables, and the episodic embodied eval
(``evaluate_embodied_episodes``) over the port's ``EnvLoop``. Sampling seeds
come from one ``torch.Generator`` seeded from ``seed`` (not JAX's threefry).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from rlinf_tpu_torch.algorithms.rewards.math_verifier import batch_math_rewards
from rlinf_tpu_torch.data.datasets import PromptDataset
from rlinf_tpu_torch.data.io_struct import RolloutRequest
from rlinf_tpu_torch.models.llm.config import LLMConfig
from rlinf_tpu_torch.models.llm.sampler import SamplingParams
from rlinf_tpu_torch.rollout.engine import RolloutEngine


@dataclasses.dataclass
class EvalResult:
    accuracy: float
    num_examples: int
    mean_response_len: float
    seconds: float
    per_example: List[Dict]


def evaluate_reasoning(
    params,
    model_cfg: LLMConfig,
    tokenizer,
    dataset: PromptDataset,
    *,
    sampling: Optional[SamplingParams] = None,
    reward_fn: Callable = batch_math_rewards,
    batch_size: int = 32,
    max_prompt_len: int = 512,
    max_examples: Optional[int] = None,
    attn_impl: str = "xla",
    seed: int = 0,
    engine: Optional[RolloutEngine] = None,
    device="cuda",
) -> EvalResult:
    """Greedy (or sampled, for pass@k-style eval) accuracy over a dataset.

    Pass a pre-built ``engine`` to evaluate with its settings (``device``
    then names the engine's device)."""
    sampling = sampling or SamplingParams(max_new_tokens=512, greedy=True)
    engine = engine or RolloutEngine(model_cfg, sampling, attn_impl=attn_impl, device=device)
    n = min(len(dataset), max_examples or len(dataset))
    generator = torch.Generator().manual_seed(seed)
    t0 = time.perf_counter()
    records: List[Dict] = []
    for start in range(0, n, batch_size):
        batch = [dataset[i] for i in range(start, min(start + batch_size, n))]
        # pad the final partial batch to keep jit shapes stable
        pad_count = batch_size - len(batch)
        padded = batch + [batch[-1]] * pad_count
        request = RolloutRequest(
            prompt_ids=[
                tokenizer.encode(ex.prompt)[:max_prompt_len] for ex in padded
            ],
            answers=[ex.answer for ex in padded],
        )
        result = engine.rollout(params, request, generator)
        texts = result.response_texts(tokenizer)
        scores = reward_fn(texts, result.answers)
        for i, ex in enumerate(batch):
            records.append(
                {
                    "prompt": ex.prompt,
                    "answer": ex.answer,
                    "response": texts[i],
                    "score": float(scores[i]),
                    "response_len": int(result.response_lengths[i]),
                }
            )
    seconds = time.perf_counter() - t0
    scores = [r["score"] for r in records]
    return EvalResult(
        accuracy=float(np.mean(scores)) if scores else 0.0,
        num_examples=len(records),
        mean_response_len=float(np.mean([r["response_len"] for r in records]))
        if records else 0.0,
        seconds=seconds,
        per_example=records,
    )


def print_eval_table(results: Dict[str, EvalResult]):
    """Aggregated table, one row per task."""
    name_w = max(len(k) for k in results) if results else 4
    print(f"{'task':<{name_w}}  acc      n     len    s")
    for name, r in results.items():
        print(
            f"{name:<{name_w}}  {r.accuracy:6.4f}  {r.num_examples:5d} "
            f"{r.mean_response_len:6.1f}  {r.seconds:6.1f}"
        )


# ---------------------------------------------------------------------------
# pass@k reasoning eval
# ---------------------------------------------------------------------------


def pass_at_k(n: int, c: int, k: int) -> float:
    """Unbiased pass@k estimator from n samples with c correct
    (Codex-paper estimator: 1 - C(n-c, k) / C(n, k))."""
    if k > n:
        raise ValueError(f"k={k} > n={n} samples")
    if n - c < k:
        return 1.0
    out = 1.0
    for i in range(n - c, n - c - k, -1):
        out *= i / (i + c)
    return 1.0 - out


def evaluate_reasoning_pass_at_k(
    params,
    model_cfg: LLMConfig,
    tokenizer,
    dataset: PromptDataset,
    *,
    n_samples: int = 8,
    ks: Optional[List[int]] = None,
    temperature: float = 1.0,
    max_new_tokens: int = 512,
    reward_fn: Callable = batch_math_rewards,
    batch_size: int = 32,
    max_prompt_len: int = 512,
    max_examples: Optional[int] = None,
    attn_impl: str = "xla",
    seed: int = 0,
    device="cuda",
) -> Dict[str, float]:
    """Sampled eval: n_samples per prompt, pass@k for each k in ``ks``.

    A response counts as correct when ``reward_fn`` scores it > 0.5 (the
    rule-verifier convention: 1.0 correct / 0.0 wrong).
    """
    ks = ks or [1, n_samples]
    assert all(k <= n_samples for k in ks), (ks, n_samples)
    sampling = SamplingParams(
        max_new_tokens=max_new_tokens, temperature=temperature,
        eos_token_id=getattr(tokenizer, "eos_token_id", -1) or -1,
    )
    engine = RolloutEngine(model_cfg, sampling, attn_impl=attn_impl, device=device)
    n = min(len(dataset), max_examples or len(dataset))
    generator = torch.Generator().manual_seed(seed)
    t0 = time.perf_counter()

    correct_counts = np.zeros(n, np.int32)
    lengths: List[int] = []
    assert batch_size % n_samples == 0 or batch_size >= n_samples, (
        "batch_size should fit whole sample groups"
    )
    prompts_per_batch = max(batch_size // n_samples, 1)
    for start in range(0, n, prompts_per_batch):
        idxs = list(range(start, min(start + prompts_per_batch, n)))
        pad_count = prompts_per_batch - len(idxs)
        padded = idxs + [idxs[-1]] * pad_count
        prompt_ids = []
        answers = []
        for i in padded:
            ex = dataset[i]
            ids = tokenizer.encode(ex.prompt)[:max_prompt_len]
            prompt_ids.extend([ids] * n_samples)
            answers.extend([ex.answer] * n_samples)
        request = RolloutRequest(prompt_ids=prompt_ids, answers=answers)
        result = engine.rollout(params, request, generator)
        texts = result.response_texts(tokenizer)
        scores = reward_fn(texts, result.answers)
        for j, i in enumerate(idxs):
            group = scores[j * n_samples:(j + 1) * n_samples]
            correct_counts[i] = sum(s > 0.5 for s in group)
            lengths.extend(
                int(l) for l in
                result.response_lengths[j * n_samples:(j + 1) * n_samples]
            )

    metrics = {
        f"pass@{k}": float(np.mean([
            pass_at_k(n_samples, int(c), k) for c in correct_counts[:n]
        ]))
        for k in ks
    }
    metrics["n_samples"] = float(n_samples)
    metrics["num_examples"] = float(n)
    metrics["mean_response_len"] = float(np.mean(lengths)) if lengths else 0.0
    metrics["seconds"] = time.perf_counter() - t0
    return metrics


# ---------------------------------------------------------------------------
# Episodic embodied eval (not ported yet)
# ---------------------------------------------------------------------------


def evaluate_embodied_episodes(
    envs,
    policy,
    params,
    *,
    num_steps: int = 256,
    seed: int = 0,
    device="cuda",
) -> Dict[str, float]:
    """Deterministic-policy episodic eval over vectorized envs.

    Computes trajectory-derived episodic metrics (return/length over
    completed episodes, success_once from positive terminal reward) merged
    with whatever the env adapter itself reports via ``metrics()``; the
    env-reported keys (e.g. ManiSkill-style ``success_once``) take
    precedence, the simulator being the source of truth for success.
    ``params`` lie on ``device``.
    """
    from rlinf_tpu_torch.rollout.env_loop import EnvLoop

    loop = EnvLoop(envs, policy, device=device)
    loop.reset()
    loop.env_metrics()  # drain stale stats
    traj = loop.interact(params, torch.Generator().manual_seed(seed), num_steps,
                         deterministic=True)

    rewards = np.asarray(traj.rewards)       # [T, B]
    dones = np.asarray(traj.dones)           # [T+1, B]
    T, B = rewards.shape
    ep_returns, ep_lengths, ep_success = [], [], []
    ret = np.zeros(B)
    length = np.zeros(B, np.int32)
    success = np.zeros(B, bool)
    for t in range(T):
        ret += rewards[t]
        length += 1
        success |= rewards[t] > 0
        done_t = dones[t + 1].astype(bool)
        for b in np.nonzero(done_t)[0]:
            ep_returns.append(float(ret[b]))
            ep_lengths.append(int(length[b]))
            ep_success.append(bool(success[b]))
            ret[b] = 0.0
            length[b] = 0
            success[b] = False

    out = {
        "episodes": float(len(ep_returns)),
        "episode_return_mean": float(np.mean(ep_returns)) if ep_returns else 0.0,
        "episode_len_mean": float(np.mean(ep_lengths)) if ep_lengths else 0.0,
        "success_once": float(np.mean(ep_success)) if ep_success else 0.0,
    }
    out.update(loop.env_metrics())  # env-reported keys win
    return out


def print_metrics_table(
    metrics: Dict[str, float], *, title: str = "eval", step: int = 0
):
    """Boxed metric table."""
    keys = sorted(metrics)
    kw = max([len(k) for k in keys] + [6])
    bar = "+" + "-" * (kw + 2) + "+" + "-" * 14 + "+"
    print(f"{title} @ step {step}")
    print(bar)
    for k in keys:
        v = metrics[k]
        sval = f"{v:.4f}" if isinstance(v, float) else str(v)
        print(f"| {k:<{kw}} | {sval:>12} |")
    print(bar)
