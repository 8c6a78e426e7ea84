"""Synthetic multi-step GSM8K-style problems (chain-of-thought + '#### N').

The port's own copy of ``examples/reasoning/gsm_synth.py``'s
``make_problem`` and ``build_sft_examples``: templated 3-6 step word
problems over a running quantity, whose chain-of-thought solution ends in
GSM8K's '#### N'. The same ``random.Random`` seed gives the same problems.
"""

from __future__ import annotations

import random
from typing import List, Tuple

NAMES = ["Tom", "Mia", "Sam", "Ava", "Leo", "Zoe", "Max", "Ida"]
ITEMS = ["apples", "coins", "books", "pens", "cards", "shells", "stamps"]


def make_problem(rng: random.Random, min_steps=3, max_steps=6) -> Tuple[str, str, str]:
    """-> (question, chain_of_thought_answer, final_answer_str)."""
    name = rng.choice(NAMES)
    item = rng.choice(ITEMS)
    v = rng.randint(5, 45)
    story = [f"{name} has {v} {item}."]
    cot = []
    steps = rng.randint(min_steps, max_steps)
    for _ in range(steps):
        if rng.random() < 0.25:  # distractor: someone else's count
            other = rng.choice([n for n in NAMES if n != name])
            story.append(f"{other} has {rng.randint(2, 60)} {item} too.")
        kind = rng.randrange(5)
        if kind == 0:
            k, m = rng.randint(2, 7), rng.randint(2, 9)
            story.append(f"{name} buys {k} bags of {m} {item} each.")
            nv = v + k * m
            cot.append(f"{k} * {m} = {k * m}. {v} + {k * m} = {nv}.")
        elif kind == 1 and v > 3:
            d = rng.randint(1, v - 1)
            story.append(f"{name} gives away {d} {item}.")
            nv = v - d
            cot.append(f"{v} - {d} = {nv}.")
        elif kind == 2:
            d = rng.randint(3, 28)
            story.append(f"{name} finds {d} more {item}.")
            nv = v + d
            cot.append(f"{v} + {d} = {nv}.")
        elif kind == 3 and v <= 70:
            story.append(f"A friend doubles {name}'s {item}.")
            nv = v * 2
            cot.append(f"{v} * 2 = {nv}.")
        elif v % 2 == 0 and v >= 4:
            story.append(f"{name} loses half of the {item}.")
            nv = v // 2
            cot.append(f"{v} / 2 = {nv}.")
        else:
            d = rng.randint(3, 28)
            story.append(f"{name} finds {d} more {item}.")
            nv = v + d
            cot.append(f"{v} + {d} = {nv}.")
        v = nv
    question = " ".join(story) + f" How many {item} does {name} have now?"
    answer = " ".join(cot) + f"\n#### {v}"
    return question, answer, str(v)


def build_sft_examples(n: int, seed: int = 0) -> List:
    """PromptExamples whose answer is the full chain of thought."""
    from rlinf_tpu_torch.data.datasets import PromptExample

    rng = random.Random(seed)
    out = []
    for _ in range(n):
        q, cot, _ = make_problem(rng)
        out.append(PromptExample(prompt=f"Q: {q}\nA: ", answer=cot))
    return out
