"""QA string-metric rewards: normalized exact match + token F1.

The port's own copy of ``rlinf_tpu/algorithms/rewards/qa_metrics.py``
(pure Python): the Search-R1 EM/F1 scorers and the VQA soft accuracy.
Normalization follows the SQuAD convention: lowercase, strip articles,
punctuation, and extra whitespace.
"""

from __future__ import annotations

import re
import string
from collections import Counter
from typing import List, Sequence


def normalize_qa_answer(s: str) -> str:
    s = s.lower()
    s = "".join(ch for ch in s if ch not in string.punctuation)
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    return " ".join(s.split())


def exact_match(prediction: str, ground_truth: str) -> float:
    return float(normalize_qa_answer(prediction) == normalize_qa_answer(ground_truth))


def f1_score(prediction: str, ground_truth: str) -> float:
    p_tokens = normalize_qa_answer(prediction).split()
    g_tokens = normalize_qa_answer(ground_truth).split()
    if not p_tokens or not g_tokens:
        return float(p_tokens == g_tokens)
    common = Counter(p_tokens) & Counter(g_tokens)
    overlap = sum(common.values())
    if overlap == 0:
        return 0.0
    precision = overlap / len(p_tokens)
    recall = overlap / len(g_tokens)
    return 2 * precision * recall / (precision + recall)


def extract_final_answer(text: str) -> str:
    """<answer>...</answer> span (searchr1 protocol), else last line."""
    m = re.findall(r"<answer>(.*?)</answer>", text, re.DOTALL)
    if m:
        return m[-1].strip()
    lines = [ln for ln in text.strip().splitlines() if ln.strip()]
    return lines[-1].strip() if lines else ""


def batch_em_rewards(texts: List[str], answers: Sequence[str]) -> List[float]:
    return [exact_match(extract_final_answer(t), a) for t, a in zip(texts, answers)]


def batch_f1_rewards(texts: List[str], answers: Sequence[str]) -> List[float]:
    return [f1_score(extract_final_answer(t), a) for t, a in zip(texts, answers)]


def vqa_reward(prediction: str, ground_truths: Sequence[str]) -> float:
    """VQA-style soft accuracy (reference rewards/VQA, 235 LoC): min(1,
    #matching-annotator-answers / 3), with SQuAD-style normalization."""
    pred = normalize_qa_answer(extract_final_answer(prediction))
    matches = sum(pred == normalize_qa_answer(g) for g in ground_truths)
    return min(1.0, matches / 3.0)


def batch_vqa_rewards(
    texts: List[str], ground_truth_lists: Sequence[Sequence[str]]
) -> List[float]:
    return [vqa_reward(t, g) for t, g in zip(texts, ground_truth_lists)]
