"""rStar2 fused compute-score: the prime_math grading ladder.

The port's own copy of ``rlinf_tpu/algorithms/rewards/rstar2_score.py``
(pure Python over the port's math verifier): a faithful re-implementation
of the reference's rStar2 scorer semantics (reference
rlinf/algorithms/rewards/rstar2/fused_compute_score/compute_score.py:22 +
prime_math/__init__.py:250,358 + prime_math/grader.py:181), layered on the
math verifier's primitives:

  ladder = prime_grade_answer (strict normalization equivalence classes)
         -> prime_math_equal with pi-substitution variants {pi, 3.14}
         -> math_verify fallback (algorithms/rewards/math_verifier.py)

The prime rungs are STRICTER than the generic verifier in two reference-
specified ways: unreduced fractions are wrong (1/2 != 2/4 at the fraction
rung), and an integer ground truth requires an integer-string prediction.
``rstar2_compute_score`` also reports the reference's format-correctness
bit ("Step 2:" + "\\box" present in the trace). The symbolic rungs need
``sympy``; where it does not import they score "not equal", as in the
JAX package.
"""

from __future__ import annotations

import math
import re
from typing import Optional, Tuple

from rlinf_tpu_torch.algorithms.rewards.math_verifier import (
    _numeric_equal,
    _parse_number,
    _symbolic_equal,
    grade_answer as _math_verify_grade,
    normalize_answer,
)

__all__ = [
    "match_answer",
    "prime_grade_answer",
    "prime_math_equal",
    "rstar2_compute_score",
    "rstar2_reward",
]


# ---------------------------------------------------------------------------
# answer extraction (reference prime_math match_answer :358)
# ---------------------------------------------------------------------------

def _last_boxed(text: str) -> Optional[str]:
    idx = max(text.rfind("\\boxed"), text.rfind("\\fbox"))
    if idx < 0:
        return None
    depth, lo, hi = 0, None, None
    for i in range(idx, len(text)):
        if text[i] == "{":
            depth += 1
            if lo is None:
                lo = i
        elif text[i] == "}":
            depth -= 1
            if depth == 0:
                hi = i
                break
    if lo is None or hi is None:
        return None
    return text[lo + 1:hi].strip()


def match_answer(response: str) -> Tuple[bool, str]:
    """(is_matched, extracted): the reference's marker/boxed ladder —
    forward markers keep the tail, reverse markers keep the head, a final
    boxed expression wins, then trailing-sentence and verb trims."""
    matched = False
    for marker in ("answer:", "answer is", "answers are"):
        i = response.lower().rfind(marker)
        if i != -1:
            matched = True
            response = response[i + len(marker):].strip()
    for marker in ("is answer", "is the answer", "are answers",
                   "are the answers"):
        i = response.lower().rfind(marker)
        if i != -1:
            matched = True
            response = response[:i].strip()
    boxed = _last_boxed(response)
    if boxed:
        matched = True
        response = boxed
    if ". " in response:
        i = response.lower().rfind(". ")
        if i != -1:
            response = response[:i].strip()
    for marker in ("be ", "is ", "are ", "=", ": ", "get ",
                   "be\n", "is\n", "are\n", ":\n", "get\n"):
        i = response.lower().rfind(marker)
        if i != -1:
            response = response[i + len(marker):].strip()
    return matched, response.strip().rstrip(".").strip()


# ---------------------------------------------------------------------------
# strict grade_answer (reference prime_math :250)
# ---------------------------------------------------------------------------

_FRAC_RE = re.compile(r"^-?\d+/0*[1-9]\d*$")
_INT_RE = re.compile(r"^-?\d+(,\d{3})*$")


def _is_frac(s: str) -> bool:
    return bool(_FRAC_RE.match(s.replace(" ", "")))


def _str_is_int(s: str) -> bool:
    return bool(_INT_RE.match(s.replace(" ", "").replace("\\!", "")))


def _split_tuple(s: str):
    if len(s) > 2 and s[0] in "([{" and s[-1] in ")]}":
        inner = s[1:-1]
        if "," in inner:
            return [e.strip() for e in inner.split(",")]
    return [s]


def prime_grade_answer(given: Optional[str], ground_truth: str) -> bool:
    """Normalization-equivalence grading with the reference's strictness:
    element counts and delimiters must match for tuples, unreduced
    fractions are wrong, and integer ground truths demand integer-string
    predictions."""
    if given is None:
        return False
    gt_n = normalize_answer(str(ground_truth))
    gv_n = normalize_answer(str(given))
    if gt_n == gv_n:
        return True
    if not gv_n:
        return False

    gt_elems = _split_tuple(gt_n)
    gv_elems = _split_tuple(gv_n)
    if len(gt_elems) > 1 and (gt_n[0] != gv_n[0] or gt_n[-1] != gv_n[-1]):
        return False
    if len(gt_elems) != len(gv_elems):
        return False
    for gt_e, gv_e in zip(gt_elems, gv_elems):
        if _is_frac(gt_e) and _is_frac(gv_e):
            ok = gt_e == gv_e          # unreduced fraction => wrong
        elif _str_is_int(gt_e) != _str_is_int(gv_e):
            ok = False                 # int gt demands int prediction
        elif gt_e == gv_e:
            ok = True
        else:
            try:
                ok = _symbolic_equal(gv_e, gt_e)
            except Exception:
                ok = False
        if not ok:
            return False
    return True


# ---------------------------------------------------------------------------
# math_equal with pi substitution (reference prime_math/grader.py:181)
# ---------------------------------------------------------------------------

def _sub_pi(s: str, pi: float) -> str:
    s = s.replace("\\pi", f"({pi})").replace("π", f"({pi})")
    return re.sub(r"\bpi\b", f"({pi})", s)


def prime_math_equal(
    prediction: str,
    reference: str,
    *,
    include_percentage: bool = True,
    tolerance: float = 1e-4,
    pi: float = math.pi,
) -> bool:
    """String -> numeric(percent variants) -> interval recursion ->
    symbolic, with pi numerically substituted first."""
    pred = _sub_pi(str(prediction), pi).strip()
    ref = _sub_pi(str(reference), pi).strip()
    if len(pred) > 1000:
        pred = pred[:1000]
    if pred.lower() == ref.lower() or pred.replace(" ", "") == ref.replace(" ", ""):
        return True

    pn, rn = _parse_number(normalize_answer(pred)), _parse_number(
        normalize_answer(ref))
    if pn is not None and rn is not None:
        cands = [rn / 100.0, rn, rn * 100.0] if include_percentage else [rn]
        return any(_numeric_equal(pn, c, rel_tol=tolerance) for c in cands)

    strip = str.maketrans("", "", "{}()[]")
    if pred.translate(strip) == ref.translate(strip):
        return True

    if (pred[:1] in "([" and pred[-1:] in ")]"
            and pred[:1] == ref[:1] and pred[-1:] == ref[-1:]):
        pp, rp = pred[1:-1].split(","), ref[1:-1].split(",")
        if len(pp) == len(rp) and len(pp) > 1:
            return all(
                prime_math_equal(a, b, include_percentage=include_percentage,
                                 tolerance=tolerance, pi=pi)
                for a, b in zip(pp, rp))

    if len(pred) < 300 and len(ref) < 300:
        return _symbolic_equal(normalize_answer(pred), normalize_answer(ref))
    return False


# ---------------------------------------------------------------------------
# fused compute score (reference compute_score.py:22 fallback chain)
# ---------------------------------------------------------------------------

def rstar2_compute_score(
    model_output: str, ground_truth: str
) -> Tuple[bool, bool, str]:
    """(is_correct, format_correctness, extracted_answer)."""
    model_output = str(model_output)
    ground_truth = str(ground_truth)
    _, extracted = match_answer(model_output)
    format_ok = "Step 2:" in model_output and "\\box" in model_output

    if prime_grade_answer(extracted, ground_truth):
        return True, format_ok, extracted
    try:
        if "\\pi" in extracted or "\\pi" in ground_truth:
            correct = any(
                prime_math_equal(extracted, ground_truth, pi=p)
                for p in (math.pi, 3.14))
        else:
            correct = prime_math_equal(extracted, ground_truth)
    except Exception:
        correct = False
    return bool(correct), format_ok, extracted


def rstar2_reward(model_output: str, ground_truth: str) -> float:
    """1.0/0.0 with the reference's prime -> math_verify fallback chain."""
    try:
        if rstar2_compute_score(model_output, ground_truth)[0]:
            return 1.0
    except Exception:
        pass
    try:
        if _math_verify_grade(model_output, ground_truth):
            return 1.0
    except Exception:
        return 0.0
    return 0.0
