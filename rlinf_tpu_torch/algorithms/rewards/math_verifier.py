"""Math answer extraction + grading (rule-based reasoning reward).

The port's own copy of ``rlinf_tpu/algorithms/rewards/math_verifier.py``,
pure Python plus ``sympy``, with the same grading ladder (each rung
cheap-to-expensive):
  1. normalized string equality
  2. multiple-choice letter cleanup (A-E)
  3. numeric equality with rel-tol 1e-4, incl. fraction and percent forms
     (pred matches ref, ref/100, or ref*100 — include_percentage)
  4. bracket-insensitive string equality
  5. tuples/intervals and (p|b)matrix matrices: elementwise recursion
  6. equations: lhs-rhs difference equivalence (both sign conventions);
     "x = 5" matches "5" when the lhs is a short symbol
  7. sympy: parse both (LaTeX-normalized), try structural equality,
     ``simplify(a-b) == 0``, and numeric ``N()`` comparison

``batch_math_rewards`` scores a batch for the reasoning runner; with a
``timeout`` the pairs that may need sympy go to a recycling process pool
(``math_verify_call``).
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Union


# ---------------------------------------------------------------------------
# Extraction
# ---------------------------------------------------------------------------

def _extract_boxed(text: str) -> Optional[str]:
    r"""Return content of the LAST \boxed{...} (brace-balanced)."""
    idx = text.rfind("\\boxed")
    if idx == -1:
        return None
    i = idx + len("\\boxed")
    # \boxed5 style (no braces)
    while i < len(text) and text[i] == " ":
        i += 1
    if i >= len(text):
        return None
    if text[i] != "{":
        m = re.match(r"[^$\s}]+", text[i:])
        return m.group(0) if m else None
    depth = 0
    start = i + 1
    for j in range(i, len(text)):
        if text[j] == "{":
            depth += 1
        elif text[j] == "}":
            depth -= 1
            if depth == 0:
                return text[start:j]
    return None


_NUMBER_RE = re.compile(r"-?\d[\d,]*(?:\.\d+)?")
_ANSWER_PHRASES = [
    r"(?:final answer|answer)\s*(?:is|:)\s*",
]


def extract_answer(text: str, use_last_number: bool = True) -> Optional[str]:
    r"""Extract the model's final answer: \boxed > '#### x' (GSM8K) >
    <answer> tag > 'answer is' > last number."""
    if text is None:
        return None
    boxed = _extract_boxed(text)
    if boxed is not None:
        return boxed.strip()
    m = list(re.finditer(r"####\s*([^\n]+)", text))
    if m:
        return m[-1].group(1).strip().rstrip(".").strip("$ ").strip()
    m = list(re.finditer(r"<answer>(.*?)</answer>", text, re.DOTALL))
    if m:
        return m[-1].group(1).strip()
    for phrase in _ANSWER_PHRASES:
        matches = list(re.finditer(phrase, text, re.IGNORECASE))
        if matches:
            tail = text[matches[-1].end():].strip()
            tail = tail.split("\n")[0].strip().rstrip(".")
            if tail:
                return tail.strip("$ ").strip()
    if use_last_number:
        nums = _NUMBER_RE.findall(text.replace(",", ""))
        if nums:
            return nums[-1]
    return None


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

_UNIT_WORDS = (
    "degrees?|cm|m|km|mm|inches|feet|ft|pounds|lbs|kg|g|hours?|minutes?|"
    "seconds?|dollars?|cents?|units?|square|cubic|percent"
)


def normalize_answer(s: str) -> str:
    """LaTeX/format normalization to a canonical plain form."""
    if s is None:
        return ""
    s = s.strip()
    s = s.replace("\\!", "").replace("\\,", "").replace("\\ ", " ")
    s = s.replace("\\left", "").replace("\\right", "")
    s = s.replace("\\{", "{").replace("\\}", "}")
    s = s.replace("^{\\circ}", "").replace("^\\circ", "")
    s = s.replace("\\$", "").replace("$", "")
    s = s.replace("\\%", "%")
    s = re.sub(r"\\text\{([^}]*)\}", r"\1", s)
    s = re.sub(r"\\mbox\{([^}]*)\}", r"\1", s)
    s = re.sub(rf"\b({_UNIT_WORDS})\b\.?", "", s, flags=re.IGNORECASE)
    s = s.replace("\\dfrac", "\\frac").replace("\\tfrac", "\\frac")
    # \frac{a}{b} -> (a)/(b) and \sqrt{x} -> sqrt(x), innermost-first in one
    # fixpoint loop so nested mixes (\frac{\sqrt{2}}{2}) fully reduce
    frac = re.compile(r"\\frac\{([^{}]+)\}\{([^{}]+)\}")
    sqrtn = re.compile(r"\\sqrt\[([^\]]+)\]\{([^{}]+)\}")
    sqrt = re.compile(r"\\sqrt\{([^{}]+)\}")
    prev = None
    while prev != s:
        prev = s
        s = sqrtn.sub(r"((\2)**(1/(\1)))", s)
        s = sqrt.sub(r"sqrt(\1)", s)
        s = frac.sub(r"((\1)/(\2))", s)
    s = re.sub(r"\\frac(\d)(\d)", r"(\1/\2)", s)
    s = re.sub(r"\\sqrt(\d)", r"sqrt(\1)", s)
    s = s.replace("\\cdot", "*").replace("\\times", "*").replace("\\div", "/")
    s = s.replace("\\pi", "pi")
    s = s.replace("\\infty", "oo").replace("\\infinity", "oo")
    s = s.replace("\\pm", "+-")
    s = re.sub(r"\\(?:mathrm|mathbf|mathit|operatorname)\{([^}]*)\}", r"\1", s)
    s = s.replace(" ", "")
    s = s.replace(",", "") if "(" not in s and "[" not in s else s
    s = s.rstrip(".")
    # percent sign: keep only a trailing one as /100 marker for _parse_number
    if s.startswith("."):
        s = "0" + s
    # trailing .0
    s = re.sub(r"^(-?\d+)\.0+$", r"\1", s)
    return s.lower()


def _parse_number(s: str) -> Optional[float]:
    """Float value of a plain number, fraction, or percent form."""
    s = s.strip()
    pct = s.endswith("%")
    if pct:
        s = s[:-1].rstrip("\\")
    val = None
    try:
        val = float(s.replace(",", ""))
    except ValueError:
        m = re.fullmatch(
            r"\(*\s*(-?\d+(?:\.\d+)?)\s*\)*/\(*\s*(-?\d+(?:\.\d+)?)\s*\)*", s
        )
        if m:
            denom = float(m.group(2))
            if denom != 0:
                val = float(m.group(1)) / denom
    if val is None:
        return None
    return val / 100.0 if pct else val


def _numeric_equal(a: float, b: float, rel_tol: float = 1e-4) -> bool:
    return abs(a - b) <= rel_tol * max(1.0, abs(a), abs(b))


# ---------------------------------------------------------------------------
# Symbolic equality (sympy ladder)
# ---------------------------------------------------------------------------

def _parse_sympy(s: str):
    from sympy.parsing.sympy_parser import (
        implicit_multiplication_application,
        parse_expr,
        standard_transformations,
    )

    transformations = standard_transformations + (
        implicit_multiplication_application,
    )
    prepped = s.replace("^", "**")
    return parse_expr(prepped, transformations=transformations, evaluate=True)


def _symbolic_equal(a: str, b: str) -> bool:
    """sympy ladder (reference verify.py:88 symbolic_equal): structural
    equality, simplify(a-b)==0, numeric N() comparison. Callers bound
    runtime via the process pool; inline calls skip huge inputs."""
    try:
        from sympy import N, simplify
    except Exception:  # pragma: no cover
        return False
    try:
        ea = _parse_sympy(a)
        eb = _parse_sympy(b)
    except Exception:
        return False
    try:
        if ea == eb or str(ea) == str(eb):
            return True
    except Exception:
        pass
    try:
        if ea.equals(eb) or simplify(ea - eb) == 0:
            return True
    except Exception:
        pass
    try:
        if _numeric_equal(float(N(ea)), float(N(eb))):
            return True
    except Exception:
        pass
    return False


_MATRIX_RE = re.compile(
    r"\\begin\{([pb])matrix\}(.*?)\\end\{\1matrix\}", re.DOTALL
)


def _matrix_rows(s: str) -> Optional[List[List[str]]]:
    m = _MATRIX_RE.fullmatch(s.strip())
    if not m:
        return None
    rows = [r.strip() for r in m.group(2).split("\\\\") if r.strip()]
    return [[c.strip() for c in r.split("&")] for r in rows]


def _braced_set_to_matrix(s: str) -> Optional[str]:
    """{1, 2, 3} -> pmatrix string (reference str_to_pmatrix analog), so a
    model answering in matrix form matches a set-style ground truth."""
    m = re.fullmatch(r"\{(.+)\}", s.strip())
    if not m or "," not in m.group(1):
        return None
    return (
        "\\begin{pmatrix}" + m.group(1).replace(",", "\\\\")
        + "\\end{pmatrix}"
    )


def math_equal(
    prediction: Union[str, float, int, None],
    reference: Union[str, float, int, None],
    include_percentage: bool = True,
    is_close: bool = True,
    *,
    use_symbolic: bool = True,
) -> bool:
    """Full grading ladder (reference math_equal, verify.py:149 semantics).

    ``use_symbolic=False`` runs only the deterministic fast rungs — the
    pooled batch API uses it to decide which pairs need the slow path.
    """
    if prediction is None or reference is None:
        return False
    pred_raw = str(prediction).strip()
    ref_raw = str(reference).strip()
    if pred_raw.lower() == ref_raw.lower():
        return True

    # multiple choice
    if ref_raw.upper() in ("A", "B", "C", "D", "E") and len(ref_raw) == 1:
        letters = re.findall(r"\b([A-E])\b", pred_raw.upper())
        cand = letters[-1] if letters else pred_raw.strip(" .:/").upper()
        if cand == ref_raw.upper():
            return True

    pred = normalize_answer(pred_raw)
    ref = normalize_answer(ref_raw)
    if not pred and prediction not in (0, False):
        return False
    if pred == ref:
        return True

    # numeric (incl. fractions and percent forms)
    pn, rn = _parse_number(pred), _parse_number(ref)
    if pn is not None and rn is not None:
        candidates = [rn]
        if include_percentage:
            candidates = [rn / 100.0, rn, rn * 100.0]
        for item in candidates:
            if _numeric_equal(pn, item) if is_close else pn == item:
                return True
        return False

    # bracket-insensitive equality
    strip = str.maketrans("", "", "{}()[]")
    if pred.translate(strip) == ref.translate(strip):
        return True

    # tuples / intervals: elementwise
    if (
        re.fullmatch(r"[(\[].+[)\]]", pred)
        and re.fullmatch(r"[(\[].+[)\]]", ref)
    ):
        p_parts = pred[1:-1].split(",")
        r_parts = ref[1:-1].split(",")
        if len(p_parts) == len(r_parts) and len(p_parts) > 1:
            return all(
                math_equal(p, r, include_percentage, is_close,
                           use_symbolic=use_symbolic)
                for p, r in zip(p_parts, r_parts)
            )

    # matrices ({a, b} ground truth vs pmatrix prediction, or both matrices)
    p_m, r_m = _matrix_rows(pred_raw), _matrix_rows(ref_raw)
    if p_m is not None and r_m is None:
        conv = _braced_set_to_matrix(ref_raw)
        if conv is not None:
            r_m = _matrix_rows(conv)
    if p_m is not None and r_m is not None:
        if len(p_m) == len(r_m) and all(
            len(a) == len(b) for a, b in zip(p_m, r_m)
        ):
            return all(
                math_equal(a, b, include_percentage, is_close,
                           use_symbolic=use_symbolic)
                for ra, rb in zip(p_m, r_m)
                for a, b in zip(ra, rb)
            )
        return False

    # equations
    if pred.count("=") == 1 and ref.count("=") == 1:
        pl, pr = (x.strip() for x in pred.split("="))
        rl, rr = (x.strip() for x in ref.split("="))
        if use_symbolic:
            diff_p = f"({pl})-({pr})"
            diff_r = f"({rl})-({rr})"
            if _symbolic_equal(diff_p, diff_r) or _symbolic_equal(
                f"-({diff_p})", diff_r
            ):
                return True
    elif pred.count("=") == 1 and len(pred.split("=")[0].strip()) <= 2:
        if math_equal(pred.split("=")[1], ref, include_percentage, is_close,
                      use_symbolic=use_symbolic):
            return True
    elif ref.count("=") == 1 and len(ref.split("=")[0].strip()) <= 2:
        if math_equal(pred, ref.split("=")[1], include_percentage, is_close,
                      use_symbolic=use_symbolic):
            return True

    if use_symbolic and len(pred) < 300 and len(ref) < 300:
        return _symbolic_equal(pred, ref)
    return False


def grade_answer(prediction: Optional[str], reference: str) -> bool:
    """Is ``prediction`` equivalent to ``reference``? (inline, no pool)"""
    return math_equal(prediction, reference)


# ---------------------------------------------------------------------------
# Pooled batch verification with timeouts (reference math_verify_call)
# ---------------------------------------------------------------------------

_POOL = None
_POOL_WORKERS = 4


def _get_pool():
    global _POOL
    if _POOL is None:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        # spawn: a forked child would inherit the parent's threads and
        # its CUDA context, which a child must not use
        ctx = multiprocessing.get_context("spawn")
        _POOL = ProcessPoolExecutor(max_workers=_POOL_WORKERS, mp_context=ctx)
    return _POOL


def _reset_pool():
    """Kill + recreate the pool after a timeout (reference
    reset_global_process_pool, verify.py:377): a worker stuck in sympy
    would otherwise poison every later batch."""
    global _POOL
    if _POOL is not None:
        for p in getattr(_POOL, "_processes", {}).values():
            try:
                p.kill()
            except Exception:
                pass
        _POOL.shutdown(wait=False, cancel_futures=True)
        _POOL = None


def _pool_grade(pair):
    pred, ref = pair
    return math_equal(pred, ref)


def math_verify_call(
    responses: Sequence[str],
    references: Sequence[Union[str, Sequence[str]]],
    timeout: float = 10.0,
) -> List[bool]:
    """Grade extracted answers against (possibly multiple) references.

    Fast deterministic rungs run inline; only pairs that *might* need sympy
    go to the spawn-pool with a per-batch timeout. A timeout recycles the
    pool and scores the stuck items False (reference verify.py:389-429)."""
    from concurrent.futures import TimeoutError as FuturesTimeout

    assert len(responses) == len(references)
    results: List[bool] = [False] * len(responses)
    pool_jobs = []  # (index, (pred, ref))
    for i, (resp, refs) in enumerate(zip(responses, references)):
        pred = extract_answer(resp) if resp else None
        if pred is None:
            continue
        ref_list = (
            list(refs) if isinstance(refs, (list, tuple)) else [refs]
        )
        decided = False
        for ref in ref_list:
            if math_equal(pred, ref, use_symbolic=False):
                results[i] = True
                decided = True
                break
        if not decided:
            for ref in ref_list:
                pool_jobs.append((i, (pred, ref)))

    if pool_jobs:
        pool = _get_pool()
        futures = [
            (i, pool.submit(_pool_grade, pair)) for i, pair in pool_jobs
        ]
        import time as _time

        deadline = _time.monotonic() + timeout
        timed_out = False
        for i, fut in futures:
            remaining = max(deadline - _time.monotonic(), 0.0)
            try:
                if fut.result(timeout=remaining):
                    results[i] = True
            except FuturesTimeout:
                timed_out = True
                fut.cancel()
            except Exception:
                pass
        if timed_out:
            _reset_pool()
    return results


# ---------------------------------------------------------------------------
# Reward entry points
# ---------------------------------------------------------------------------

def math_reward(
    response_text: str,
    ground_truth: str,
    *,
    correct: float = 1.0,
    incorrect: float = 0.0,
) -> float:
    """Score one response (reference reward_worker.py:81 semantics:
    binary rule reward on extracted answers)."""
    pred = extract_answer(response_text)
    return correct if grade_answer(pred, ground_truth) else incorrect


def batch_math_rewards(
    response_texts: List[str], ground_truths: List[str],
    *,
    correct: float = 1.0,
    incorrect: float = 0.0,
    timeout: Optional[float] = None,
) -> List[float]:
    """Batch scoring. With ``timeout`` set, undecided pairs are graded in
    the process pool (production path: a pathological sympy input can't
    stall the training loop)."""
    if timeout is not None:
        oks = math_verify_call(response_texts, ground_truths, timeout=timeout)
        return [correct if ok else incorrect for ok in oks]
    return [
        math_reward(t, g, correct=correct, incorrect=incorrect)
        for t, g in zip(response_texts, ground_truths)
    ]
