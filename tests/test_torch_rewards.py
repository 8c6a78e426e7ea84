"""The port's math verifier against the JAX package's, on the CPU.

Both are pure Python plus sympy, so every function must give the same
answer on the same input, exactly: a fixed corpus (boxed answers, GSM8K's
``#### N``, fractions, percentages, matrices, sets, equations, junk), then
numeric and LaTeX-like strings drawn by hypothesis, then the process pool
that ``batch_math_rewards(timeout=)`` sends the pairs needing sympy to.
"""

from datetime import timedelta

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from rlinf_tpu.algorithms.rewards import math_verifier as J
from rlinf_tpu_torch.algorithms.rewards import math_verifier as T

TEXTS = [
    r"The answer is \boxed{42}.",
    r"so \boxed{\frac{1}{2}} and then \boxed{\dfrac{3}{4}}",
    r"\boxed 7 apples",
    "Natalia sold 48 clips.\n#### 72",
    "#### $1,250.",
    "<answer> x = 5 </answer>",
    "Final answer: 3/4.",
    "The answer is: 12%\nmore text",
    "we get 3, then 17 and finally 2,048",
    r"\boxed{\begin{pmatrix} 1 \\ 2 \end{pmatrix}}",
    r"\boxed{(1, 2]}",
    r"\boxed{\{1, 2, 3\}}",
    "no numbers here at all",
    "",
    "��#\x07",
    r"\boxed{x^2 - 1}",
    r"\boxed{\sqrt{2}/2}",
    r"\boxed{y = 2x + 1}",
    r"\boxed{\text{(B)}}",
    r"\boxed{10^{\circ}}",
]

PAIRS = [
    ("42", "42"), ("42.0", "42"), ("0.5", r"\frac{1}{2}"), ("1/2", "0.5"),
    ("50%", "0.5"), ("50", "0.5"), ("12\\%", "12"), ("$1,250", "1250"),
    ("(1, 2]", "(1,2]"), ("[1,2]", "(1,2)"), ("(1,2,3)", "(1, 2, 4)"),
    (r"\begin{pmatrix} 1 \\ 2 \end{pmatrix}", r"\{1, 2\}"),
    (r"\begin{bmatrix} 1 & 0 \\ 0 & 1 \end{bmatrix}",
     r"\begin{bmatrix} 1 & 0 \\ 0 & 2 \end{bmatrix}"),
    ("x = 5", "5"), ("5", "x=5"), ("y = 2x + 1", "2x - y = -1"),
    ("x^2 - 1", "(x-1)(x+1)"), (r"\sqrt{2}/2", r"\frac{\sqrt{2}}{2}"),
    ("B", "B"), ("(B)", "B"), ("the answer is C", "C"), ("10^{\\circ}", "10"),
    ("pi/2", r"\frac{\pi}{2}"), ("3.14159", r"\pi"), ("junk", "7"), (None, "7"),
    ("7", None), ("", "0"), ("1e3", "1000"), ("-0.25", r"-\frac{1}{4}"),
]


@pytest.mark.parametrize("text", TEXTS)
def test_extract_answer_matches(text):
    assert T.extract_answer(text) == J.extract_answer(text)
    assert T.extract_answer(text, use_last_number=False) == J.extract_answer(
        text, use_last_number=False)


@pytest.mark.parametrize("pred, ref", PAIRS)
def test_grading_matches(pred, ref):
    for s in (pred, ref):
        if s is not None:
            assert T.normalize_answer(s) == J.normalize_answer(s)
    assert T.math_equal(pred, ref) == J.math_equal(pred, ref)
    assert T.math_equal(pred, ref, use_symbolic=False) == J.math_equal(
        pred, ref, use_symbolic=False)
    assert T.math_equal(pred, ref, include_percentage=False, is_close=False) == J.math_equal(
        pred, ref, include_percentage=False, is_close=False)
    assert T.grade_answer(pred, ref) == J.grade_answer(pred, ref)


def test_batch_math_rewards_matches_on_the_corpus():
    refs = ["42", "0.75", "7", "72", "1250", "5", "0.75", "0.12", "2048",
            r"\{1, 2\}", "(1,2]", r"\{1,2,3\}", "0", "0", "0", "(x-1)(x+1)",
            r"\frac{\sqrt{2}}{2}", "2x - y = -1", "B", "10"]
    got = T.batch_math_rewards(TEXTS, refs, correct=2.0, incorrect=-1.0)
    assert got == J.batch_math_rewards(TEXTS, refs, correct=2.0, incorrect=-1.0)
    assert 2.0 in got and -1.0 in got


NUMBER = st.one_of(
    st.integers(-10**6, 10**6).map(str),
    st.floats(-1e4, 1e4, allow_nan=False, allow_infinity=False).map(lambda x: f"{x:.4g}"),
    st.tuples(st.integers(-99, 99), st.integers(1, 99)).map(lambda t: f"{t[0]}/{t[1]}"),
    st.tuples(st.integers(-99, 99), st.integers(1, 99)).map(lambda t: rf"\frac{{{t[0]}}}{{{t[1]}}}"),
    st.integers(0, 100).map(lambda n: f"{n}%"),
)
LATEXISH = st.lists(
    st.sampled_from([r"\frac{1}{2}", r"\sqrt{3}", "x", "+", "-", "*", "^2", "(", ")",
                     "2", "7", r"\pi", "=", ",", r"\$", r"\boxed{", "}", "####", " "]),
    max_size=6).map("".join)


@settings(max_examples=60, deadline=timedelta(seconds=10), derandomize=True)
@given(pred=st.one_of(NUMBER, LATEXISH), ref=st.one_of(NUMBER, LATEXISH))
def test_grading_matches_on_drawn_strings(pred, ref):
    """Numeric and LaTeX-like strings: each may reach the sympy rung, so a
    draw may take a second or two on a loaded CPU (the deadline is 10 s)."""
    assert T.extract_answer(pred) == J.extract_answer(pred)
    assert T.normalize_answer(pred) == J.normalize_answer(pred)
    assert T.math_equal(pred, ref) == J.math_equal(pred, ref)
    assert T.batch_math_rewards([pred], [ref]) == J.batch_math_rewards([pred], [ref])


def test_pooled_grading_with_a_timeout():
    """``timeout=`` grades the pairs that the fast rungs leave open in the
    spawn pool: the same rewards as the JAX package's inline grading; a
    timeout that no worker can meet scores those pairs 0 and recycles the
    pool."""
    texts = [r"\boxed{x^2 - 1}", r"\boxed{42}", "#### 7", r"\boxed{\sqrt{2}/2}"]
    refs = ["(x-1)(x+1)", "42", "8", r"\frac{\sqrt{2}}{2}"]
    want = J.batch_math_rewards(texts, refs)
    assert want == [1.0, 1.0, 0.0, 1.0]
    try:
        assert T.batch_math_rewards(texts, refs, timeout=120.0) == want
        # only the first pair needs sympy (the fourth normalizes to one string)
        assert T.batch_math_rewards(texts, refs, timeout=0.0) == [0.0, 1.0, 0.0, 1.0]
        assert T._POOL is None
    finally:
        T._reset_pool()
