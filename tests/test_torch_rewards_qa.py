"""The port's QA metrics (EM, F1, VQA soft accuracy), rStar2 scorer and
reward registry against the JAX package's, on the CPU.

Every scorer is pure Python on both sides, so the results must be equal
(exact float equality): on the JAX package's own test cases and on
``hypothesis``-made strings (boxed answers, fractions, tuples, numbers in
words and whitespace).
"""

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from rlinf_tpu.algorithms import registry as jreg
from rlinf_tpu.algorithms.rewards import qa_metrics as jqa
from rlinf_tpu.algorithms.rewards import rstar2_score as jrs
from rlinf_tpu_torch.algorithms import registry as treg
from rlinf_tpu_torch.algorithms import rewards as trewards
from rlinf_tpu_torch.algorithms.rewards import qa_metrics as tqa
from rlinf_tpu_torch.algorithms.rewards import rstar2_score as trs

# ---------------------------------------------------------------------------
# QA metrics
# ---------------------------------------------------------------------------

QA_PAIRS = [
    ("The Eiffel Tower!", "eiffel tower"),
    ("paris france", "paris"),
    ("blah <answer>42</answer> done", "42"),
    ("reasoning...\n<answer>Paris</answer>", "paris"),
    ("<answer> a </answer><answer>An apple</answer>", "apple"),
    ("", ""),
    ("the the the", ""),
    ("line one\n\nlast line here\n  ", "last line"),
    ("No answer", "no-answer"),
    ("Barack Obama, Jr.", "barack obama jr"),
    ("1,000", "1000"),
    ("<answer>multi\nline</answer>", "multi line"),
]


@pytest.mark.parametrize("pred,gold", QA_PAIRS)
def test_qa_metrics_match_jax(pred, gold):
    for name in ("normalize_qa_answer", "extract_final_answer"):
        assert getattr(tqa, name)(pred) == getattr(jqa, name)(pred), name
    for name in ("exact_match", "f1_score"):
        assert getattr(tqa, name)(pred, gold) == getattr(jqa, name)(pred, gold), name
    golds = [gold, gold.upper(), "other"]
    assert tqa.vqa_reward(pred, golds) == jqa.vqa_reward(pred, golds)


def test_qa_batches_match_jax():
    texts = [p for p, _ in QA_PAIRS]
    golds = [g for _, g in QA_PAIRS]
    for name in ("batch_em_rewards", "batch_f1_rewards"):
        assert getattr(tqa, name)(texts, golds) == getattr(jqa, name)(texts, golds), name
    lists = [[g, "x", g] for g in golds]
    assert tqa.batch_vqa_rewards(texts, lists) == jqa.batch_vqa_rewards(texts, lists)
    # the JAX package's own case (tests/test_misc_components.py)
    assert tqa.exact_match("The Eiffel Tower!", "eiffel tower") == 1.0
    assert tqa.f1_score("paris france", "paris") > 0.6


WORDS = st.sampled_from(["the", "a", "an", "Paris", "France", "tower", "42", "x", "Obama",
                         "apple", "!", ",", "<answer>", "</answer>", "\n", "  "])


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(WORDS, max_size=12), st.lists(WORDS, max_size=6))
def test_qa_metrics_match_jax_on_made_strings(pw, gw):
    pred, gold = " ".join(pw), " ".join(gw)
    assert tqa.extract_final_answer(pred) == jqa.extract_final_answer(pred)
    assert tqa.exact_match(pred, gold) == jqa.exact_match(pred, gold)
    assert tqa.f1_score(pred, gold) == jqa.f1_score(pred, gold)
    assert tqa.vqa_reward(pred, [gold] * 2) == jqa.vqa_reward(pred, [gold] * 2)


# ---------------------------------------------------------------------------
# rStar2 scorer
# ---------------------------------------------------------------------------

# the JAX package's cases (tests/test_rstar2_score.py) and a few more
RESPONSES = [
    "Step 1 ... The answer is 42.",
    "thus \\boxed{\\frac{1}{2}} is the result",
    "answer: 7 ... finally \\boxed{9}",
    "12 is the answer",
    "no marker here at all",
    "Step 1: ... Step 2: compute ... \\boxed{5}",
    "the answer is 5",
    "The answer is $2\\pi$",
    "\\boxed{\\frac{2}{4}}",
    "\\boxed{7}",
    "so x = 3. Therefore we get 4",
    "\\fbox{(1, 2)}",
    "answers are 1, 2 and 3",
]
GOLDS = ["42", "1/2", "9", "12", "5", "6.28", "0.5", "(1,2)", "x+1", "(1, 2, 3)"]
GRADE_PAIRS = [
    ("1/2", "1/2"), ("(1, 2)", "(1,2)"), ("(1, 2)", "(1, 2, 3)"), ("1, 2", "(1, 2)"),
    ("x+1", "1+x"), ("2/4", "1/2"), ("2+2", "4"), ("4", "4"), ("1+x", "x+1"), (None, "1"),
    ("", "3"), ("1,000", "1000"), ("\\frac{1}{2}", "0.5"),
]
EQUAL_PAIRS = [
    ("0.5", "50%"), ("50", "0.5"), ("2\\pi", "6.2832"), ("(1, 2]", "(1.0, 2.0]"),
    ("(1, 2]", "(1, 3]"), ("x^2", "x**2"), ("\\sqrt{4}", "2"), ("[1,2]", "[1, 2]"),
    ("pi", "3.14159"), ("abc", "ABC"),
]


@pytest.mark.parametrize("response", RESPONSES)
def test_match_answer_and_scores_match_jax(response):
    assert trs.match_answer(response) == jrs.match_answer(response)
    for gold in GOLDS:
        assert trs.rstar2_compute_score(response, gold) == jrs.rstar2_compute_score(
            response, gold), gold
        assert trs.rstar2_reward(response, gold) == jrs.rstar2_reward(response, gold), gold


@pytest.mark.parametrize("given_,gold", GRADE_PAIRS)
def test_prime_grade_answer_matches_jax(given_, gold):
    assert trs.prime_grade_answer(given_, gold) == jrs.prime_grade_answer(given_, gold)


@pytest.mark.parametrize("pred,ref", EQUAL_PAIRS)
def test_prime_math_equal_matches_jax(pred, ref):
    for kw in ({}, {"include_percentage": False}, {"pi": 3.14}, {"tolerance": 1e-2}):
        assert trs.prime_math_equal(pred, ref, **kw) == jrs.prime_math_equal(pred, ref, **kw), kw


def test_rstar2_expected_values():
    """The JAX package's own expectations hold for the port."""
    assert trs.match_answer("Step 1 ... The answer is 42.") == (True, "42")
    assert not trs.prime_grade_answer("2/4", "1/2")
    assert trs.prime_math_equal("0.5", "50%")
    assert trs.rstar2_compute_score("The answer is $2\\pi$", "6.28")[0]
    assert trs.rstar2_reward("\\boxed{\\frac{2}{4}}", "0.5") == 1.0
    assert trs.rstar2_reward("\\boxed{7}", "5") == 0.0


NUM = st.integers(-99, 999).map(str)
FRAC = st.tuples(st.integers(-9, 30), st.integers(1, 12)).map(lambda t: f"{t[0]}/{t[1]}")
LATEX_FRAC = st.tuples(st.integers(0, 30), st.integers(1, 12)).map(
    lambda t: f"\\frac{{{t[0]}}}{{{t[1]}}}")
DEC = st.tuples(st.integers(0, 99), st.integers(0, 99)).map(lambda t: f"{t[0]}.{t[1]}")
ATOM = st.one_of(NUM, FRAC, LATEX_FRAC, DEC, st.sampled_from(["x", "x+1", "2\\pi", "50%"]))
TUPLE = st.lists(ATOM, min_size=2, max_size=3).map(lambda xs: "(" + ", ".join(xs) + ")")
ANSWER = st.one_of(ATOM, TUPLE)
SPACE = st.sampled_from(["", " ", "  ", "\n", "\t"])


def _response(parts):
    lead, ans, form, sp = parts
    if form == 0:
        return f"{lead}{sp}\\boxed{{{ans}}}{sp}"
    if form == 1:
        return f"{lead} The answer is{sp}{ans}."
    if form == 2:
        return f"Step 1: {lead}\nStep 2: {sp}so \\boxed{{{ans}}}"
    return f"{lead}{sp}{ans}"


@settings(max_examples=120, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.tuples(st.sampled_from(["", "We compute.", "x = 2, so"]), ANSWER,
                 st.integers(0, 3), SPACE), ANSWER)
def test_rstar2_matches_jax_on_made_answers(parts, gold):
    response = _response(parts)
    assert trs.match_answer(response) == jrs.match_answer(response)
    assert trs.rstar2_compute_score(response, gold) == jrs.rstar2_compute_score(response, gold)
    assert trs.rstar2_reward(response, gold) == jrs.rstar2_reward(response, gold)
    assert trs.prime_grade_answer(parts[1], gold) == jrs.prime_grade_answer(parts[1], gold)


# ---------------------------------------------------------------------------
# the reward registry
# ---------------------------------------------------------------------------


def test_reward_registry_matches_jax():
    name = "port_test_em_reward"
    for mod, fn in ((treg, tqa.batch_em_rewards), (jreg, jqa.batch_em_rewards)):
        assert mod.register_reward(name)(fn) is fn
        assert mod.get_reward_fn(name) is fn
    # registering a name again replaces it, as in the JAX package
    treg.register_reward(name)(tqa.batch_f1_rewards)
    assert treg.get_reward_fn(name) is tqa.batch_f1_rewards
    with pytest.raises(KeyError) as got:
        treg.get_reward_fn("nope_reward")
    with pytest.raises(KeyError) as want:
        jreg.get_reward_fn("nope_reward")
    assert str(got.value).split(";")[0] == str(want.value).split(";")[0]
    assert str(got.value).startswith("\"Unknown reward fn 'nope_reward'; have [")


def test_rewards_package_exports():
    import rlinf_tpu.algorithms.rewards as jrewards

    assert set(jrewards.__all__) <= set(trewards.__all__)
    for name in trewards.__all__:
        assert callable(getattr(trewards, name)), name
