"""Learning-curve parity harness.

The port's own copy of ``rlinf_tpu/utils/parity.py`` (numpy only).

Re-design of the reference's parity/regression tests
(reference tests/parity_tests/compare_baseline.py:16-35: run experiments,
parse the ``success_once`` metric series, compare against stored baselines by
Spearman/similarity; crash classification by log regex in check.py:21-50).

Usage: runners write metrics.jsonl; ``compare_to_baseline`` loads a stored
baseline curve and scores the new run. Drift beyond thresholds fails CI.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def load_metric_series(
    metrics_jsonl: str, key: str
) -> Tuple[np.ndarray, np.ndarray]:
    """(steps, values) for one metric from a runner's metrics.jsonl."""
    steps, vals = [], []
    with open(metrics_jsonl) as f:
        for line in f:
            row = json.loads(line)
            if key in row:
                steps.append(row["step"])
                vals.append(row[key])
    return np.asarray(steps), np.asarray(vals, np.float64)


def _rankdata(x: np.ndarray) -> np.ndarray:
    order = np.argsort(x, kind="stable")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(len(x))
    # average ties
    sx = x[order]
    i = 0
    while i < len(sx):
        j = i
        while j + 1 < len(sx) and sx[j + 1] == sx[i]:
            j += 1
        ranks[order[i : j + 1]] = (i + j) / 2.0
        i = j + 1
    return ranks


def spearman(a: Sequence[float], b: Sequence[float]) -> float:
    """Spearman rank correlation (no scipy dependency)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if len(a) < 2 or len(a) != len(b):
        return float("nan")
    ra, rb = _rankdata(a), _rankdata(b)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = np.sqrt((ra**2).sum() * (rb**2).sum())
    if denom == 0:
        return 1.0 if np.allclose(a, a[0]) and np.allclose(b, b[0]) else 0.0
    return float((ra * rb).sum() / denom)


def _resample(values: np.ndarray, n: int) -> np.ndarray:
    if len(values) == n:
        return values
    x_old = np.linspace(0, 1, len(values))
    x_new = np.linspace(0, 1, n)
    return np.interp(x_new, x_old, values)


@dataclasses.dataclass
class ParityResult:
    passed: bool
    spearman: float
    final_gap: float            # baseline_final - run_final
    details: Dict


def compare_to_baseline(
    run_values: Sequence[float],
    baseline_values: Sequence[float],
    *,
    min_spearman: float = 0.7,
    max_final_gap: float = 0.1,
    smooth_window: int = 3,
) -> ParityResult:
    """Did this run learn like the baseline? (reference compare_baseline.py
    method: curve-shape similarity + endpoint check)."""
    run = np.asarray(run_values, np.float64)
    base = np.asarray(baseline_values, np.float64)
    if smooth_window > 1 and len(run) >= smooth_window:
        kernel = np.ones(smooth_window) / smooth_window
        run = np.convolve(run, kernel, mode="valid")
        base_s = np.convolve(base, np.ones(min(smooth_window, len(base))) /
                             min(smooth_window, len(base)), mode="valid")
    else:
        base_s = base
    n = min(len(run), len(base_s), 64)
    run_r = _resample(run, n)
    base_r = _resample(base_s, n)
    rho = spearman(run_r, base_r)
    final_gap = float(np.mean(base_r[-3:]) - np.mean(run_r[-3:]))
    passed = (rho >= min_spearman) and (final_gap <= max_final_gap)
    return ParityResult(
        passed=passed,
        spearman=rho,
        final_gap=final_gap,
        details={"n": n, "run_final": float(np.mean(run_r[-3:])),
                 "baseline_final": float(np.mean(base_r[-3:]))},
    )


def save_baseline(path: str, values: Sequence[float], meta: Optional[dict] = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump({"values": list(map(float, values)), "meta": meta or {}}, f)


def load_baseline(path: str) -> List[float]:
    with open(path) as f:
        return json.load(f)["values"]


# Crash classification (reference check.py:42-50 log-regex classifiers).
CRASH_PATTERNS = (
    ("oom", r"RESOURCE_EXHAUSTED|out of memory|OOM"),
    ("nan", r"loss=nan|NaN detected"),
    ("traceback", r"Traceback \(most recent call last\)"),
)


def classify_log(log_text: str) -> Optional[str]:
    import re

    for name, pattern in CRASH_PATTERNS:
        if re.search(pattern, log_text):
            return name
    return None
