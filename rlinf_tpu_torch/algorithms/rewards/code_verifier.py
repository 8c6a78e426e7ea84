"""Code-execution reward: run generated Python against I/O test cases.

The port's own copy of ``rlinf_tpu/algorithms/rewards/code_verifier.py``.
Each candidate runs in a fresh interpreter (``subprocess.run`` of
``sys.executable -I -c``, which execs at once: safe from a process that
holds a CUDA context) with a wall-clock timeout, and its stdout is compared
(whitespace-normalized) against the expected output. Used for coding-RL
rewards.
"""

from __future__ import annotations

import re
import subprocess
import sys
from typing import Dict, List, Optional, Sequence


def extract_code(text: str) -> Optional[str]:
    """Last ```python fenced block, else last fenced block, else raw text if
    it looks like code."""
    blocks = re.findall(r"```(?:python)?\n(.*?)```", text, re.DOTALL)
    if blocks:
        return blocks[-1]
    if "def " in text or "print(" in text or "input()" in text:
        return text
    return None


def run_test_case(
    code: str,
    stdin: str,
    expected_stdout: str,
    *,
    timeout_s: float = 4.0,
) -> bool:
    try:
        proc = subprocess.run(
            [sys.executable, "-I", "-c", code],
            input=stdin,
            capture_output=True,
            text=True,
            timeout=timeout_s,
        )
    except (subprocess.TimeoutExpired, OSError):
        return False
    if proc.returncode != 0:
        return False
    got = "\n".join(line.rstrip() for line in proc.stdout.strip().splitlines())
    want = "\n".join(
        line.rstrip() for line in expected_stdout.strip().splitlines()
    )
    return got == want


def code_reward(
    response_text: str,
    test_cases: Sequence[Dict[str, str]],
    *,
    timeout_s: float = 4.0,
    partial_credit: bool = False,
) -> float:
    """test_cases: [{"input": ..., "output": ...}]. 1.0 iff all pass
    (or pass fraction with partial_credit)."""
    code = extract_code(response_text)
    if code is None or not test_cases:
        return 0.0
    passed = sum(
        run_test_case(code, tc.get("input", ""), tc.get("output", ""),
                      timeout_s=timeout_s)
        for tc in test_cases
    )
    if partial_credit:
        return passed / len(test_cases)
    return 1.0 if passed == len(test_cases) else 0.0


def batch_code_rewards(
    response_texts: List[str],
    test_case_lists: List[Sequence[Dict[str, str]]],
    **kw,
) -> List[float]:
    return [
        code_reward(t, tc, **kw)
        for t, tc in zip(response_texts, test_case_lists)
    ]
