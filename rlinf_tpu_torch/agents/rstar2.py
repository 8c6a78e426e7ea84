"""rStar2 agent package: persistent python sessions + tool schemas + scorer.

The port's own copy of ``rlinf_tpu/agents/rstar2.py`` (pure Python).
Reference analogs:
  * rlinf/agents/rstar2/http_code_judge_tool.py:127 ``PersistentExecutor``
    — Jupyter-style execution: state persists across calls, and when the
    last statement is a bare expression its ``repr`` is echoed;
  * :242 ``PythonTool`` with its stdin-feeding tool schema (used as the
    chat-template ``tools=`` payload, rstar2.py dataset);
  * rlinf/algorithms/rewards/rstar2/fused_compute_score — the grading
    ladder lives in algorithms/rewards/rstar2_score.py.

The reference runs code in a remote judge sandbox over HTTP; here execution
is in-process under a hard timeout + output cap (the same discipline the
coding-online runner uses), with per-session persistent globals.

``SessionPythonTool`` forks its child, as the JAX package does, also from
a process that holds a CUDA context: the child runs only the session's
Python and touches no CUDA state.
"""

from __future__ import annotations

import ast
import contextlib
import io
import multiprocessing as mp
from typing import Dict, Optional, Tuple


def get_tool_schemas() -> list:
    """The rStar2 python tool schema handed to chat templates (reference
    http_code_judge_tool.py:285)."""
    return [{
        "type": "function",
        "function": {
            "name": "python_code_with_standard_io",
            "description": (
                "Execute Python code with standard input and capture "
                "standard output. State persists across calls within a "
                "session; if the last statement is an expression its value "
                "is echoed."
            ),
            "parameters": {
                "type": "object",
                "properties": {
                    "code": {
                        "type": "string",
                        "description": "Python code to execute.",
                    },
                    "input": {
                        "type": "string",
                        "description": "Standard input fed to input().",
                    },
                },
                "required": ["code", "input"],
            },
        },
    }]


def split_code(code: str) -> Tuple[str, Optional[str]]:
    """(main body, trailing bare expression or None) — reference
    PersistentExecutor.split_code AST logic."""
    tree = ast.parse(code)  # SyntaxError propagates to the caller
    if not tree.body:
        return code, None
    last = tree.body[-1]
    if isinstance(last, ast.Expr):
        lines = code.splitlines()
        start = last.lineno
        end = getattr(last, "end_lineno", last.lineno)
        return ("\n".join(lines[:start - 1]),
                "\n".join(lines[start - 1:end]))
    return code, None


class PersistentExecutor:
    """Stateful exec environment with Jupyter last-expression echo."""

    def __init__(self):
        self.exec_globals: Dict = {"__name__": "__main__"}
        self.history: list = []

    def execute(self, code: str, stdin: str = "") -> Tuple[str, bool]:
        """-> (combined output, ok). State persists on success; the
        reference replays history into a fresh interpreter after a crash —
        here the globals simply survive (in-process) and failed calls
        leave them untouched unless the failing code already mutated them."""
        out = io.StringIO()
        feed = io.StringIO(stdin)
        try:
            main, last = split_code(code)
        except SyntaxError as e:
            return f"SyntaxError: {e.msg} (line {e.lineno})", False
        self.exec_globals["input"] = lambda prompt="": feed.readline().rstrip("\n")
        try:
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(out):
                if main:
                    exec(compile(main, "<session>", "exec"), self.exec_globals)
                if last:
                    try:
                        val = eval(compile(last, "<session>", "eval"),
                                   self.exec_globals)
                        if val is not None:
                            print(repr(val))
                    except SyntaxError:
                        exec(compile(last, "<session>", "exec"),
                             self.exec_globals)
            self.history.append(code)
            return out.getvalue(), True
        except Exception as e:
            return (out.getvalue()
                    + f"{type(e).__name__}: {e}"), False


def _run_in_child(conn, codes, stdin):
    ex = PersistentExecutor()
    outputs = []
    ok = True
    for c in codes:
        o, k = ex.execute(c, stdin)
        outputs.append(o)
        ok = ok and k
    conn.send((outputs[-1] if outputs else "", ok))
    conn.close()


class SessionPythonTool:
    """The agent-loop tool: one ``PersistentExecutor`` per session id,
    replayed into a fresh subprocess per call so a hard timeout cannot
    wedge the loop (reference replay_history_code semantics)."""

    name = "python"

    def __init__(self, timeout_s: float = 4.0, max_output_chars: int = 512):
        self.timeout_s = timeout_s
        self.max_output_chars = max_output_chars
        self._sessions: Dict[object, list] = {}

    def reset(self):
        self._sessions.clear()

    def __call__(self, args: str, session: object = None) -> str:
        history = self._sessions.setdefault(session, [])
        codes = history + [args]
        ctx = mp.get_context("fork")
        parent, child = ctx.Pipe()
        proc = ctx.Process(target=_run_in_child, args=(child, codes, ""))
        proc.start()
        proc.join(self.timeout_s)
        if proc.is_alive():
            proc.terminate()
            proc.join()
            return "error: timeout"
        if not parent.poll():
            return "error: crashed"
        output, ok = parent.recv()
        if ok:
            history.append(args)
        out = output.strip()
        if len(out) > self.max_output_chars:
            out = out[: self.max_output_chars] + "...[truncated]"
        return out if ok else f"error: {out}"
