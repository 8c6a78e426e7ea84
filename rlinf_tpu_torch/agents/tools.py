"""Tool workers for agentic RL.

The port's own copy of ``rlinf_tpu/agents/tools.py``. Tools are
synchronous callables; the agent loop batches calls across active
conversations.
"""

from __future__ import annotations

import ast
import operator
from typing import Callable, Dict, List, Protocol


class Tool(Protocol):
    name: str

    def __call__(self, args: str) -> str: ...


class ToolRegistry:
    def __init__(self, tools: List[Tool] = ()):  # type: ignore[assignment]
        self._tools: Dict[str, Tool] = {}
        for t in tools:
            self.register(t)

    def register(self, tool: Tool):
        self._tools[tool.name] = tool

    def call(self, name: str, args: str, session: object = None) -> str:
        """Stateful tools (``tool.stateful = True``) get a per-conversation
        ``session`` key — the analog of the reference's tool sessions
        (reference rlinf/agents/rstar2/rstar2_agent_loop.py:98
        tool_session_get/release)."""
        tool = self._tools.get(name)
        if tool is None:
            return f"error: unknown tool '{name}'"
        try:
            if getattr(tool, "stateful", False):
                return tool(args, session=session)
            return tool(args)
        except Exception as e:  # tool errors are observations, not crashes
            return f"error: {e}"

    def __contains__(self, name: str) -> bool:
        return name in self._tools


_BIN_OPS = {
    ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
    ast.Div: operator.truediv, ast.Mod: operator.mod, ast.Pow: operator.pow,
    ast.FloorDiv: operator.floordiv,
}
_UNARY_OPS = {ast.UAdd: operator.pos, ast.USub: operator.neg}


def _safe_eval(node):
    if isinstance(node, ast.Expression):
        return _safe_eval(node.body)
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
        return node.value
    if isinstance(node, ast.BinOp) and type(node.op) in _BIN_OPS:
        return _BIN_OPS[type(node.op)](_safe_eval(node.left), _safe_eval(node.right))
    if isinstance(node, ast.UnaryOp) and type(node.op) in _UNARY_OPS:
        return _UNARY_OPS[type(node.op)](_safe_eval(node.operand))
    raise ValueError(f"unsupported expression: {ast.dump(node)}")


class CalculatorTool:
    """Arithmetic evaluator over a safe AST subset (no eval())."""

    name = "calc"

    def __call__(self, args: str) -> str:
        value = _safe_eval(ast.parse(args.strip(), mode="eval"))
        if isinstance(value, float) and value.is_integer():
            value = int(value)
        return str(value)


class EchoTool:
    """Test tool: returns its arguments (deterministic observation)."""

    name = "echo"

    def __call__(self, args: str) -> str:
        return args


class DictSearchTool:
    """Lookup 'retriever' over a fixed corpus dict — the offline stand-in for
    the reference's search server (agents/searchr1)."""

    name = "search"

    def __init__(self, corpus: Dict[str, str]):
        self.corpus = corpus

    def __call__(self, args: str) -> str:
        key = args.strip().lower()
        best = None
        for k, v in self.corpus.items():
            if k.lower() in key or key in k.lower():
                best = v
                break
        return best if best is not None else "no results found"
