"""Tool-call parsers: extract (tool, args) from generated text.

The port's own copy of ``rlinf_tpu/algorithms/toolcall_parsers.py``:
registry-based parsers used by the agent loop (agents/agent_loop.py) to cut
generation at tool invocations.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Callable, Dict, Optional

_PARSER_REGISTRY: Dict[str, Callable] = {}


@dataclasses.dataclass
class ToolCall:
    tool: str
    args: str
    raw: str            # the raw span in the text
    end_pos: int        # char offset just past the call (truncate point)


def register_toolcall_parser(name: str):
    def deco(fn):
        _PARSER_REGISTRY[name] = fn
        return fn

    return deco


def get_toolcall_parser(name: str) -> Callable[[str], Optional[ToolCall]]:
    try:
        return _PARSER_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"Unknown toolcall parser {name!r}; have {sorted(_PARSER_REGISTRY)}"
        ) from None


@register_toolcall_parser("tag")
def parse_tag_style(text: str) -> Optional[ToolCall]:
    """``<tool=NAME>ARGS</tool>`` (searchr1-style tag protocol)."""
    m = re.search(r"<tool=([\w-]+)>(.*?)</tool>", text, re.DOTALL)
    if not m:
        return None
    return ToolCall(
        tool=m.group(1), args=m.group(2).strip(), raw=m.group(0),
        end_pos=m.end(),
    )


@register_toolcall_parser("search_tags")
def parse_search_tags(text: str) -> Optional[ToolCall]:
    """``<search>QUERY</search>`` (Search-R1 protocol,
    reference agents/searchr1)."""
    m = re.search(r"<search>(.*?)</search>", text, re.DOTALL)
    if not m:
        return None
    return ToolCall(
        tool="search", args=m.group(1).strip(), raw=m.group(0), end_pos=m.end()
    )


@register_toolcall_parser("json")
def parse_json_style(text: str) -> Optional[ToolCall]:
    """```tool_call {"name": ..., "arguments": ...}``` fenced JSON
    (hermes/qwen chat-template protocol)."""
    m = re.search(r"<tool_call>\s*(\{.*?\})\s*</tool_call>", text, re.DOTALL)
    if not m:
        return None
    try:
        obj = json.loads(m.group(1))
    except json.JSONDecodeError:
        return None
    return ToolCall(
        tool=str(obj.get("name", "")),
        args=json.dumps(obj.get("arguments", {})),
        raw=m.group(0),
        end_pos=m.end(),
    )
