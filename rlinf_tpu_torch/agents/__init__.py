"""Agentic RL: tools and the multi-turn rollout loop."""

from rlinf_tpu_torch.agents.tools import Tool, ToolRegistry, CalculatorTool, EchoTool
from rlinf_tpu_torch.agents.agent_loop import AgentLoop, AgentLoopConfig, AgentRollout

__all__ = [
    "Tool",
    "ToolRegistry",
    "CalculatorTool",
    "EchoTool",
    "AgentLoop",
    "AgentLoopConfig",
    "AgentRollout",
]
