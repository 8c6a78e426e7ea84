"""Training loops of the port: the GRPO/PPO reasoning runner, the online
coding runner, the agent runner, the eval runner and the SFT runner."""

from rlinf_tpu_torch.runners.agent_runner import AgentRunner
from rlinf_tpu_torch.runners.coding_online_runner import CodingOnlineRunner, CodingTask
from rlinf_tpu_torch.runners.reasoning_runner import ReasoningRunner
from rlinf_tpu_torch.runners.sft_runner import SFTRunner

__all__ = ["AgentRunner", "CodingOnlineRunner", "CodingTask", "ReasoningRunner", "SFTRunner"]
