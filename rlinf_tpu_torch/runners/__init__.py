"""Training loops of the port: the GRPO/PPO reasoning runner, the online
coding runner, the agent runner, the eval runner, the SFT runner and the
VLM's GRPO runner (its SFT runner is ``runners.vlm_sft_runner``)."""

from rlinf_tpu_torch.runners.agent_runner import AgentRunner
from rlinf_tpu_torch.runners.coding_online_runner import CodingOnlineRunner, CodingTask
from rlinf_tpu_torch.runners.reasoning_runner import ReasoningRunner
from rlinf_tpu_torch.runners.sft_runner import SFTRunner
from rlinf_tpu_torch.runners.vlm_reasoning_runner import VLMReasoningRunner

__all__ = ["AgentRunner", "CodingOnlineRunner", "CodingTask", "ReasoningRunner", "SFTRunner",
           "VLMReasoningRunner"]
