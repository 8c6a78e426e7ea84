"""Vision-language reasoning model: ViT prefix + causal LM, free-form text."""

from rlinf_tpu_torch.models.vlm.reasoning import (
    VLMConfig,
    VLMReasoningModel,
    vlm_params_from_numpy,
)

__all__ = ["VLMConfig", "VLMReasoningModel", "vlm_params_from_numpy"]
