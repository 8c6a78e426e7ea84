"""Training of the port: train state, optimizers (adamw, adafactor), the
policy, LoRA, SFT and critic train steps, and the logprob recompute
(``rlinf_tpu/training``)."""

from rlinf_tpu_torch.training.train_state import (
    TrainState,
    create_train_state,
    make_optimizer,
)
from rlinf_tpu_torch.training.learner import make_logprob_fn, make_policy_train_step
from rlinf_tpu_torch.training.lora_learner import make_lora_policy_train_step
from rlinf_tpu_torch.training.sft import make_sft_train_step

__all__ = [
    "TrainState",
    "make_optimizer",
    "create_train_state",
    "make_policy_train_step",
    "make_logprob_fn",
    "make_lora_policy_train_step",
    "make_sft_train_step",
]
