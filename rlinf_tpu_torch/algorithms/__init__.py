"""RL algorithm library of the port: advantages and actor losses.

Port of ``rlinf_tpu/algorithms``. All math runs in float32; the
registries select estimators and losses by the JAX package's names.
"""

from rlinf_tpu_torch.algorithms.registry import (
    get_advantage_fn,
    get_policy_loss_fn,
    register_advantage,
    register_policy_loss,
)
from rlinf_tpu_torch.algorithms import advantages as _advantages  # noqa: F401  (registration)
from rlinf_tpu_torch.algorithms import losses as _losses  # noqa: F401  (registration)

__all__ = [
    "get_advantage_fn",
    "get_policy_loss_fn",
    "register_advantage",
    "register_policy_loss",
]
