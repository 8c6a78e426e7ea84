"""Embodied policies (reference: rlinf/models/embodiment/, BasePolicy at
base_policy.py:32), as plain functions on tensors.

Port of ``rlinf_tpu/models/embodiment``: the policy interface, the
Gaussian MLP and CNN policies, the ViT image encoder, the OFT-style VLA
(``vla_policy``), OpenVLA (``openvla``), the SAC policy, the flow families
(``flow_utils``, ``flow_policy``, pi0/pi0.5 in ``openpi``, ``gr00t``), the
value critics (``value_critic``), the VLA checkpoint import (``hf_import``)
and the model registry (``registry``, imported here for its side effects).
The world and reward models come with a later part of the embodied stack
(ROADMAP.md §A.11(e)).
"""

from rlinf_tpu_torch.models.embodiment.base_policy import Policy, PolicyOutput
from rlinf_tpu_torch.models.embodiment.mlp_policy import MLPGaussianPolicy
from rlinf_tpu_torch.models.embodiment.cnn_policy import CNNGaussianPolicy
from rlinf_tpu_torch.models.embodiment import registry as _registry  # noqa: F401

__all__ = ["Policy", "PolicyOutput", "MLPGaussianPolicy", "CNNGaussianPolicy"]
