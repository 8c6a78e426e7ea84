"""Embodied policies (reference: rlinf/models/embodiment/, BasePolicy at
base_policy.py:32), as plain functions on tensors.

Port of ``rlinf_tpu/models/embodiment``, the parts of the on-policy PPO
path: the policy interface, the Gaussian MLP and CNN policies, the ViT
image encoder, the OFT-style VLA (``vla_policy``) and OpenVLA
(``openvla``). The SAC policy, the flow families, the value critic, the HF
import, the world and reward models and the model registry come with later
parts of the embodied stack (ROADMAP.md §A.11).
"""

from rlinf_tpu_torch.models.embodiment.base_policy import Policy, PolicyOutput
from rlinf_tpu_torch.models.embodiment.mlp_policy import MLPGaussianPolicy
from rlinf_tpu_torch.models.embodiment.cnn_policy import CNNGaussianPolicy

__all__ = ["Policy", "PolicyOutput", "MLPGaussianPolicy", "CNNGaussianPolicy"]
