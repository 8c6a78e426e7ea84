"""Embodied policies (reference: rlinf/models/embodiment/, BasePolicy at
base_policy.py:32), as plain functions on tensors.

Port of ``rlinf_tpu/models/embodiment``, the parts the VLM runs: the policy
interface, the Gaussian MLP policy and the ViT image encoder. The CNN
policy ``CNNGaussianPolicy``, the VLA families and the model registry come
with the embodied stack (ROADMAP.md §A.11).
"""

from rlinf_tpu_torch.models.embodiment.base_policy import Policy, PolicyOutput
from rlinf_tpu_torch.models.embodiment.mlp_policy import MLPGaussianPolicy

__all__ = ["Policy", "PolicyOutput", "MLPGaussianPolicy"]
