"""CNN Gaussian actor-critic for image observations.

Port of ``rlinf_tpu/models/embodiment/cnn_policy.py`` (reference analog:
rlinf/models/embodiment/cnn_policy/cnn_policy.py, a Nature-CNN style
encoder feeding Gaussian heads). The JAX package convolves NHWC inputs
with HWIO kernels (``lax.conv_general_dilated``, VALID padding); here the
same params and layouts are kept and each convolution runs as
``F.conv2d`` on NCHW views, the output turned back to NHWC before the
flatten, so the feature order is the JAX package's. The convolutions are
XLA's in the JAX package and no Pallas kernel: here they are the plain
PyTorch op. Inits draw from an explicit CPU ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from rlinf_tpu_torch.models.embodiment.base_policy import Policy, PolicyOutput, normal_noise
from rlinf_tpu_torch.models.embodiment.mlp_policy import (
    _mlp_apply,
    _mlp_init,
    gaussian_entropy,
    gaussian_logprob,
)
from rlinf_tpu_torch.utils.device import resolve_device


def _conv_init(generator: torch.Generator, kh, kw, cin, cout, device="cuda"):
    """Uniform fan-in HWIO kernel [kh, kw, cin, cout] and a zero bias."""
    device = resolve_device(device)
    scale = 1.0 / math.sqrt(kh * kw * cin)
    w = torch.empty((kh, kw, cin, cout)).uniform_(-scale, scale, generator=generator)
    return {"w": w.to(device), "b": torch.zeros((cout,), device=device)}


def _conv_apply(layer, x, stride):
    """VALID convolution of NHWC ``x`` with the HWIO kernel, plus bias -> NHWC."""
    out = F.conv2d(x.permute(0, 3, 1, 2), layer["w"].permute(3, 2, 0, 1), stride=stride)
    return out.permute(0, 2, 3, 1) + layer["b"]


class CNNGaussianPolicy(Policy):
    """obs[image_key]: [B, H, W, C] uint8 or float; optional proprio vector
    concatenated after the encoder."""

    # Nature-CNN geometry
    CONVS = ((8, 4, 32), (4, 2, 64), (3, 1, 64))  # (kernel, stride, cout)

    def __init__(
        self,
        image_shape: Tuple[int, int, int],  # (H, W, C)
        action_dim: int,
        proprio_dim: int = 0,
        hidden_size: int = 256,
        image_key: str = "images",
        proprio_key: str = "states",
        init_logstd: float = 0.0,
    ):
        self.image_shape = image_shape
        self.action_dim = action_dim
        self.proprio_dim = proprio_dim
        self.hidden_size = hidden_size
        self.image_key = image_key
        self.proprio_key = proprio_key
        self.init_logstd = init_logstd
        # compute encoder output size
        h, w, c = image_shape
        for i, (k, s, co) in enumerate(self.CONVS):
            h = (h - k) // s + 1
            w = (w - k) // s + 1
            c = co
            if h < 1 or w < 1:
                raise ValueError(
                    f"image_shape {image_shape} too small for conv stack: "
                    f"layer {i} (kernel {k}, stride {s}) leaves {h}x{w}; "
                    f"minimum input is 36x36"
                )
        self._enc_out = h * w * c

    def init(self, generator: torch.Generator, device="cuda"):
        device = resolve_device(device)
        convs = []
        cin = self.image_shape[2]
        for k, _, cout in self.CONVS:
            convs.append(_conv_init(generator, k, k, cin, cout, device=device))
            cin = cout
        feat_dim = self._enc_out + self.proprio_dim
        return {
            "convs": convs,
            "trunk": _mlp_init(generator, (feat_dim, self.hidden_size), scale_last=None,
                               device=device),
            "actor_mean": _mlp_init(generator, (self.hidden_size, self.action_dim),
                                    scale_last=0.01, device=device),
            "actor_logstd": torch.full((self.action_dim,), float(self.init_logstd),
                                       device=device),
            "value": _mlp_init(generator, (self.hidden_size, 1), scale_last=1.0, device=device),
        }

    def _features(self, params, obs):
        x = obs[self.image_key]
        x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
        for layer, (_, s, _) in zip(params["convs"], self.CONVS):
            x = torch.relu(_conv_apply(layer, x, s))
        x = x.reshape(x.shape[0], -1)
        if self.proprio_dim:
            x = torch.cat([x, obs[self.proprio_key].float()], dim=-1)
        return torch.relu(_mlp_apply(params["trunk"], x))

    def _dist(self, params, obs):
        feat = self._features(params, obs)
        mean = _mlp_apply(params["actor_mean"], feat)
        logstd = params["actor_logstd"].expand(mean.shape)
        return mean, logstd, feat

    def value(self, params, obs):
        feat = self._features(params, obs)
        return _mlp_apply(params["value"], feat)[..., 0]

    def default_forward(self, params, obs, actions) -> Dict[str, torch.Tensor]:
        mean, logstd, feat = self._dist(params, obs)
        return {
            "logprobs": gaussian_logprob(mean, logstd, actions.float()),
            "entropy": gaussian_entropy(logstd),
            "values": _mlp_apply(params["value"], feat)[..., 0],
        }

    def predict_action_batch(
        self, params, generator, obs, *, deterministic: bool = False
    ) -> PolicyOutput:
        """The noise is drawn from ``generator`` (a CPU generator)."""
        mean, logstd, feat = self._dist(params, obs)
        if deterministic:
            actions = mean
        else:
            actions = mean + torch.exp(logstd) * normal_noise(generator, mean.shape, mean.device)
        return PolicyOutput(
            actions=actions,
            logprobs=gaussian_logprob(mean, logstd, actions),
            values=_mlp_apply(params["value"], feat)[..., 0],
        )
