"""Registers every policy family under its reference name.

Port of ``rlinf_tpu/models/embodiment/registry.py`` (reference analog:
``SupportedModel`` registration + ``get_model`` dispatch,
rlinf/models/__init__.py:274,26): each name maps onto one of the port's
VLA architectures (or the small policies), configured with that family's
geometry:

  * flow-matching VLM prefix + action expert (``Pi0Policy``): openpi pi0 /
    pi0.5, lingbotvla, dexbotic pi.
  * discrete action-bin AR decode (``OpenVLAPolicy``): openvla.
  * parallel-decode continuous chunks (``VLAPolicy``): openvla_oft, abot_m0.
  * DiT flow head over backbone features (``GR00TPolicy``): gr00t, starvla
    (``num_embodiments=1``), dexbotic DM0.
  * the value critics: recap_critic, steam_critic.

Every factory takes keyword overrides; defaults are test-scale.
"""

from __future__ import annotations

from rlinf_tpu_torch.models import register_model
from rlinf_tpu_torch.models.embodiment.cnn_policy import CNNGaussianPolicy
from rlinf_tpu_torch.models.embodiment.flow_policy import FlowMatchingPolicy
from rlinf_tpu_torch.models.embodiment.gr00t import GR00TConfig, GR00TPolicy
from rlinf_tpu_torch.models.embodiment.mlp_policy import MLPGaussianPolicy
from rlinf_tpu_torch.models.embodiment.openpi import Pi0Config, Pi0Policy
from rlinf_tpu_torch.models.embodiment.openvla import OpenVLAConfig, OpenVLAPolicy
from rlinf_tpu_torch.models.embodiment.sac_policy import MLPSACPolicy
from rlinf_tpu_torch.models.embodiment.vla_policy import VLAPolicy


@register_model("mlp_policy")
def _mlp(**kw):
    return MLPGaussianPolicy(**kw)


@register_model("cnn_policy")
def _cnn(**kw):
    return CNNGaussianPolicy(**kw)


@register_model("sac_policy")
def _sac(**kw):
    return MLPSACPolicy(**kw)


@register_model("flow_policy")
def _flow(**kw):
    """SAC-flow style MLP flow policy (reference flow_policy)."""
    return FlowMatchingPolicy(**kw)


@register_model("openpi_pi0")
def _pi0(cfg: Pi0Config = None, **kw):
    return Pi0Policy(cfg or Pi0Config(**kw))


@register_model("openpi_pi05")
def _pi05(cfg: Pi0Config = None, **kw):
    kw.setdefault("discrete_state", True)
    return Pi0Policy(cfg or Pi0Config(**kw))


@register_model("lingbotvla")
def _lingbot(cfg: Pi0Config = None, **kw):
    """pi0-style flow VLA (reference lingbotvla)."""
    return Pi0Policy(cfg or Pi0Config(**kw))


@register_model("dexbotic_pi")
def _dexbotic_pi(cfg: Pi0Config = None, **kw):
    """Dexbotic pi-series flow VLA (reference dexbotic)."""
    return Pi0Policy(cfg or Pi0Config(**kw))


@register_model("openvla")
def _openvla(cfg: OpenVLAConfig = None, **kw):
    return OpenVLAPolicy(cfg or OpenVLAConfig(**kw))


@register_model("openvla_oft")
def _openvla_oft(**kw):
    """OFT recipe: parallel decode, continuous chunks (reference openvla_oft)."""
    return VLAPolicy(**kw)


@register_model("abot_m0")
def _abot(**kw):
    """Chunked continuous-action VLA (reference abot_m0)."""
    return VLAPolicy(**kw)


@register_model("gr00t")
def _gr00t(cfg: GR00TConfig = None, **kw):
    return GR00TPolicy(cfg or GR00TConfig(**kw))


@register_model("starvla")
def _starvla(cfg: GR00TConfig = None, **kw):
    """Flow-matching action head, single embodiment (reference
    starvla/action_heads/flowmatching.py)."""
    kw.setdefault("num_embodiments", 1)
    return GR00TPolicy(cfg or GR00TConfig(**kw))


@register_model("dexbotic_dm0")
def _dm0(cfg: GR00TConfig = None, **kw):
    """Diffusion/flow action model head (reference dexbotic DM0)."""
    return GR00TPolicy(cfg or GR00TConfig(**kw))


@register_model("recap_critic")
def _recap(vcfg=None, **kw):
    """RECAP categorical value critic (reference
    value_model/recap/modeling_critic.py:129)."""
    from rlinf_tpu_torch.models.embodiment.value_critic import (
        ValueCriticConfig, ValueCriticPolicy,
    )

    return ValueCriticPolicy(vcfg or ValueCriticConfig(), **kw)


@register_model("steam_critic")
def _steam(cfg=None, **kw):
    """STEAM pairwise stride ensemble critic (reference
    value_model/steam/modeling_steam.py + ensemble_modeling_critic.py)."""
    from rlinf_tpu_torch.models.embodiment.value_critic import (
        SteamConfig, SteamCritic,
    )

    return SteamCritic(cfg or SteamConfig(**kw))
