"""Vectorized host-side environments (reference: rlinf/envs/).

Port of ``rlinf_tpu/envs/__init__.py``: the same registry; importing it
registers the toy envs, as in the JAX package.

Registry mirrors reference get_env_cls (rlinf/envs/__init__.py:41). Heavy
simulator adapters (ManiSkill, LIBERO, IsaacLab, ...) plug in behind the same
``VectorEnv`` contract; the built-in pure-numpy envs serve tests and benches
the way the reference's toy workers serve its unit tests.
"""

from typing import Dict, Type

from rlinf_tpu_torch.envs.base import EnvOutput, VectorEnv

_ENV_REGISTRY: Dict[str, Type[VectorEnv]] = {}


def register_env(name: str):
    def deco(cls):
        _ENV_REGISTRY[name] = cls
        return cls

    return deco


def get_env_cls(name: str) -> Type[VectorEnv]:
    try:
        return _ENV_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"Unknown env {name!r}; have {sorted(_ENV_REGISTRY)}"
        ) from None


from rlinf_tpu_torch.envs import toy as _toy  # noqa: E402,F401  (registration)

__all__ = ["VectorEnv", "EnvOutput", "register_env", "get_env_cls"]
