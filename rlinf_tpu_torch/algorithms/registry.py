"""Name -> function registries for advantage estimators, policy losses and
reward functions.

The port's copy of ``rlinf_tpu/algorithms/registry.py``: configs select
estimators, losses and rewards by the same names in both packages.
"""

from __future__ import annotations

from typing import Callable, Dict

_ADVANTAGE_REGISTRY: Dict[str, Callable] = {}
_POLICY_LOSS_REGISTRY: Dict[str, Callable] = {}
_REWARD_REGISTRY: Dict[str, Callable] = {}


def register_advantage(name: str):
    def deco(fn):
        if name in _ADVANTAGE_REGISTRY:
            raise ValueError(f"Advantage estimator {name!r} already registered")
        _ADVANTAGE_REGISTRY[name] = fn
        return fn

    return deco


def get_advantage_fn(name: str) -> Callable:
    try:
        return _ADVANTAGE_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"Unknown advantage estimator {name!r}; have {sorted(_ADVANTAGE_REGISTRY)}"
        ) from None


def register_policy_loss(name: str):
    def deco(fn):
        if name in _POLICY_LOSS_REGISTRY:
            raise ValueError(f"Policy loss {name!r} already registered")
        _POLICY_LOSS_REGISTRY[name] = fn
        return fn

    return deco


def get_policy_loss_fn(name: str) -> Callable:
    try:
        return _POLICY_LOSS_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"Unknown policy loss {name!r}; have {sorted(_POLICY_LOSS_REGISTRY)}"
        ) from None


def register_reward(name: str):
    def deco(fn):
        _REWARD_REGISTRY[name] = fn
        return fn

    return deco


def get_reward_fn(name: str) -> Callable:
    try:
        return _REWARD_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"Unknown reward fn {name!r}; have {sorted(_REWARD_REGISTRY)}"
        ) from None
