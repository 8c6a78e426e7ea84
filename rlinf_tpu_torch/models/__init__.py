"""Models of the port: the dense and MoE decoder LLM, and the model
registry of ``rlinf_tpu/models/__init__.py`` (reference:
rlinf/models/__init__.py:274,26 get_model/register_model)."""

from typing import Callable, Dict

_MODEL_REGISTRY: Dict[str, Callable] = {}


def register_model(name: str):
    def deco(fn):
        _MODEL_REGISTRY[name] = fn
        return fn

    return deco


def get_model(name: str, *args, **kwargs):
    try:
        factory = _MODEL_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"Unknown model {name!r}; have {sorted(_MODEL_REGISTRY)}"
        ) from None
    return factory(*args, **kwargs)


def list_models():
    return sorted(_MODEL_REGISTRY)
