"""Model registry and factory (counterpart of ``scouter_tpu/models/registry.py``),
after timm's ``register_model`` / ``create_model``."""

from __future__ import annotations

import fnmatch
from typing import Callable, Dict, List

__all__ = ["create_model", "is_model", "list_models", "model_entrypoint", "register_model"]

_REGISTRY: Dict[str, Callable] = {}


def register_model(fn: Callable) -> Callable:
    """Decorator: registers ``fn`` under its __name__."""
    name = fn.__name__
    if name in _REGISTRY:
        raise ValueError(f"duplicate model entrypoint {name!r}")
    _REGISTRY[name] = fn
    return fn


def is_model(name: str) -> bool:
    return name in _REGISTRY


def model_entrypoint(name: str) -> Callable:
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; the port has: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_models(filter: str = "") -> List[str]:
    names = sorted(_REGISTRY)
    if filter:
        names = [n for n in names if fnmatch.fnmatch(n, filter)]
    return names


def create_model(model_name: str, pretrained: bool = False, num_classes: int = 1000,
                 in_chans: int = 3, **kwargs):
    """Build a backbone module by name. There is no weight download:
    ``pretrained=True`` raises; converted weights load through
    ``models.convert.variables_to_state_dict`` and ``load_state_dict``."""
    if pretrained:
        raise ValueError(f"create_model({model_name!r}, pretrained=True): no pretrained-"
                         "weight download exists in this build")
    fn = model_entrypoint(model_name)
    return fn(num_classes=num_classes, in_chans=in_chans, **kwargs)
