"""Configuration and device selection (checkpoints: ``core.checkpoint``)."""

from .config import (
    ScouterConfig,
    check_serving_supported,
    check_training_supported,
    checkpoint_name,
    config_from_args,
    expand_sweep,
    get_args_parser,
)
from .device import resolve_device

__all__ = [
    "ScouterConfig",
    "check_serving_supported",
    "check_training_supported",
    "checkpoint_name",
    "config_from_args",
    "expand_sweep",
    "get_args_parser",
    "resolve_device",
]
