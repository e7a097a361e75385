"""Configuration and device selection."""

from .config import (
    ScouterConfig,
    check_serving_supported,
    checkpoint_name,
    config_from_args,
    get_args_parser,
)
from .device import resolve_device

__all__ = [
    "ScouterConfig",
    "check_serving_supported",
    "checkpoint_name",
    "config_from_args",
    "get_args_parser",
    "resolve_device",
]
