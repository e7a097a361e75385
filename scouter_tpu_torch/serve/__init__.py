"""Serving: the serving function, the micro-batching engine and the HTTP server."""

from .engine import InferenceEngine
from .export import make_serving_fn

__all__ = ["InferenceEngine", "make_serving_fn"]
