"""Serving: the serving function, its export artifact, int8 quantisation, the
micro-batching engine and the HTTP server."""

from .engine import InferenceEngine
from .export import export_serving, load_artifact, make_serving_fn, save_artifact
from .quant import QUANT_POLICIES, int8_conv2d, quantized_convs

__all__ = ["InferenceEngine", "QUANT_POLICIES", "export_serving", "int8_conv2d",
           "load_artifact", "make_serving_fn", "quantized_convs", "save_artifact"]
