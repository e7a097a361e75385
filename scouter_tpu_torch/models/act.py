"""Activation and layer indirection for the backprop-modifying attribution
methods (counterpart of ``scouter_tpu/models/act.py``).

The backbones call :func:`relu` and :func:`residual_add` where the JAX
package's call its ``act.relu`` and ``act.residual_add``, and nowhere else;
attribution code swaps a rule in for the length of a forward:

- :func:`override_relu`: deconvnet's and guided backprop's ReLUs
  (:func:`deconvnet_relu`, :func:`guided_relu`) and DeepLift's paired
  rescale ReLU;
- :func:`override_residual_add`: excitation backprop's eltwise rule;
- :func:`override_linear` and :func:`override_norm`: excitation backprop's
  rule for every conv and dense product and its straight-through
  BatchNorm. JAX reaches these by patching ``jax.lax.conv_general_dilated``,
  ``jax.lax.dot_general`` and flax's ``BatchNorm.__call__``; here the
  layers that stand for them (``layers.Conv2d``, ``Conv1d``, ``Linear``,
  ``BatchNorm2d``, the blur and space-to-depth stem convs) ask
  :func:`linear` and :func:`norm_output`.

Without an override each hook is the plain op, bit for bit. The overrides
are module state, scoped by the context managers, and not thread-safe, as
JAX's are.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

__all__ = [
    "deconvnet_relu",
    "guided_relu",
    "linear",
    "norm_output",
    "override_linear",
    "override_norm",
    "override_relu",
    "override_residual_add",
    "relu",
    "residual_add",
]

_RELU_OVERRIDE: Optional[Callable] = None
_ADD_OVERRIDE: Optional[Callable] = None
_LINEAR_OVERRIDE: Optional[Callable] = None
_NORM_OVERRIDE: Optional[Callable] = None


def relu(x: torch.Tensor) -> torch.Tensor:
    f = _RELU_OVERRIDE
    return torch.relu(x) if f is None else f(x)


def residual_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Skip-connection add, overridable for excitation backprop's eltwise rule
    (``torchray/attribution/excitation_backprop.py:459-502``)."""
    f = _ADD_OVERRIDE
    return a + b if f is None else f(a, b)


def linear(op: Callable, x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``op(x, weight, bias)``, a conv or a dense product. Under
    :func:`override_linear` the override gets ``(op without bias, x,
    weight)`` and the bias is added to its output, as flax adds it after
    ``conv_general_dilated``/``dot_general``."""
    f = _LINEAR_OVERRIDE
    if f is None:
        return op(x, weight, bias)
    y = f(lambda a, w: op(a, w, None), x, weight)
    return y if bias is None else y + bias.view(-1, *([1] * (y.dim() - 2)))


def norm_output(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """A normalisation layer's output ``y`` of input ``x``, or what
    :func:`override_norm`'s rule makes of the pair."""
    f = _NORM_OVERRIDE
    return y if f is None else f(x, y)


def _override(name: str, fn: Callable):
    @contextlib.contextmanager
    def scope():
        prev = globals()[name]
        globals()[name] = fn
        try:
            yield
        finally:
            globals()[name] = prev

    return scope()


def override_relu(fn: Callable):
    """Swap the backbone ReLU for the length of the context."""
    return _override("_RELU_OVERRIDE", fn)


def override_residual_add(fn: Callable):
    return _override("_ADD_OVERRIDE", fn)


def override_linear(fn: Callable):
    """``fn(op, x, weight)`` computes every conv and dense product of the
    backbone (``op(x, weight)`` is the plain product)."""
    return _override("_LINEAR_OVERRIDE", fn)


def override_norm(fn: Callable):
    """``fn(x, y)`` replaces every BatchNorm's output ``y`` of input ``x``."""
    return _override("_NORM_OVERRIDE", fn)


# ---- modified-backward ReLUs ------------------------------------------------

class _DeconvnetRelu(torch.autograd.Function):
    """deconvnet: the backward passes the positive part of the output
    gradient, whatever the input's sign (torchray deconvnet.py:58-86)."""

    @staticmethod
    def forward(ctx, x):
        return torch.relu(x)

    @staticmethod
    def backward(ctx, g):
        return torch.relu(g)


class _GuidedRelu(torch.autograd.Function):
    """guided backprop: the ReLU's own gate and the positive-gradient gate."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.relu(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.relu(g) * (x > 0).to(g.dtype)


def deconvnet_relu(x: torch.Tensor) -> torch.Tensor:
    return _DeconvnetRelu.apply(x)


def guided_relu(x: torch.Tensor) -> torch.Tensor:
    return _GuidedRelu.apply(x)
