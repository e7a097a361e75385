"""Backprop attribution family (counterpart of ``scouter_tpu/explain/backprop.py``;
torchray's ``attribution/{gradient,deconvnet,guided_backprop,linear_approx}.py``
and its ``saliency()`` pipeline, ``torchray/attribution/common.py:429-583``).

The modified ReLU backwards (deconvnet, guided) are ``autograd.Function``s
swapped in for the length of a forward through ``models.act.override_relu``.
Saliency is the channel max of |grad| (``gradient_to_saliency``,
``common.py:351-371``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..models.act import deconvnet_relu, guided_relu, override_relu
from .cam import backbone_split

__all__ = ["gradient_saliency", "deconvnet", "guided_backprop", "linear_approx"]


def _input_grad(forward: Callable, x: torch.Tensor, class_idx: int) -> torch.Tensor:
    with torch.enable_grad():
        xi = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(forward(xi)[0, class_idx], xi)
    return g


def _to_saliency(grad: torch.Tensor) -> torch.Tensor:
    """Max over channels of |grad| (common.py:351-371). grad: (1, C, H, W)."""
    return grad[0].abs().amax(dim=0)


def gradient_saliency(model, x, class_idx: int) -> torch.Tensor:
    """Plain input-gradient saliency (torchray gradient.py)."""
    _, _, forward = backbone_split(model)
    return _to_saliency(_input_grad(forward, x, class_idx))


def deconvnet(model, x, class_idx: int) -> torch.Tensor:
    """DeConvNet: the ReLU backward passes the positive output gradient
    (deconvnet.py:58-86)."""
    _, _, forward = backbone_split(model)
    with override_relu(deconvnet_relu):
        g = _input_grad(forward, x, class_idx)
    return _to_saliency(g)


def guided_backprop(model, x, class_idx: int) -> torch.Tensor:
    """Guided backprop: the ReLU backward gates on input > 0 and grad > 0."""
    _, _, forward = backbone_split(model)
    with override_relu(guided_relu):
        g = _input_grad(forward, x, class_idx)
    return _to_saliency(g)


def linear_approx(model, x, class_idx: int, saliency_layer: Optional[str] = None) -> torch.Tensor:
    """Linear approximation: activation x gradient, summed over channels
    (torchray linear_approx.py). With ``saliency_layer`` ('layer1'..'layer4')
    the product is taken at that stage's output; by default at the input."""
    if saliency_layer is None:
        _, _, forward = backbone_split(model)
        g = _input_grad(forward, x, class_idx)
        return (x * g)[0].sum(dim=0)
    with torch.no_grad():
        feats = model(x, stop_after=saliency_layer)
    g = _input_grad(lambda f: model(f, start_from=saliency_layer), feats, class_idx)
    return (feats * g)[0].sum(dim=0)
