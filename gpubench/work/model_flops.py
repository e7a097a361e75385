"""The model's operations per image, counted over the plain reference on the
meta device: ``FlopCounterMode`` sums the convolutions and matrix products
(two operations a multiply-add) of one forward, or of a forward and its
backward, at the configuration's sizes. Nothing of the program is counted,
so moving work into a custom op changes no count.

A convolution's backward counts one product the size of the forward's for
each gradient it computes (input, weight): torch's own formula counts a
grouped convolution's input gradient as if the convolution were ungrouped.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import model as ref

__all__ = ["step_flops"]


def _conv_backward(grad_out, x, w, bias, stride, padding, dilation, transposed, output_padding,
                   groups, output_mask, out_shape=None, **kw) -> int:
    if transposed:
        raise NotImplementedError("the reference has no transposed convolution")
    one = 2 * grad_out[0] * math.prod(grad_out[2:]) * w[0] * math.prod(w[1:])
    return one * (int(output_mask[0]) + int(output_mask[1]))


def step_flops(cfg: Dict, batch: int, train: bool) -> int:
    """Operations of one forward (``train`` False) or one forward and
    backward (``train`` True) over ``batch`` images."""
    dev = torch.device("meta")
    P = {name: torch.empty(shape, dtype=torch.int64 if init[0] == "count" else torch.float32,
                           device=dev)
         for name, shape, init in ref.param_spec(cfg)}
    leaves = [t.requires_grad_() for t in P.values() if t.is_floating_point()] if train else []
    size = cfg["img_size"]
    images = torch.empty((batch, size, size, 3), dtype=torch.uint8, device=dev)
    labels = torch.zeros((batch,), dtype=torch.int64, device=dev)
    counter = FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: _conv_backward})
    with counter:
        if train:
            logits, area, _ = ref.forward(P, images, cfg, train=True)
            torch.autograd.grad(ref.loss_of(logits, area, labels, cfg), leaves,
                                allow_unused=True)
        else:
            with torch.no_grad():
                ref.forward(P, images, cfg, train=False)
    return int(counter.get_total_flops())
