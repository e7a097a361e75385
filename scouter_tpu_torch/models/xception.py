"""Xception in NCHW (counterpart of ``scouter_tpu/models/xception.py``, after
``timm/models/xception.py:51-236``).

A 3x3/2 and a 3x3 stem without padding, twelve blocks of separable convs
(a depthwise conv named ``conv1`` and a ``pointwise`` 1x1) with a
conv + BatchNorm skip projection where the width or stride changes, an
optional entry ReLU and a 3x3/2 max pool in the downsampling blocks, then
two separable convs (1536, 2048) before the classifier. A block's ``rep``
is built as timm builds it, its ReLUs included, so the indices line up
(``block1.rep.0.conv1``, ``block2.rep.1.pointwise``, ``block12.skipbn``).
"""

from __future__ import annotations

import torch
from torch import nn

from . import act
from .layers import (Apply, Linear, batch_norm, conv2d, global_avg_pool, head_dropout,
                     head_dtype, max_pool_3x3_s2_p1)
from .registry import register_model

__all__ = ["Xception"]


class _SepConv(nn.Module):
    """SeparableConv2d: depthwise (``conv1``) + pointwise (xception.py:51-62)."""

    def __init__(self, in_chs: int, out_chs: int, kernel_size: int = 3, stride: int = 1,
                 padding: int = 0, compute_dtype=None):
        super().__init__()
        self.conv1 = conv2d(in_chs, in_chs, kernel_size, stride=stride, padding=padding,
                            groups=in_chs, compute_dtype=compute_dtype)
        self.pointwise = conv2d(in_chs, out_chs, 1, padding=0, compute_dtype=compute_dtype)

    def forward(self, x):
        return self.pointwise(self.conv1(x))


class _Block(nn.Module):
    """Xception Block (xception.py:65-114)."""

    def __init__(self, in_filters: int, out_filters: int, reps: int, strides: int = 1,
                 start_with_relu: bool = True, grow_first: bool = True, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        ops = []
        filters = in_filters

        def unit(cin, cout):
            ops.extend([Apply(act.relu), _SepConv(cin, cout, 3, padding=1, compute_dtype=dt),
                        batch_norm(cout, compute_dtype=dt)])

        if grow_first:
            unit(in_filters, out_filters)
            filters = out_filters
        for _ in range(reps - 1):
            unit(filters, filters)
        if not grow_first:
            unit(in_filters, out_filters)
        if not start_with_relu:
            ops = ops[1:]
        self.rep = nn.Sequential(*ops)
        self.strides = strides
        if out_filters != in_filters or strides != 1:
            self.skip = conv2d(in_filters, out_filters, 1, stride=strides, padding=0,
                               compute_dtype=dt)
            self.skipbn = batch_norm(out_filters, compute_dtype=dt)
        else:
            self.skip = None

    def forward(self, inp):
        x = self.rep(inp)
        if self.strides != 1:
            x = max_pool_3x3_s2_p1(x)
        skip = inp if self.skip is None else self.skipbn(self.skip(inp))
        return act.residual_add(x, skip)


class Xception(nn.Module):
    """Xception (``timm/models/xception.py:117-236``). ``num_classes=0``
    builds no ``fc``; ``features_only`` returns ``bn4``'s activated map."""

    def __init__(self, num_classes: int = 1000, in_chans: int = 3, drop_rate: float = 0.0,
                 mnist_stem: bool = False, compute_dtype=None):
        super().__init__()
        del mnist_stem  # the JAX family takes and ignores it
        dt = compute_dtype
        self.drop_rate = drop_rate
        self.conv1 = conv2d(in_chans, 32, 3, stride=2, padding=0, compute_dtype=dt)
        self.bn1 = batch_norm(32, compute_dtype=dt)
        self.conv2 = conv2d(32, 64, 3, padding=0, compute_dtype=dt)
        self.bn2 = batch_norm(64, compute_dtype=dt)
        self.block1 = _Block(64, 128, 2, 2, start_with_relu=False, compute_dtype=dt)
        self.block2 = _Block(128, 256, 2, 2, compute_dtype=dt)
        self.block3 = _Block(256, 728, 2, 2, compute_dtype=dt)
        for i in range(4, 12):
            self.add_module(f"block{i}", _Block(728, 728, 3, 1, compute_dtype=dt))
        self.block12 = _Block(728, 1024, 2, 2, grow_first=False, compute_dtype=dt)
        self.conv3 = _SepConv(1024, 1536, 3, padding=1, compute_dtype=dt)
        self.bn3 = batch_norm(1536, compute_dtype=dt)
        self.conv4 = _SepConv(1536, 2048, 3, padding=1, compute_dtype=dt)
        self.bn4 = batch_norm(2048, compute_dtype=dt)
        self.num_features = 2048
        self.fc = (Linear(2048, num_classes, compute_dtype=head_dtype(dt))
                   if num_classes > 0 else None)

    def forward(self, x: torch.Tensor, features_only: bool = False) -> torch.Tensor:
        x = act.relu(self.bn1(self.conv1(x)))
        x = act.relu(self.bn2(self.conv2(x)))
        for i in range(1, 13):
            x = getattr(self, f"block{i}")(x)
        x = act.relu(self.bn3(self.conv3(x)))
        x = act.relu(self.bn4(self.conv4(x)))
        return x if features_only else self.forward_head(x)

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        """The class scores of a ``features_only`` map."""
        return self.fc(head_dropout(global_avg_pool(x), self.drop_rate, self.training))


@register_model
def xception(num_classes=1000, in_chans=3, **kw):
    return Xception(num_classes=num_classes, in_chans=in_chans, **kw)
