"""Gluon (aligned) Xception-65 and -71 in NCHW (counterpart of
``scouter_tpu/models/gluon_xception.py``, after
``timm/models/gluon_xception.py:83-306``).

SeparableConv2d is a depthwise conv, BatchNorm and a pointwise conv
(:83-113) with timm's fixed padding ((stride - 1) + dilation * (k - 1)) // 2;
a block's ``rep`` is its ordered act/conv/bn list with timm's actN/convN/
bnN numbering (:126-165) and a conv + BatchNorm ``skip`` where the width or
stride changes; the entry flow is blocks 1-3 (Xception-71: ``block2`` a
Sequential of three blocks, :308-360), the middle flow blocks 4-19 inside
``mid``, the exit ``block20`` and three separable convs (1536, 1536, 2048)
(:178-296). At output stride 32 every dilation is 1. Module names are
timm's (``block1.rep.conv1.conv_dw``, ``block2.1.skip.bn1``,
``mid.block4.rep.bn3``, ``conv5.conv_pw``, ``fc``).
"""

from __future__ import annotations

import torch
from torch import nn

from . import act
from .layers import (Linear, batch_norm, conv2d, global_avg_pool, head_dropout, head_dtype,
                     torch_conv_padding)
from .registry import register_model

__all__ = ["Xception65"]


class _SepConv(nn.Module):
    """depthwise (``conv_dw``) -> ``bn`` -> pointwise (``conv_pw``) (:83-113)."""

    def __init__(self, in_chs: int, planes: int, kernel_size: int = 3, stride: int = 1,
                 dilation: int = 1, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.conv_dw = conv2d(in_chs, in_chs, kernel_size, stride=stride,
                              padding=torch_conv_padding(kernel_size, stride, dilation),
                              dilation=dilation, groups=in_chs, compute_dtype=dt)
        self.bn = batch_norm(in_chs, compute_dtype=dt)
        self.conv_pw = conv2d(in_chs, planes, 1, padding=0, compute_dtype=dt)

    def forward(self, x):
        return self.conv_pw(self.bn(self.conv_dw(x)))


class _Skip(nn.Module):
    def __init__(self, in_chs: int, planes: int, stride: int, compute_dtype=None):
        super().__init__()
        self.conv1 = conv2d(in_chs, planes, 1, stride=stride, padding=0,
                            compute_dtype=compute_dtype)
        self.bn1 = batch_norm(planes, compute_dtype=compute_dtype)

    def forward(self, x):
        return self.bn1(self.conv1(x))


class _Rep(nn.Module):
    """The ordered rep list with torch's actN/convN/bnN numbering (:126-165);
    the acts have no parameters and run through ``act.relu``."""

    def __init__(self, inplanes: int, planes: int, num_reps: int, stride: int = 1,
                 dilation: int = 1, start_with_relu: bool = True, grow_first: bool = True,
                 is_last: bool = False, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.ops = []  # ("act", None) or ("conv" | "bn", module name)
        filters = inplanes
        l = 1

        def unit(relu, cin, cout, s, dil):
            nonlocal l
            if relu:
                self.ops.append(("act", None))
            self.add_module(f"conv{l}", _SepConv(cin, cout, 3, s, dil, dt))
            self.add_module(f"bn{l}", batch_norm(cout, compute_dtype=dt))
            self.ops += [("conv", f"conv{l}"), ("bn", f"bn{l}")]
            l += 1

        if grow_first:
            unit(start_with_relu, inplanes, planes, 1, dilation)
            filters = planes
        for _ in range(num_reps - 1):
            unit(grow_first or start_with_relu, filters, filters, 1, dilation)
        if not grow_first:
            unit(True, inplanes, planes, 1, dilation)
        if stride != 1:
            unit(True, planes, planes, stride, 1)
        elif is_last:
            unit(True, planes, planes, 1, dilation)

    def forward(self, x):
        for kind, name in self.ops:
            x = act.relu(x) if kind == "act" else getattr(self, name)(x)
        return x


class _Block(nn.Module):
    def __init__(self, inplanes: int, planes: int, num_reps: int, stride: int = 1,
                 dilation: int = 1, start_with_relu: bool = True, grow_first: bool = True,
                 is_last: bool = False, compute_dtype=None):
        super().__init__()
        self.skip = (_Skip(inplanes, planes, stride, compute_dtype)
                     if planes != inplanes or stride != 1 else None)
        self.rep = _Rep(inplanes, planes, num_reps, stride, dilation, start_with_relu,
                        grow_first, is_last, compute_dtype)

    def forward(self, x):
        skip = x if self.skip is None else self.skip(x)
        return act.residual_add(self.rep(x), skip)


class Xception65(nn.Module):
    """Modified aligned Xception-65; ``deep_entry`` switches the entry flow to
    Xception-71's three-block Sequential (gluon_xception.py:308-360).
    ``num_classes=0`` builds no ``fc``; ``features_only`` returns ``bn5``'s
    activated map."""

    def __init__(self, num_classes: int = 1000, in_chans: int = 3, deep_entry: bool = False,
                 drop_rate: float = 0.0, mnist_stem: bool = False, compute_dtype=None):
        super().__init__()
        del mnist_stem  # the JAX family takes and ignores it
        dt = compute_dtype
        self.drop_rate = drop_rate
        self.conv1 = conv2d(in_chans, 32, 3, stride=2, padding=1, compute_dtype=dt)
        self.bn1 = batch_norm(32, compute_dtype=dt)
        self.conv2 = conv2d(32, 64, 3, padding=1, compute_dtype=dt)
        self.bn2 = batch_norm(64, compute_dtype=dt)
        self.block1 = _Block(64, 128, 2, 2, start_with_relu=False, compute_dtype=dt)
        if deep_entry:
            self.block2 = nn.Sequential(
                _Block(128, 256, 2, 1, start_with_relu=False, compute_dtype=dt),
                _Block(256, 256, 2, 2, start_with_relu=False, compute_dtype=dt),
                _Block(256, 728, 2, 2, start_with_relu=False, compute_dtype=dt))
        else:
            self.block2 = _Block(128, 256, 2, 2, start_with_relu=False, compute_dtype=dt)
        # Xception-71's entry flow ends 728 wide (JAX declares 256 and infers 728:
        # the stride gives block3 its skip either way)
        self.block3 = _Block(728 if deep_entry else 256, 728, 2, 2, is_last=True,
                             compute_dtype=dt)
        self.mid = nn.Module()
        for i in range(4, 20):
            self.mid.add_module(f"block{i}", _Block(728, 728, 3, 1, compute_dtype=dt))
        self.block20 = _Block(728, 1024, 2, 2, grow_first=False, is_last=True,
                              compute_dtype=dt)
        self.conv3 = _SepConv(1024, 1536, 3, compute_dtype=dt)
        self.bn3 = batch_norm(1536, compute_dtype=dt)
        self.conv4 = _SepConv(1536, 1536, 3, compute_dtype=dt)
        self.bn4 = batch_norm(1536, compute_dtype=dt)
        self.conv5 = _SepConv(1536, 2048, 3, compute_dtype=dt)
        self.bn5 = batch_norm(2048, compute_dtype=dt)
        self.num_features = 2048
        self.fc = (Linear(2048, num_classes, compute_dtype=head_dtype(dt))
                   if num_classes > 0 else None)

    def forward(self, x: torch.Tensor, features_only: bool = False) -> torch.Tensor:
        x = act.relu(self.bn1(self.conv1(x)))
        x = act.relu(self.bn2(self.conv2(x)))
        x = act.relu(self.block1(x))
        x = self.block3(self.block2(x))
        for block in self.mid.children():
            x = block(x)
        x = act.relu(self.block20(x))
        x = act.relu(self.bn3(self.conv3(x)))
        x = act.relu(self.bn4(self.conv4(x)))
        x = act.relu(self.bn5(self.conv5(x)))
        return x if features_only else self.forward_head(x)

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        """The class scores of a ``features_only`` map."""
        return self.fc(head_dropout(global_avg_pool(x), self.drop_rate, self.training))


@register_model
def gluon_xception65(num_classes=1000, in_chans=3, **kw):
    return Xception65(num_classes=num_classes, in_chans=in_chans, **kw)


@register_model
def gluon_xception71(num_classes=1000, in_chans=3, **kw):
    """Modified aligned Xception-71 (gluon_xception.py:462-470)."""
    return Xception65(num_classes=num_classes, in_chans=in_chans, deep_entry=True, **kw)
