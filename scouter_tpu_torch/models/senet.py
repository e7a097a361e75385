"""The legacy SENet / SE-ResNet / SE-ResNeXt family in NCHW (counterpart of
``scouter_tpu/models/senet.py``, after ``timm/models/senet.py``).

SEModule: global average -> fc1 (bias) -> ReLU -> fc2 (bias) -> sigmoid
scale (senet.py:67-86), on the block's output before the residual add; the
Caffe-style SE-ResNet bottleneck strides its conv1 (:141-163); ``layer0``
is a 7x7/2 conv (three 3x3 convs for senet154) and a ceil-mode 3x3/2 max
pool (:278-300). Module names are timm's (``layer0.conv1``,
``layer1.0.se_module.fc1``, ``last_linear``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from . import act
from .layers import (Conv2d, Linear, batch_norm, conv2d, global_avg_pool, head_dropout,
                     head_dtype)
from .registry import register_model

__all__ = ["SENet", "max_pool_3x3_s2_ceil"]


def max_pool_3x3_s2_ceil(x: torch.Tensor) -> torch.Tensor:
    """torch MaxPool2d(3, 2, ceil_mode=True): the last window may hang over
    the bottom and right edges, where nothing counts."""
    return F.max_pool2d(x, 3, 2, 0, ceil_mode=True)


class _SEModule(nn.Module):
    """fc1/fc2 are flax ``nn.Conv`` in JAX: plain ``Conv2d`` (LeCun init)."""

    def __init__(self, channels: int, reduction: int, compute_dtype=None):
        super().__init__()
        self.fc1 = Conv2d(channels, channels // reduction, 1, bias=True,
                          compute_dtype=compute_dtype)
        self.fc2 = Conv2d(channels // reduction, channels, 1, bias=True,
                          compute_dtype=compute_dtype)

    def forward(self, x):
        s = self.fc2(act.relu(self.fc1(x.mean(dim=(2, 3), keepdim=True))))
        return x * torch.sigmoid(s)


class _SEBlock(nn.Module):
    """The legacy block kinds: 'basic', 'bottleneck' (Caffe: the stride on
    conv1), 'next' (SE-ResNeXt) and 'senet154'."""

    def __init__(self, kind: str, inplanes: int, planes: int, groups: int, reduction: int,
                 stride: int = 1, base_width: int = 4, has_downsample: bool = False,
                 down_kernel: int = 1, down_padding: int = 0, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.kind = kind
        if kind == "basic":
            out_chs = planes
            c1, c2, s1, s2 = planes, planes, stride, 1
        elif kind == "bottleneck":
            out_chs = planes * 4
            c1, c2, s1, s2 = planes, planes, stride, 1
        elif kind == "next":
            out_chs = planes * 4
            width = math.floor(planes * (base_width / 64)) * groups
            c1, c2, s1, s2 = width, width, 1, stride
        else:  # senet154
            out_chs = planes * 4
            c1, c2, s1, s2 = planes * 2, planes * 4, 1, stride
        if kind == "basic":
            self.conv1 = conv2d(inplanes, c1, 3, stride=s1, padding=1, compute_dtype=dt)
            self.bn1 = batch_norm(c1, compute_dtype=dt)
            self.conv2 = conv2d(c1, c2, 3, padding=1, groups=groups, compute_dtype=dt)
            self.bn2 = batch_norm(c2, compute_dtype=dt)
        else:
            self.conv1 = conv2d(inplanes, c1, 1, stride=s1, padding=0, compute_dtype=dt)
            self.bn1 = batch_norm(c1, compute_dtype=dt)
            self.conv2 = conv2d(c1, c2, 3, stride=s2, padding=1, groups=groups,
                                compute_dtype=dt)
            self.bn2 = batch_norm(c2, compute_dtype=dt)
            self.conv3 = conv2d(c2, out_chs, 1, padding=0, compute_dtype=dt)
            self.bn3 = batch_norm(out_chs, compute_dtype=dt)
        self.se_module = _SEModule(out_chs, reduction, compute_dtype=dt)
        self.downsample = (nn.Sequential(
            conv2d(inplanes, out_chs, down_kernel, stride=stride, padding=down_padding,
                   compute_dtype=dt),
            batch_norm(out_chs, compute_dtype=dt)) if has_downsample else None)
        self.out_channels = out_chs

    def forward(self, x):
        out = act.relu(self.bn1(self.conv1(x)))
        if self.kind == "basic":
            # the legacy basic block activates after bn2 too (senet.py:213-215)
            out = act.relu(self.bn2(self.conv2(out)))
        else:
            out = act.relu(self.bn2(self.conv2(out)))
            out = self.bn3(self.conv3(out))
        out = self.se_module(out)
        residual = x if self.downsample is None else self.downsample(x)
        return act.relu(act.residual_add(out, residual))


class _Layer0(nn.Module):
    def __init__(self, in_chans: int, inplanes: int, input_3x3: bool, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.input_3x3 = input_3x3
        if input_3x3:
            self.conv1 = conv2d(in_chans, 64, 3, stride=2, padding=1, compute_dtype=dt)
            self.bn1 = batch_norm(64, compute_dtype=dt)
            self.conv2 = conv2d(64, 64, 3, padding=1, compute_dtype=dt)
            self.bn2 = batch_norm(64, compute_dtype=dt)
            self.conv3 = conv2d(64, inplanes, 3, padding=1, compute_dtype=dt)
            self.bn3 = batch_norm(inplanes, compute_dtype=dt)
        else:
            self.conv1 = conv2d(in_chans, inplanes, 7, stride=2, padding=3, compute_dtype=dt)
            self.bn1 = batch_norm(inplanes, compute_dtype=dt)

    def forward(self, x):
        x = act.relu(self.bn1(self.conv1(x)))
        if self.input_3x3:
            x = act.relu(self.bn2(self.conv2(x)))
            x = act.relu(self.bn3(self.conv3(x)))
        return max_pool_3x3_s2_ceil(x)


class SENet(nn.Module):
    """Legacy SENet (``timm/models/senet.py:262-340``). ``num_classes=0``
    builds no ``last_linear``; ``features_only`` returns layer4's map (the
    reference's 'seresnet' head strip, ``sloter/slot_model.py:35-37``)."""

    def __init__(self, block_kind: str = "basic", layers: Sequence[int] = (2, 2, 2, 2),
                 groups: int = 1, reduction: int = 16, inplanes: int = 64,
                 input_3x3: bool = False, down_kernel: int = 1, down_padding: int = 0,
                 base_width: int = 4, num_classes: int = 1000, in_chans: int = 3,
                 drop_rate: float = 0.0, mnist_stem: bool = False, compute_dtype=None):
        super().__init__()
        del mnist_stem  # the JAX family takes and ignores it
        dt = compute_dtype
        self.drop_rate = drop_rate
        expansion = 1 if block_kind == "basic" else 4
        self.layer0 = _Layer0(in_chans, inplanes, input_3x3, dt)
        current = inplanes
        for stage_idx, blocks in enumerate(layers, start=1):
            planes = 64 * (2 ** (stage_idx - 1))
            stride = 1 if stage_idx == 1 else 2
            # layer1's projection is 1x1 with no padding whatever the others'
            dk = 1 if stage_idx == 1 else down_kernel
            dp = 0 if stage_idx == 1 else down_padding
            seq = []
            for block_idx in range(blocks):
                s = stride if block_idx == 0 else 1
                needs_ds = block_idx == 0 and (s != 1 or current != planes * expansion)
                seq.append(_SEBlock(block_kind, current, planes, groups, reduction, stride=s,
                                    base_width=base_width, has_downsample=needs_ds,
                                    down_kernel=dk, down_padding=dp, compute_dtype=dt))
                current = planes * expansion
            self.add_module(f"layer{stage_idx}", nn.Sequential(*seq))
        self.num_features = current
        self.last_linear = (Linear(current, num_classes, compute_dtype=head_dtype(dt))
                            if num_classes > 0 else None)

    def forward(self, x: torch.Tensor, features_only: bool = False) -> torch.Tensor:
        x = self.layer0(x)
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
        return x if features_only else self.forward_head(x)

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        """The class scores of a ``features_only`` map."""
        return self.last_linear(head_dropout(global_avg_pool(x), self.drop_rate, self.training))


def _senet(num_classes, in_chans, kw, **cfg):
    return SENet(num_classes=num_classes, in_chans=in_chans, **cfg, **kw)


@register_model
def seresnet18(num_classes=1000, in_chans=3, **kw):
    return _senet(num_classes, in_chans, kw, block_kind="basic", layers=(2, 2, 2, 2))


@register_model
def seresnet34(num_classes=1000, in_chans=3, **kw):
    return _senet(num_classes, in_chans, kw, block_kind="basic", layers=(3, 4, 6, 3))


@register_model
def seresnet50(num_classes=1000, in_chans=3, **kw):
    return _senet(num_classes, in_chans, kw, block_kind="bottleneck", layers=(3, 4, 6, 3))


@register_model
def seresnet101(num_classes=1000, in_chans=3, **kw):
    return _senet(num_classes, in_chans, kw, block_kind="bottleneck", layers=(3, 4, 23, 3))


@register_model
def seresnext26_32x4d(num_classes=1000, in_chans=3, **kw):
    return _senet(num_classes, in_chans, kw, block_kind="next", layers=(2, 2, 2, 2),
                  groups=32, base_width=4)


@register_model
def seresnext50_32x4d(num_classes=1000, in_chans=3, **kw):
    return _senet(num_classes, in_chans, kw, block_kind="next", layers=(3, 4, 6, 3),
                  groups=32, base_width=4)


@register_model
def senet154(num_classes=1000, in_chans=3, **kw):
    return _senet(num_classes, in_chans, kw, block_kind="senet154", layers=(3, 8, 36, 3),
                  groups=64, inplanes=128, input_3x3=True, down_kernel=3, down_padding=1)


@register_model
def seresnet152(num_classes=1000, in_chans=3, **kw):
    """SE-ResNet-152 (timm/models/senet.py:452-461)."""
    return _senet(num_classes, in_chans, kw, block_kind="bottleneck", layers=(3, 8, 36, 3))


@register_model
def seresnext101_32x4d(num_classes=1000, in_chans=3, **kw):
    """SE-ResNeXt-101 32x4d (timm/models/senet.py:502-511)."""
    return _senet(num_classes, in_chans, kw, block_kind="next", layers=(3, 4, 23, 3),
                  groups=32, base_width=4)
