"""The TResNet family in NCHW (counterpart of ``scouter_tpu/models/tresnet.py``,
after ``timm/models/tresnet.py``).

A space-to-depth(4) stem feeding a 3x3 conv on 16x the input's channels
(tresnet.py:272-276, space_to_depth.py:5-16); conv + InplaceABN units
(BatchNorm then leaky ReLU, slope 1e-3 inside the blocks, 1e-2 in the
stem); stride 2 through a 3x3 conv at stride 1 and an anti-aliasing
[1, 2, 1]^2 blur with reflect padding (anti_aliasing.py:20-60); basic
blocks in stages 1-2 and bottlenecks in stages 3-4 with Fast-SE
(tresnet.py:103-188); an average pool and a 1x1 conv + InplaceABN
(identity) downsample (:252-260). The blocks end in a plain ReLU and add,
which no hook of ``models/act.py`` reaches, as JAX's ``jax.nn.relu`` is
not its ``act.relu``. Module names are timm's (``body.conv1.0``,
``body.layer3.0.conv2.0.0``, ``body.layer1.0.se.fc1``, ``head.fc``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (Apply, Conv2d, Linear, avg_pool_ceil_exclude_pad, batch_norm, blur_pool,
                     conv2d, global_avg_pool, head_dropout, head_dtype)
from .registry import register_model

__all__ = ["TResNet"]


def space_to_depth(x: torch.Tensor, bs: int = 4) -> torch.Tensor:
    """(N, C, H, W) -> (N, bs*bs*C, H/bs, W/bs), channels in torch's
    (bs, bs, C) order (``space_to_depth.py:11-16``), the order of the JAX
    package's NHWC ``space_to_depth``, so the stem conv reads its kernel."""
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // bs, bs, w // bs, bs).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, bs * bs * c, h // bs, w // bs)


def aa_downsample(x: torch.Tensor) -> torch.Tensor:
    """The anti-aliased stride 2: reflect padding 1 and the depthwise
    [1, 2, 1]^2 / 16 blur at stride 2, which is ``layers.blur_pool`` at
    stride 2 with its 3-tap binomial filter."""
    return blur_pool(x, stride=2, filt_size=3)


class _Iabn(nn.Sequential):
    """conv + InplaceABN as timm's ``conv2d_iabn`` Sequential: the conv at
    index 0, the BatchNorm at 1, then the leaky ReLU at ``slope`` (None:
    the identity)."""

    def __init__(self, in_chs: int, out_chs: int, kernel_size: int, slope=1e-2,
                 compute_dtype=None):
        super().__init__(conv2d(in_chs, out_chs, kernel_size, padding=(kernel_size - 1) // 2,
                                compute_dtype=compute_dtype),
                         batch_norm(out_chs, compute_dtype=compute_dtype))
        self.slope = slope

    def forward(self, x):
        x = self[1](self[0](x))
        return x if self.slope is None else F.leaky_relu(x, self.slope)


class _FastSE(nn.Module):
    """Fast-SE: global average -> fc1 (bias) -> ReLU -> fc2 (bias) -> sigmoid
    scale. fc1/fc2 are flax ``nn.Conv`` in JAX: plain ``Conv2d``."""

    def __init__(self, channels: int, reduction_channels: int, compute_dtype=None):
        super().__init__()
        self.fc1 = Conv2d(channels, reduction_channels, 1, bias=True,
                          compute_dtype=compute_dtype)
        self.fc2 = Conv2d(reduction_channels, channels, 1, bias=True,
                          compute_dtype=compute_dtype)

    def forward(self, x):
        s = self.fc2(torch.relu(self.fc1(x.mean(dim=(2, 3), keepdim=True))))
        return x * torch.sigmoid(s)


def _avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    return avg_pool_ceil_exclude_pad(x, 2, 2)


def _downsample(in_chs: int, out_chs: int, stride: int, compute_dtype=None) -> nn.Sequential:
    """timm's Sequential(AvgPool2d(2, 2, ceil_mode, exclude pad), conv2d_iabn
    identity), the unit at index 1 as the JAX package names it."""
    pool = Apply(_avg_pool_2x2) if stride == 2 else nn.Identity()
    return nn.Sequential(pool, _Iabn(in_chs, out_chs, 1, slope=None,
                                     compute_dtype=compute_dtype))


def _strided(in_chs: int, out_chs: int, stride: int, compute_dtype=None) -> nn.Module:
    """A 3x3 unit (``conv2d_iabn``, slope 1e-3), at stride 2 followed by the
    blur in a Sequential (timm's), so the unit's names are ``.0.0``/``.0.1``."""
    unit = _Iabn(in_chs, out_chs, 3, slope=1e-3, compute_dtype=compute_dtype)
    return unit if stride == 1 else nn.Sequential(unit, Apply(aa_downsample))


class _TBasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_chs: int, planes: int, stride: int = 1, use_se: bool = True,
                 has_downsample: bool = False, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.downsample = (_downsample(in_chs, planes, stride, dt) if has_downsample else None)
        self.conv1 = _strided(in_chs, planes, stride, dt)
        self.conv2 = _Iabn(planes, planes, 3, slope=None, compute_dtype=dt)
        self.se = _FastSE(planes, max(planes // 4, 64), dt) if use_se else None

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        out = self.conv2(self.conv1(x))
        if self.se is not None:
            out = self.se(out)
        return torch.relu(out + residual)


class _TBottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_chs: int, planes: int, stride: int = 1, use_se: bool = True,
                 has_downsample: bool = False, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        out_chs = planes * 4
        self.downsample = (_downsample(in_chs, out_chs, stride, dt) if has_downsample
                           else None)
        self.conv1 = _Iabn(in_chs, planes, 1, slope=1e-3, compute_dtype=dt)
        self.conv2 = _strided(planes, planes, stride, dt)
        # the SE gates the mid channels, reduced by the block's output width
        self.se = _FastSE(planes, max(out_chs // 8, 64), dt) if use_se else None
        self.conv3 = _Iabn(planes, out_chs, 1, slope=None, compute_dtype=dt)

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        out = self.conv2(self.conv1(x))
        if self.se is not None:
            out = self.se(out)
        return torch.relu(self.conv3(out) + residual)


class _Body(nn.Module):
    def __init__(self, in_chans: int, layers: Sequence[int], planes: int, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.conv1 = _Iabn(16 * in_chans, planes, 3, compute_dtype=dt)
        specs = [
            ("layer1", _TBasicBlock, planes, 1, True),
            ("layer2", _TBasicBlock, planes * 2, 2, True),
            ("layer3", _TBottleneck, planes * 4, 2, True),
            ("layer4", _TBottleneck, planes * 8, 2, False),
        ]
        current = planes
        for (lname, cls, p, stride, use_se), depth in zip(specs, layers):
            blocks = []
            for i in range(depth):
                s = stride if i == 0 else 1
                needs = i == 0 and (s != 1 or current != p * cls.expansion)
                blocks.append(cls(current, p, s, use_se, needs, dt))
                current = p * cls.expansion
            self.add_module(lname, nn.Sequential(*blocks))
        self.num_features = current

    def forward(self, x):
        x = self.conv1(space_to_depth(x))
        for name in ("layer1", "layer2", "layer3", "layer4"):
            x = getattr(self, name)(x)
        return x


class _Head(nn.Module):
    def __init__(self, num_features: int, num_classes: int, compute_dtype=None):
        super().__init__()
        self.fc = Linear(num_features, num_classes, compute_dtype=head_dtype(compute_dtype))


class TResNet(nn.Module):
    """TResNet (``timm/models/tresnet.py:191-290``). ``num_classes=0`` builds
    no ``head``; ``features_only`` returns layer4's map."""

    def __init__(self, layers: Sequence[int] = (3, 4, 11, 3), width_factor: float = 1.0,
                 num_classes: int = 1000, in_chans: int = 3, drop_rate: float = 0.0,
                 mnist_stem: bool = False, compute_dtype=None):
        super().__init__()
        del mnist_stem  # the JAX family takes and ignores it
        self.drop_rate = drop_rate
        self.body = _Body(in_chans, layers, int(64 * width_factor), compute_dtype)
        self.num_features = self.body.num_features
        self.head = (_Head(self.num_features, num_classes, compute_dtype)
                     if num_classes > 0 else None)

    def forward(self, x: torch.Tensor, features_only: bool = False) -> torch.Tensor:
        x = self.body(x)
        return x if features_only else self.forward_head(x)

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        """The class scores of a ``features_only`` map."""
        return self.head.fc(head_dropout(global_avg_pool(x), self.drop_rate, self.training))


def _tresnet(num_classes, in_chans, kw, **cfg):
    return TResNet(num_classes=num_classes, in_chans=in_chans, **cfg, **kw)


@register_model
def tresnet_m(num_classes=1000, in_chans=3, **kw):
    return _tresnet(num_classes, in_chans, kw, layers=(3, 4, 11, 3))


@register_model
def tresnet_l(num_classes=1000, in_chans=3, **kw):
    return _tresnet(num_classes, in_chans, kw, layers=(4, 5, 18, 3), width_factor=1.2)


@register_model
def tresnet_xl(num_classes=1000, in_chans=3, **kw):
    return _tresnet(num_classes, in_chans, kw, layers=(4, 5, 24, 3), width_factor=1.3)


@register_model
def tresnet_m_448(num_classes=1000, in_chans=3, **kw):
    """448 px-eval weights twin of tresnet_m (timm tresnet.py:323-329)."""
    return _tresnet(num_classes, in_chans, kw, layers=(3, 4, 11, 3))


@register_model
def tresnet_l_448(num_classes=1000, in_chans=3, **kw):
    """448 px-eval weights twin of tresnet_l (tresnet.py:333-339)."""
    return _tresnet(num_classes, in_chans, kw, layers=(4, 5, 18, 3), width_factor=1.2)


@register_model
def tresnet_xl_448(num_classes=1000, in_chans=3, **kw):
    """448 px-eval weights twin of tresnet_xl (tresnet.py:343-349)."""
    return _tresnet(num_classes, in_chans, kw, layers=(4, 5, 24, 3), width_factor=1.3)
