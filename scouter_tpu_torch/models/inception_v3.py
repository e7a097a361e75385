"""Inception-V3 in NCHW (counterpart of ``scouter_tpu/models/inception_v3.py``,
after ``timm/models/inception_v3.py:162-505``).

The five-conv stem, the InceptionA-E blocks with their asymmetric 1x7/7x1
and 1x3/3x1 kernels, and the BasicConv2d unit: a bias-free conv,
BatchNorm with eps 1e-3 and ReLU (:494-503). The max pools are 3x3/2
VALID; the pool branches average 3x3/1 with padding 1, the padded zeros
counted. The convs are flax ``nn.Conv`` in JAX, not its ``conv2d``: plain
``Conv2d`` here (LeCun init, and no conv policy replaces them). Module
names are timm's (``Conv2d_1a_3x3.conv``, ``Mixed_5b.branch5x5_1.bn``,
``fc``). The tf_, adv_ and gluon_ entrypoints build the same module with
other weights.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import act
from .layers import (Conv2d, Linear, avg_pool_include_pad, batch_norm, global_avg_pool,
                     head_dropout, head_dtype)
from .registry import register_model

__all__ = ["InceptionV3"]


class _BasicConv(nn.Module):
    """conv (no bias) + BatchNorm (eps 1e-3) + ReLU; ``kernel_size`` and
    ``padding`` take an int or an (h, w) pair."""

    def __init__(self, in_chs: int, out_chs: int, kernel_size=3, stride: int = 1, padding=0,
                 compute_dtype=None):
        super().__init__()
        self.conv = Conv2d(in_chs, out_chs, kernel_size, stride=stride, padding=padding,
                           bias=False, compute_dtype=compute_dtype)
        self.bn = batch_norm(out_chs, eps=1e-3, compute_dtype=compute_dtype)

    def forward(self, x):
        return act.relu(self.bn(self.conv(x)))


def _max_pool3_s2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(3, 2), VALID."""
    return F.max_pool2d(x, 3, 2)


def _avg_pool3_s1_p1(x: torch.Tensor) -> torch.Tensor:
    return avg_pool_include_pad(x, 3, 1, 1)


class _InceptionA(nn.Module):
    def __init__(self, in_chs: int, pool_features: int, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.branch1x1 = _BasicConv(in_chs, 64, 1, compute_dtype=dt)
        self.branch5x5_1 = _BasicConv(in_chs, 48, 1, compute_dtype=dt)
        self.branch5x5_2 = _BasicConv(48, 64, 5, padding=2, compute_dtype=dt)
        self.branch3x3dbl_1 = _BasicConv(in_chs, 64, 1, compute_dtype=dt)
        self.branch3x3dbl_2 = _BasicConv(64, 96, 3, padding=1, compute_dtype=dt)
        self.branch3x3dbl_3 = _BasicConv(96, 96, 3, padding=1, compute_dtype=dt)
        self.branch_pool = _BasicConv(in_chs, pool_features, 1, compute_dtype=dt)
        self.out_chs = 224 + pool_features

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool3_s1_p1(x))
        return torch.cat([self.branch1x1(x), b5, b3, bp], dim=1)


class _InceptionB(nn.Module):
    def __init__(self, in_chs: int, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.branch3x3 = _BasicConv(in_chs, 384, 3, stride=2, compute_dtype=dt)
        self.branch3x3dbl_1 = _BasicConv(in_chs, 64, 1, compute_dtype=dt)
        self.branch3x3dbl_2 = _BasicConv(64, 96, 3, padding=1, compute_dtype=dt)
        self.branch3x3dbl_3 = _BasicConv(96, 96, 3, stride=2, compute_dtype=dt)
        self.out_chs = 480 + in_chs

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool3_s2(x)], dim=1)


class _InceptionC(nn.Module):
    def __init__(self, in_chs: int, channels_7x7: int, compute_dtype=None):
        super().__init__()
        dt, c7 = compute_dtype, channels_7x7
        self.branch1x1 = _BasicConv(in_chs, 192, 1, compute_dtype=dt)
        self.branch7x7_1 = _BasicConv(in_chs, c7, 1, compute_dtype=dt)
        self.branch7x7_2 = _BasicConv(c7, c7, (1, 7), padding=(0, 3), compute_dtype=dt)
        self.branch7x7_3 = _BasicConv(c7, 192, (7, 1), padding=(3, 0), compute_dtype=dt)
        self.branch7x7dbl_1 = _BasicConv(in_chs, c7, 1, compute_dtype=dt)
        self.branch7x7dbl_2 = _BasicConv(c7, c7, (7, 1), padding=(3, 0), compute_dtype=dt)
        self.branch7x7dbl_3 = _BasicConv(c7, c7, (1, 7), padding=(0, 3), compute_dtype=dt)
        self.branch7x7dbl_4 = _BasicConv(c7, c7, (7, 1), padding=(3, 0), compute_dtype=dt)
        self.branch7x7dbl_5 = _BasicConv(c7, 192, (1, 7), padding=(0, 3), compute_dtype=dt)
        self.branch_pool = _BasicConv(in_chs, 192, 1, compute_dtype=dt)
        self.out_chs = 768

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool3_s1_p1(x))
        return torch.cat([self.branch1x1(x), b7, bd, bp], dim=1)


class _InceptionD(nn.Module):
    def __init__(self, in_chs: int, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.branch3x3_1 = _BasicConv(in_chs, 192, 1, compute_dtype=dt)
        self.branch3x3_2 = _BasicConv(192, 320, 3, stride=2, compute_dtype=dt)
        self.branch7x7x3_1 = _BasicConv(in_chs, 192, 1, compute_dtype=dt)
        self.branch7x7x3_2 = _BasicConv(192, 192, (1, 7), padding=(0, 3), compute_dtype=dt)
        self.branch7x7x3_3 = _BasicConv(192, 192, (7, 1), padding=(3, 0), compute_dtype=dt)
        self.branch7x7x3_4 = _BasicConv(192, 192, 3, stride=2, compute_dtype=dt)
        self.out_chs = 512 + in_chs

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool3_s2(x)], dim=1)


class _InceptionE(nn.Module):
    def __init__(self, in_chs: int, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.branch1x1 = _BasicConv(in_chs, 320, 1, compute_dtype=dt)
        self.branch3x3_1 = _BasicConv(in_chs, 384, 1, compute_dtype=dt)
        self.branch3x3_2a = _BasicConv(384, 384, (1, 3), padding=(0, 1), compute_dtype=dt)
        self.branch3x3_2b = _BasicConv(384, 384, (3, 1), padding=(1, 0), compute_dtype=dt)
        self.branch3x3dbl_1 = _BasicConv(in_chs, 448, 1, compute_dtype=dt)
        self.branch3x3dbl_2 = _BasicConv(448, 384, 3, padding=1, compute_dtype=dt)
        self.branch3x3dbl_3a = _BasicConv(384, 384, (1, 3), padding=(0, 1), compute_dtype=dt)
        self.branch3x3dbl_3b = _BasicConv(384, 384, (3, 1), padding=(1, 0), compute_dtype=dt)
        self.branch_pool = _BasicConv(in_chs, 192, 1, compute_dtype=dt)
        self.out_chs = 2048

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        bp = self.branch_pool(_avg_pool3_s1_p1(x))
        return torch.cat([self.branch1x1(x), b3, bd, bp], dim=1)


class InceptionV3(nn.Module):
    """Inception-V3 (``timm/models/inception_v3.py:162-240``). ``num_classes=0``
    builds no ``fc``; ``features_only`` returns ``Mixed_7c``'s map."""

    def __init__(self, num_classes: int = 1000, in_chans: int = 3, drop_rate: float = 0.0,
                 mnist_stem: bool = False, compute_dtype=None):
        super().__init__()
        del mnist_stem  # the JAX family takes and ignores it
        dt = compute_dtype
        self.drop_rate = drop_rate
        self.Conv2d_1a_3x3 = _BasicConv(in_chans, 32, 3, stride=2, compute_dtype=dt)
        self.Conv2d_2a_3x3 = _BasicConv(32, 32, 3, compute_dtype=dt)
        self.Conv2d_2b_3x3 = _BasicConv(32, 64, 3, padding=1, compute_dtype=dt)
        self.Conv2d_3b_1x1 = _BasicConv(64, 80, 1, compute_dtype=dt)
        self.Conv2d_4a_3x3 = _BasicConv(80, 192, 3, compute_dtype=dt)
        blocks = [("Mixed_5b", lambda c: _InceptionA(c, 32, dt)),
                  ("Mixed_5c", lambda c: _InceptionA(c, 64, dt)),
                  ("Mixed_5d", lambda c: _InceptionA(c, 64, dt)),
                  ("Mixed_6a", lambda c: _InceptionB(c, dt)),
                  ("Mixed_6b", lambda c: _InceptionC(c, 128, dt)),
                  ("Mixed_6c", lambda c: _InceptionC(c, 160, dt)),
                  ("Mixed_6d", lambda c: _InceptionC(c, 160, dt)),
                  ("Mixed_6e", lambda c: _InceptionC(c, 192, dt)),
                  ("Mixed_7a", lambda c: _InceptionD(c, dt)),
                  ("Mixed_7b", lambda c: _InceptionE(c, dt)),
                  ("Mixed_7c", lambda c: _InceptionE(c, dt))]
        current = 192
        self.mixed = [name for name, _ in blocks]
        for name, make in blocks:
            block = make(current)
            self.add_module(name, block)
            current = block.out_chs
        self.num_features = current
        self.fc = (Linear(current, num_classes, compute_dtype=head_dtype(dt))
                   if num_classes > 0 else None)

    def forward(self, x: torch.Tensor, features_only: bool = False) -> torch.Tensor:
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool3_s2(x)
        x = _max_pool3_s2(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)))
        for name in self.mixed:
            x = getattr(self, name)(x)
        return x if features_only else self.forward_head(x)

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        """The class scores of a ``features_only`` map."""
        return self.fc(head_dropout(global_avg_pool(x), self.drop_rate, self.training))


def _inception_v3(num_classes, in_chans, kw):
    return InceptionV3(num_classes=num_classes, in_chans=in_chans, **kw)


@register_model
def inception_v3(num_classes=1000, in_chans=3, **kw):
    return _inception_v3(num_classes, in_chans, kw)


@register_model
def tf_inception_v3(num_classes=1000, in_chans=3, **kw):
    return _inception_v3(num_classes, in_chans, kw)


@register_model
def adv_inception_v3(num_classes=1000, in_chans=3, **kw):
    """Adversarially-trained weights alias (timm inception_v3.py:549-553)."""
    return _inception_v3(num_classes, in_chans, kw)


@register_model
def gluon_inception_v3(num_classes=1000, in_chans=3, **kw):
    """Gluon weights alias (timm inception_v3.py:556-561)."""
    return _inception_v3(num_classes, in_chans, kw)
