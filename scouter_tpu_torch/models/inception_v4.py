"""Inception-V4 in NCHW (counterpart of ``scouter_tpu/models/inception_v4.py``,
after ``timm/models/inception_v4.py:27-310``).

A 22-stage ``features`` Sequential: the 3-conv stem, Mixed_3a/4a/5a, four
Inception-A, Reduction-A, seven Inception-B, Reduction-B and three
Inception-C, of BasicConv2d units (a bias-free flax ``nn.Conv``, BatchNorm
with eps 1e-3, ReLU: ``inception_v3._BasicConv``); the pool branches
average 3x3/1 with padding 1 excluded from the count; the max pools are
3x3/2 VALID; the classifier is ``last_linear``. Module names are timm's
(``features.0.conv``, ``features.4.branch1.2.bn``, ``features.19.branch1_1a``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .inception_v3 import _BasicConv as _Conv
from .inception_v3 import _max_pool3_s2
from .layers import Apply, Linear, global_avg_pool, head_dropout, head_dtype
from .registry import register_model

__all__ = ["InceptionV4"]


def _avgpool3_s1_p1_nopad(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(3, 1, 1, count_include_pad=False)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _seq(in_chs: int, specs: Sequence[Tuple], compute_dtype=None) -> nn.Sequential:
    """A Sequential of BasicConv2d units from (out, kernel, stride, padding)."""
    units = []
    for out, k, s, p in specs:
        units.append(_Conv(in_chs, out, k, s, p, compute_dtype))
        in_chs = out
    return nn.Sequential(*units)


def _pool_branch(in_chs: int, out_chs: int, compute_dtype=None) -> nn.Sequential:
    """timm's ``branch3``: Sequential(AvgPool2d exclude pad, BasicConv2d 1x1)."""
    return nn.Sequential(Apply(_avgpool3_s1_p1_nopad), _Conv(in_chs, out_chs, 1, 1, 0,
                                                             compute_dtype))


class _Mixed3a(nn.Module):
    def __init__(self, compute_dtype=None):
        super().__init__()
        self.conv = _Conv(64, 96, 3, 2, 0, compute_dtype)

    def forward(self, x):
        return torch.cat([_max_pool3_s2(x), self.conv(x)], dim=1)


class _Mixed4a(nn.Module):
    def __init__(self, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.branch0 = _seq(160, [(64, 1, 1, 0), (96, 3, 1, 0)], dt)
        self.branch1 = _seq(160, [(64, 1, 1, 0), (64, (1, 7), 1, (0, 3)),
                                  (64, (7, 1), 1, (3, 0)), (96, 3, 1, 0)], dt)

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x)], dim=1)


class _Mixed5a(nn.Module):
    def __init__(self, compute_dtype=None):
        super().__init__()
        self.conv = _Conv(192, 192, 3, 2, 0, compute_dtype)

    def forward(self, x):
        return torch.cat([self.conv(x), _max_pool3_s2(x)], dim=1)


class _InceptionA(nn.Module):
    def __init__(self, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.branch0 = _Conv(384, 96, 1, 1, 0, dt)
        self.branch1 = _seq(384, [(64, 1, 1, 0), (96, 3, 1, 1)], dt)
        self.branch2 = _seq(384, [(64, 1, 1, 0), (96, 3, 1, 1), (96, 3, 1, 1)], dt)
        self.branch3 = _pool_branch(384, 96, dt)

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x), self.branch3(x)],
                         dim=1)


class _ReductionA(nn.Module):
    def __init__(self, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.branch0 = _Conv(384, 384, 3, 2, 0, dt)
        self.branch1 = _seq(384, [(192, 1, 1, 0), (224, 3, 1, 1), (256, 3, 2, 0)], dt)

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), _max_pool3_s2(x)], dim=1)


class _InceptionB(nn.Module):
    def __init__(self, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.branch0 = _Conv(1024, 384, 1, 1, 0, dt)
        self.branch1 = _seq(1024, [(192, 1, 1, 0), (224, (1, 7), 1, (0, 3)),
                                   (256, (7, 1), 1, (3, 0))], dt)
        self.branch2 = _seq(1024, [(192, 1, 1, 0), (192, (7, 1), 1, (3, 0)),
                                   (224, (1, 7), 1, (0, 3)), (224, (7, 1), 1, (3, 0)),
                                   (256, (1, 7), 1, (0, 3))], dt)
        self.branch3 = _pool_branch(1024, 128, dt)

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x), self.branch3(x)],
                         dim=1)


class _ReductionB(nn.Module):
    def __init__(self, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.branch0 = _seq(1024, [(192, 1, 1, 0), (192, 3, 2, 0)], dt)
        self.branch1 = _seq(1024, [(256, 1, 1, 0), (256, (1, 7), 1, (0, 3)),
                                   (320, (7, 1), 1, (3, 0)), (320, 3, 2, 0)], dt)

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), _max_pool3_s2(x)], dim=1)


class _InceptionC(nn.Module):
    def __init__(self, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.branch0 = _Conv(1536, 256, 1, 1, 0, dt)
        self.branch1_0 = _Conv(1536, 384, 1, 1, 0, dt)
        self.branch1_1a = _Conv(384, 256, (1, 3), 1, (0, 1), dt)
        self.branch1_1b = _Conv(384, 256, (3, 1), 1, (1, 0), dt)
        self.branch2_0 = _Conv(1536, 384, 1, 1, 0, dt)
        self.branch2_1 = _Conv(384, 448, (3, 1), 1, (1, 0), dt)
        self.branch2_2 = _Conv(448, 512, (1, 3), 1, (0, 1), dt)
        self.branch2_3a = _Conv(512, 256, (1, 3), 1, (0, 1), dt)
        self.branch2_3b = _Conv(512, 256, (3, 1), 1, (1, 0), dt)
        self.branch3 = _pool_branch(1536, 256, dt)

    def forward(self, x):
        b1 = self.branch1_0(x)
        b1 = torch.cat([self.branch1_1a(b1), self.branch1_1b(b1)], dim=1)
        b2 = self.branch2_2(self.branch2_1(self.branch2_0(x)))
        b2 = torch.cat([self.branch2_3a(b2), self.branch2_3b(b2)], dim=1)
        return torch.cat([self.branch0(x), b1, b2, self.branch3(x)], dim=1)


class InceptionV4(nn.Module):
    """Inception-V4 (``timm/models/inception_v4.py:252-310``). ``num_classes=0``
    builds no ``last_linear``; ``features_only`` returns the last stage's map."""

    def __init__(self, num_classes: int = 1000, in_chans: int = 3, drop_rate: float = 0.0,
                 mnist_stem: bool = False, compute_dtype=None):
        super().__init__()
        del mnist_stem  # the JAX family takes and ignores it
        dt = compute_dtype
        self.drop_rate = drop_rate
        self.features = nn.Sequential(
            _Conv(in_chans, 32, 3, 2, 0, dt), _Conv(32, 32, 3, 1, 0, dt),
            _Conv(32, 64, 3, 1, 1, dt), _Mixed3a(dt), _Mixed4a(dt), _Mixed5a(dt),
            *(_InceptionA(dt) for _ in range(4)), _ReductionA(dt),
            *(_InceptionB(dt) for _ in range(7)), _ReductionB(dt),
            *(_InceptionC(dt) for _ in range(3)))
        self.num_features = 1536
        self.last_linear = (Linear(1536, num_classes, compute_dtype=head_dtype(dt))
                            if num_classes > 0 else None)

    def forward(self, x: torch.Tensor, features_only: bool = False) -> torch.Tensor:
        x = self.features(x)
        return x if features_only else self.forward_head(x)

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        """The class scores of a ``features_only`` map."""
        return self.last_linear(head_dropout(global_avg_pool(x), self.drop_rate, self.training))


@register_model
def inception_v4(num_classes=1000, in_chans=3, **kw):
    return InceptionV4(num_classes=num_classes, in_chans=in_chans, **kw)
