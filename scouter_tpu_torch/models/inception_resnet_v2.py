"""Inception-ResNet-V2 in NCHW (counterpart of
``scouter_tpu/models/inception_resnet_v2.py``, after
``timm/models/inception_resnet_v2.py:36-357``).

Residual inception blocks, Block35 x10 at scale 0.17, Block17 x20 at 0.10
and Block8 x9 at 0.20 and a last Block8 at scale 1.0 without its ReLU,
between the Mixed_5b/6a/7a reductions; BasicConv2d units
(``inception_v3._BasicConv``), each block's 1x1 ``conv2d`` a flax
``nn.Conv`` with a bias (plain ``Conv2d``); the classifier is ``classif``.
Module names are timm's (``conv2d_1a``, ``mixed_5b.branch3.1``,
``repeat.0``, ``repeat_1.19.conv2d``, ``repeat_2.8``, ``block8``).
"""

from __future__ import annotations

import torch
from torch import nn

from . import act
from .inception_v3 import _BasicConv as _Conv
from .inception_v3 import _max_pool3_s2
from .inception_v4 import _pool_branch, _seq
from .layers import Conv2d, Linear, global_avg_pool, head_dropout, head_dtype
from .registry import register_model

__all__ = ["InceptionResnetV2"]


class _Mixed5b(nn.Module):
    def __init__(self, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.branch0 = _Conv(192, 96, 1, 1, 0, dt)
        self.branch1 = _seq(192, [(48, 1, 1, 0), (64, 5, 1, 2)], dt)
        self.branch2 = _seq(192, [(64, 1, 1, 0), (96, 3, 1, 1), (96, 3, 1, 1)], dt)
        self.branch3 = _pool_branch(192, 64, dt)

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x), self.branch3(x)],
                         dim=1)


class _Block35(nn.Module):
    def __init__(self, scale: float = 0.17, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.scale = scale
        self.branch0 = _Conv(320, 32, 1, 1, 0, dt)
        self.branch1 = _seq(320, [(32, 1, 1, 0), (32, 3, 1, 1)], dt)
        self.branch2 = _seq(320, [(32, 1, 1, 0), (48, 3, 1, 1), (64, 3, 1, 1)], dt)
        self.conv2d = Conv2d(128, 320, 1, bias=True, compute_dtype=dt)

    def forward(self, x):
        out = torch.cat([self.branch0(x), self.branch1(x), self.branch2(x)], dim=1)
        return act.relu(self.conv2d(out) * self.scale + x)


class _Mixed6a(nn.Module):
    def __init__(self, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.branch0 = _Conv(320, 384, 3, 2, 0, dt)
        self.branch1 = _seq(320, [(256, 1, 1, 0), (256, 3, 1, 1), (384, 3, 2, 0)], dt)

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), _max_pool3_s2(x)], dim=1)


class _Block17(nn.Module):
    def __init__(self, scale: float = 0.10, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.scale = scale
        self.branch0 = _Conv(1088, 192, 1, 1, 0, dt)
        self.branch1 = _seq(1088, [(128, 1, 1, 0), (160, (1, 7), 1, (0, 3)),
                                   (192, (7, 1), 1, (3, 0))], dt)
        self.conv2d = Conv2d(384, 1088, 1, bias=True, compute_dtype=dt)

    def forward(self, x):
        out = torch.cat([self.branch0(x), self.branch1(x)], dim=1)
        return act.relu(self.conv2d(out) * self.scale + x)


class _Mixed7a(nn.Module):
    def __init__(self, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.branch0 = _seq(1088, [(256, 1, 1, 0), (384, 3, 2, 0)], dt)
        self.branch1 = _seq(1088, [(256, 1, 1, 0), (288, 3, 2, 0)], dt)
        self.branch2 = _seq(1088, [(256, 1, 1, 0), (288, 3, 1, 1), (320, 3, 2, 0)], dt)

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x), _max_pool3_s2(x)],
                         dim=1)


class _Block8(nn.Module):
    def __init__(self, scale: float = 0.20, no_relu: bool = False, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.scale, self.no_relu = scale, no_relu
        self.branch0 = _Conv(2080, 192, 1, 1, 0, dt)
        self.branch1 = _seq(2080, [(192, 1, 1, 0), (224, (1, 3), 1, (0, 1)),
                                   (256, (3, 1), 1, (1, 0))], dt)
        self.conv2d = Conv2d(448, 2080, 1, bias=True, compute_dtype=dt)

    def forward(self, x):
        out = torch.cat([self.branch0(x), self.branch1(x)], dim=1)
        out = self.conv2d(out) * self.scale + x
        return out if self.no_relu else act.relu(out)


class InceptionResnetV2(nn.Module):
    """Inception-ResNet-V2 (``timm/models/inception_resnet_v2.py:262-357``).
    ``num_classes=0`` builds no ``classif``; ``features_only`` returns
    ``conv2d_7b``'s map."""

    def __init__(self, num_classes: int = 1000, in_chans: int = 3, drop_rate: float = 0.0,
                 mnist_stem: bool = False, compute_dtype=None):
        super().__init__()
        del mnist_stem  # the JAX family takes and ignores it
        dt = compute_dtype
        self.drop_rate = drop_rate
        self.conv2d_1a = _Conv(in_chans, 32, 3, 2, 0, dt)
        self.conv2d_2a = _Conv(32, 32, 3, 1, 0, dt)
        self.conv2d_2b = _Conv(32, 64, 3, 1, 1, dt)
        self.conv2d_3b = _Conv(64, 80, 1, 1, 0, dt)
        self.conv2d_4a = _Conv(80, 192, 3, 1, 0, dt)
        self.mixed_5b = _Mixed5b(dt)
        self.repeat = nn.Sequential(*(_Block35(0.17, dt) for _ in range(10)))
        self.mixed_6a = _Mixed6a(dt)
        self.repeat_1 = nn.Sequential(*(_Block17(0.10, dt) for _ in range(20)))
        self.mixed_7a = _Mixed7a(dt)
        self.repeat_2 = nn.Sequential(*(_Block8(0.20, compute_dtype=dt) for _ in range(9)))
        self.block8 = _Block8(1.0, no_relu=True, compute_dtype=dt)
        self.conv2d_7b = _Conv(2080, 1536, 1, 1, 0, dt)
        self.num_features = 1536
        self.classif = (Linear(1536, num_classes, compute_dtype=head_dtype(dt))
                        if num_classes > 0 else None)

    def forward(self, x: torch.Tensor, features_only: bool = False) -> torch.Tensor:
        x = _max_pool3_s2(self.conv2d_2b(self.conv2d_2a(self.conv2d_1a(x))))
        x = _max_pool3_s2(self.conv2d_4a(self.conv2d_3b(x)))
        x = self.repeat(self.mixed_5b(x))
        x = self.repeat_1(self.mixed_6a(x))
        x = self.block8(self.repeat_2(self.mixed_7a(x)))
        x = self.conv2d_7b(x)
        return x if features_only else self.forward_head(x)

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        """The class scores of a ``features_only`` map."""
        return self.classif(head_dropout(global_avg_pool(x), self.drop_rate, self.training))


@register_model
def inception_resnet_v2(num_classes=1000, in_chans=3, **kw):
    return InceptionResnetV2(num_classes=num_classes, in_chans=in_chans, **kw)


@register_model
def ens_adv_inception_resnet_v2(num_classes=1000, in_chans=3, **kw):
    return InceptionResnetV2(num_classes=num_classes, in_chans=in_chans, **kw)
