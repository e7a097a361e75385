"""The SelecSLS family in NCHW (counterpart of ``scouter_tpu/models/selecsls.py``,
after ``timm/models/selecsls.py``).

A conv-bn-relu stem at stride 2 (:137); SelecSLS blocks of six conv-bn-relu
units with an internal 3-way concat and a skip lane across blocks (:87-113);
a 4-conv head (:139) and the classifier; each variant's own table
(:179-268). Module names are timm's Sequential indices (``stem.0``,
``features.0.conv1.0``, ``head.0.1``, ``fc``).
"""

from __future__ import annotations

import torch
from torch import nn

from . import act
from .layers import Linear, batch_norm, conv2d, global_avg_pool, head_dropout, head_dtype
from .registry import register_model

__all__ = ["SelecSLS"]


class _ConvBn(nn.Sequential):
    """timm's ``conv_bn``: the conv at index 0, the BatchNorm at 1, then
    ``act.relu``."""

    def __init__(self, in_chs: int, out_chs: int, k: int = 3, stride: int = 1,
                 compute_dtype=None):
        super().__init__(conv2d(in_chs, out_chs, k, stride=stride,
                                padding=((stride - 1) + (k - 1)) // 2,
                                compute_dtype=compute_dtype),
                         batch_norm(out_chs, compute_dtype=compute_dtype))

    def forward(self, x):
        return act.relu(self[1](self[0](x)))


class _Block(nn.Module):
    def __init__(self, in_chs: int, skip_chs: int, mid_chs: int, out_chs: int, is_first: bool,
                 stride: int, compute_dtype=None):
        super().__init__()
        dt, m = compute_dtype, mid_chs
        self.is_first = is_first
        self.conv1 = _ConvBn(in_chs, m, 3, stride, dt)
        self.conv2 = _ConvBn(m, m, 1, 1, dt)
        self.conv3 = _ConvBn(m, m // 2, 3, 1, dt)
        self.conv4 = _ConvBn(m // 2, m, 1, 1, dt)
        self.conv5 = _ConvBn(m, m // 2, 3, 1, dt)
        self.conv6 = _ConvBn(m + 2 * (m // 2) + (0 if is_first else skip_chs), out_chs, 1, 1,
                             dt)

    def forward(self, x, skip):
        d1 = self.conv1(x)
        d2 = self.conv3(self.conv2(d1))
        d3 = self.conv5(self.conv4(d2))
        if self.is_first:
            out = self.conv6(torch.cat([d1, d2, d3], dim=1))
            return out, out
        return self.conv6(torch.cat([d1, d2, d3, skip], dim=1)), skip


# (skip_chs, mid_chs, out_chs, is_first, stride) per block; head: (out, k, stride)
_CONFIGS = {
    "selecsls42": (
        [(0, 64, 64, True, 2), (64, 64, 128, False, 1),
         (0, 144, 144, True, 2), (144, 144, 288, False, 1),
         (0, 304, 304, True, 2), (304, 304, 480, False, 1)],
        [(960, 3, 2), (1024, 3, 1), (1024, 3, 2), (1280, 1, 1)],
    ),
    "selecsls42b": (
        [(0, 64, 64, True, 2), (64, 64, 128, False, 1),
         (0, 144, 144, True, 2), (144, 144, 288, False, 1),
         (0, 304, 304, True, 2), (304, 304, 480, False, 1)],
        [(960, 3, 2), (1024, 3, 1), (1280, 3, 2), (1024, 1, 1)],
    ),
    "selecsls60": (
        [(0, 64, 64, True, 2), (64, 64, 128, False, 1),
         (0, 128, 128, True, 2), (128, 128, 128, False, 1), (128, 128, 288, False, 1),
         (0, 288, 288, True, 2), (288, 288, 288, False, 1), (288, 288, 288, False, 1),
         (288, 288, 416, False, 1)],
        [(756, 3, 2), (1024, 3, 1), (1024, 3, 2), (1280, 1, 1)],
    ),
    "selecsls60b": (
        [(0, 64, 64, True, 2), (64, 64, 128, False, 1),
         (0, 128, 128, True, 2), (128, 128, 128, False, 1), (128, 128, 288, False, 1),
         (0, 288, 288, True, 2), (288, 288, 288, False, 1), (288, 288, 288, False, 1),
         (288, 288, 416, False, 1)],
        [(756, 3, 2), (1024, 3, 1), (1280, 3, 2), (1024, 1, 1)],
    ),
    "selecsls84": (
        [(0, 64, 64, True, 2), (64, 64, 144, False, 1),
         (0, 144, 144, True, 2), (144, 144, 144, False, 1), (144, 144, 144, False, 1),
         (144, 144, 144, False, 1), (144, 144, 304, False, 1),
         (0, 304, 304, True, 2), (304, 304, 304, False, 1), (304, 304, 304, False, 1),
         (304, 304, 304, False, 1), (304, 304, 304, False, 1), (304, 304, 512, False, 1)],
        [(960, 3, 2), (1024, 3, 1), (1024, 3, 2), (1280, 3, 1)],
    ),
}


class SelecSLS(nn.Module):
    """SelecSLS (``timm/models/selecsls.py:116-176``). ``num_classes=0``
    builds no ``fc``; ``features_only`` returns the head's last map."""

    def __init__(self, variant: str = "selecsls60", num_classes: int = 1000, in_chans: int = 3,
                 drop_rate: float = 0.0, mnist_stem: bool = False, compute_dtype=None):
        super().__init__()
        del mnist_stem  # the JAX family takes and ignores it
        dt = compute_dtype
        self.drop_rate = drop_rate
        features, head = _CONFIGS[variant]
        self.stem = _ConvBn(in_chans, 32, 3, 2, dt)
        blocks, current = [], 32
        for skip_chs, mid, out, is_first, stride in features:
            blocks.append(_Block(current, skip_chs, mid, out, is_first, stride, dt))
            current = out
        self.features = nn.ModuleList(blocks)
        units = []
        for out, k, stride in head:
            units.append(_ConvBn(current, out, k, stride, dt))
            current = out
        self.head = nn.Sequential(*units)
        self.num_features = current
        self.fc = (Linear(current, num_classes, compute_dtype=head_dtype(dt))
                   if num_classes > 0 else None)

    def forward(self, x: torch.Tensor, features_only: bool = False) -> torch.Tensor:
        x = self.stem(x)
        skip = x
        for block in self.features:
            x, skip = block(x, skip)
        x = self.head(x)
        return x if features_only else self.forward_head(x)

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        """The class scores of a ``features_only`` map."""
        return self.fc(head_dropout(global_avg_pool(x), self.drop_rate, self.training))


def _selecsls(variant, num_classes, in_chans, kw):
    return SelecSLS(variant=variant, num_classes=num_classes, in_chans=in_chans, **kw)


@register_model
def selecsls42(num_classes=1000, in_chans=3, **kw):
    """SelecSLS42 (timm/models/selecsls.py:181-209 'else' head)."""
    return _selecsls("selecsls42", num_classes, in_chans, kw)


@register_model
def selecsls42b(num_classes=1000, in_chans=3, **kw):
    return _selecsls("selecsls42b", num_classes, in_chans, kw)


@register_model
def selecsls60(num_classes=1000, in_chans=3, **kw):
    return _selecsls("selecsls60", num_classes, in_chans, kw)


@register_model
def selecsls60b(num_classes=1000, in_chans=3, **kw):
    return _selecsls("selecsls60b", num_classes, in_chans, kw)


@register_model
def selecsls84(num_classes=1000, in_chans=3, **kw):
    return _selecsls("selecsls84", num_classes, in_chans, kw)
