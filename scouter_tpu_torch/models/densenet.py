"""The DenseNet family in NCHW (counterpart of ``scouter_tpu/models/densenet.py``,
after ``timm/models/densenet.py``).

DenseLayer: norm+act -> 1x1 conv (bn_size x growth) -> norm+act -> 3x3 conv
(growth), concatenated onto its input (densenet.py:47-135); transition:
norm+act -> 1x1 conv to half -> 2x2 average pool (:138-147); the stem is a
7x7/2 conv (or three 3x3 convs) with a 3x3/2 max pool, or a stride-1 max
pool and a blur for the anti-aliased variant (:175-201); ``norm5`` and its
act end the features (:226-258), which are 8x8 at 260 px. The norm+act is
BatchNorm and ReLU, or InplaceABN's BatchNorm and leaky ReLU 0.01 for
``norm='iabn'``. Module names are timm's (``features.denseblock1.
denselayer1.norm1``, ``classifier``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (Linear, batch_norm, blur_pool, conv2d, global_avg_pool, head_dropout,
                     head_dtype, norm_act)
from .registry import register_model

__all__ = ["DenseNet"]


class _DenseLayer(nn.Module):
    def __init__(self, in_channels: int, growth_rate: int, bn_size: int, norm: str,
                 compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        mid = bn_size * growth_rate
        self.kind = norm
        self.norm1 = batch_norm(in_channels, compute_dtype=dt)
        self.conv1 = conv2d(in_channels, mid, 1, padding=0, compute_dtype=dt)
        self.norm2 = batch_norm(mid, compute_dtype=dt)
        self.conv2 = conv2d(mid, growth_rate, 3, padding=1, compute_dtype=dt)

    def forward(self, x):
        out = self.conv1(norm_act(self.kind, self.norm1(x)))
        return self.conv2(norm_act(self.kind, self.norm2(out)))


class _DenseBlock(nn.Module):
    def __init__(self, num_layers: int, in_channels: int, growth_rate: int, bn_size: int,
                 norm: str, compute_dtype=None):
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"denselayer{i + 1}",
                            _DenseLayer(in_channels + i * growth_rate, growth_rate, bn_size,
                                        norm, compute_dtype))

    def forward(self, x):
        for layer in self.children():
            x = torch.cat([x, layer(x)], dim=1)
        return x


class _DenseTransition(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, norm: str, compute_dtype=None):
        super().__init__()
        self.kind = norm
        self.norm = batch_norm(in_channels, compute_dtype=compute_dtype)
        self.conv = conv2d(in_channels, out_channels, 1, padding=0, compute_dtype=compute_dtype)

    def forward(self, x):
        return F.avg_pool2d(self.conv(norm_act(self.kind, self.norm(x))), 2, 2)


class _Features(nn.Module):
    def __init__(self, in_chans: int, growth_rate: int, block_config: Sequence[int],
                 bn_size: int, stem_type: str, norm: str, aa: bool, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.kind, self.aa = norm, aa
        self.deep = "deep" in stem_type
        num_init = growth_rate * 2
        if self.deep:
            c1 = c2 = growth_rate
            if "tiered" in stem_type:
                c1 = 3 * (growth_rate // 4)
                c2 = num_init if "narrow" in stem_type else 6 * (growth_rate // 4)
            self.conv0 = conv2d(in_chans, c1, 3, stride=2, padding=1, compute_dtype=dt)
            self.norm0 = batch_norm(c1, compute_dtype=dt)
            self.conv1 = conv2d(c1, c2, 3, padding=1, compute_dtype=dt)
            self.norm1 = batch_norm(c2, compute_dtype=dt)
            self.conv2 = conv2d(c2, num_init, 3, padding=1, compute_dtype=dt)
            self.norm2 = batch_norm(num_init, compute_dtype=dt)
        else:
            self.conv0 = conv2d(in_chans, num_init, 7, stride=2, padding=3, compute_dtype=dt)
            self.norm0 = batch_norm(num_init, compute_dtype=dt)
        num_features = num_init
        self.num_blocks = len(block_config)
        for i, num_layers in enumerate(block_config):
            self.add_module(f"denseblock{i + 1}",
                            _DenseBlock(num_layers, num_features, growth_rate, bn_size, norm,
                                        dt))
            num_features += num_layers * growth_rate
            if i != len(block_config) - 1:
                self.add_module(f"transition{i + 1}",
                                _DenseTransition(num_features, num_features // 2, norm, dt))
                num_features //= 2
        self.norm5 = batch_norm(num_features, compute_dtype=dt)
        self.num_features = num_features

    def forward(self, x):
        x = norm_act(self.kind, self.norm0(self.conv0(x)))
        if self.deep:
            x = norm_act(self.kind, self.norm1(self.conv1(x)))
            x = norm_act(self.kind, self.norm2(self.conv2(x)))
        if self.aa:
            x = blur_pool(F.max_pool2d(x, 3, 1, 1), stride=2)
        else:
            x = F.max_pool2d(x, 3, 2, 1)
        for i in range(1, self.num_blocks + 1):
            x = getattr(self, f"denseblock{i}")(x)
            if i != self.num_blocks:
                x = getattr(self, f"transition{i}")(x)
        return norm_act(self.kind, self.norm5(x))


class DenseNet(nn.Module):
    """DenseNet (``timm/models/densenet.py:150-258``). ``num_classes=0``
    builds no classifier; ``features_only`` returns the features after
    ``norm5`` and its act."""

    def __init__(self, growth_rate: int = 32, block_config: Sequence[int] = (6, 12, 24, 16),
                 bn_size: int = 4, stem_type: str = "", norm: str = "bn", aa: bool = False,
                 num_classes: int = 1000, in_chans: int = 3, drop_rate: float = 0.0,
                 mnist_stem: bool = False, compute_dtype=None):
        super().__init__()
        del mnist_stem  # the JAX family takes and ignores it
        self.drop_rate = drop_rate
        self.features = _Features(in_chans, growth_rate, block_config, bn_size, stem_type,
                                  norm, aa, compute_dtype)
        self.num_features = self.features.num_features
        self.classifier = (Linear(self.num_features, num_classes,
                                  compute_dtype=head_dtype(compute_dtype))
                           if num_classes > 0 else None)

    def forward(self, x: torch.Tensor, features_only: bool = False) -> torch.Tensor:
        feats = self.features(x)
        return feats if features_only else self.forward_head(feats)

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        """The class scores of a ``features_only`` map."""
        return self.classifier(head_dropout(global_avg_pool(x), self.drop_rate, self.training))


def _densenet(num_classes, in_chans, kw, **cfg):
    return DenseNet(num_classes=num_classes, in_chans=in_chans, **cfg, **kw)


@register_model
def densenet121(num_classes=1000, in_chans=3, **kw):
    return _densenet(num_classes, in_chans, kw, growth_rate=32, block_config=(6, 12, 24, 16))


@register_model
def densenet121d(num_classes=1000, in_chans=3, **kw):
    return _densenet(num_classes, in_chans, kw, growth_rate=32, block_config=(6, 12, 24, 16),
                     stem_type="deep")


@register_model
def densenet169(num_classes=1000, in_chans=3, **kw):
    return _densenet(num_classes, in_chans, kw, growth_rate=32, block_config=(6, 12, 32, 32))


@register_model
def densenet201(num_classes=1000, in_chans=3, **kw):
    return _densenet(num_classes, in_chans, kw, growth_rate=32, block_config=(6, 12, 48, 32))


@register_model
def densenet161(num_classes=1000, in_chans=3, **kw):
    return _densenet(num_classes, in_chans, kw, growth_rate=48, block_config=(6, 12, 36, 24))


@register_model
def densenet264(num_classes=1000, in_chans=3, **kw):
    return _densenet(num_classes, in_chans, kw, growth_rate=48, block_config=(6, 12, 64, 48))


@register_model
def densenetblur121d(num_classes=1000, in_chans=3, **kw):
    """DenseNet-121 deep stem + BlurPool stem pooling (densenet.py:314-321)."""
    return _densenet(num_classes, in_chans, kw, growth_rate=32, block_config=(6, 12, 24, 16),
                     stem_type="deep", aa=True)


@register_model
def tv_densenet121(num_classes=1000, in_chans=3, **kw):
    """torchvision-weights alias of densenet121 (densenet.py:387-394)."""
    return _densenet(num_classes, in_chans, kw, growth_rate=32, block_config=(6, 12, 24, 16))


@register_model
def densenet264d_iabn(num_classes=1000, in_chans=3, **kw):
    """DenseNet-264 deep stem with Inplace-ABN norm-act (densenet.py:376-384)."""
    return _densenet(num_classes, in_chans, kw, growth_rate=48, block_config=(6, 12, 64, 48),
                     stem_type="deep", norm="iabn")
