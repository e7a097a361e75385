"""ResNet / ResNeSt backbones in NCHW (counterpart of ``scouter_tpu/models/resnet.py``).

The port carries the block kinds of resnet10/18 (``basic``) and
resnest14d/26d/50d (``resnest``), with the ``''`` and ``'deep'`` stems and the
MNIST stem, at output stride 32. Module names are timm's (conv1, bn1,
layer2.0, downsample.1, ...), so ``state_dict()`` carries the reference's keys.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .layers import (
    SplitAttnConv,
    avg_pool_ceil_exclude_pad,
    avg_pool_include_pad,
    batch_norm,
    conv2d,
    global_avg_pool,
    max_pool_3x3_s2_p1,
)

__all__ = ["ResNet"]

_EXPANSION = {"basic": 1, "resnest": 4}
_STAGE_PLANES = (64, 128, 256, 512)
_STAGE_STRIDES = (1, 2, 2, 2)


class _AvgPoolCeilExcludePad(nn.Module):
    def __init__(self, stride: int):
        super().__init__()
        self.stride = stride

    def forward(self, x):
        return avg_pool_ceil_exclude_pad(x, 2, self.stride)


def _downsample(in_channels: int, out_channels: int, stride: int, avg_down: bool) -> nn.Sequential:
    """Skip projection with timm's Sequential indices: conv path
    [conv(0), bn(1)]; avg path [pool(0), conv(1), bn(2)]
    (``timm/models/resnet.py:277-306``)."""
    if avg_down:
        pool = _AvgPoolCeilExcludePad(stride) if stride != 1 else nn.Identity()
        return nn.Sequential(pool, conv2d(in_channels, out_channels, 1, padding=0),
                             batch_norm(out_channels))
    return nn.Sequential(conv2d(in_channels, out_channels, 1, stride=stride, padding=0),
                         batch_norm(out_channels))


class _BasicBlock(nn.Module):
    """conv3x3(stride)-bn-relu-conv3x3-bn [+proj] -relu (resnet.py:142-199)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False, avg_down: bool = False):
        super().__init__()
        self.conv1 = conv2d(inplanes, planes, 3, stride=stride, padding=1)
        self.bn1 = batch_norm(planes)
        self.conv2 = conv2d(planes, planes, 3, padding=1)
        self.bn2 = batch_norm(planes)
        self.downsample = (_downsample(inplanes, planes, stride, avg_down)
                           if has_downsample else None)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


class _ResNestBottleneck(nn.Module):
    """ResNeSt bottleneck: 1x1 / split-attn 3x3 (+avd pool) / 1x1 (resnest.py:58-143)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, cardinality: int = 1,
                 base_width: int = 64, radix: int = 2, avd: bool = True,
                 avd_first: bool = False, has_downsample: bool = False, avg_down: bool = True):
        super().__init__()
        group_width = int(planes * (base_width / 64.0)) * cardinality
        outplanes = planes * 4
        # avd: the stride moves out of the 3x3 conv into a 3x3 avg pool
        if avd and stride > 1:
            self.avd_stride, conv_stride = stride, 1
        else:
            self.avd_stride, conv_stride = 0, stride
        self.avd_first = avd_first
        self.conv1 = conv2d(inplanes, group_width, 1, padding=0)
        self.bn1 = batch_norm(group_width)
        self.conv2 = SplitAttnConv(group_width, group_width, 3, stride=conv_stride, padding=1,
                                   groups=cardinality, radix=radix)
        self.conv3 = conv2d(group_width, outplanes, 1, padding=0)
        self.bn3 = batch_norm(outplanes)
        self.downsample = (_downsample(inplanes, outplanes, stride, avg_down)
                           if has_downsample else None)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        if self.avd_stride and self.avd_first:
            out = avg_pool_include_pad(out, 3, self.avd_stride, 1)
        out = self.conv2(out)
        if self.avd_stride and not self.avd_first:
            out = avg_pool_include_pad(out, 3, self.avd_stride, 1)
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


class ResNet(nn.Module):
    """ResNet/ResNeSt (timm/models/resnet.py:309-509) for the block kinds the
    port carries.

    ``block``: 'basic' | 'resnest'. ``stem_type``: '' (7x7) | 'deep' (3x 3x3).
    ``mnist_stem``: the stem conv becomes Conv(in_chans->64, 3x3, s2, p1), the
    reference's MNIST surgery (``sloter/slot_model.py:23-24``).
    """

    def __init__(self, block: str = "basic", layers: Sequence[int] = (2, 2, 2, 2),
                 num_classes: int = 1000, in_chans: int = 3, cardinality: int = 1,
                 base_width: int = 64, stem_width: int = 64, stem_type: str = "",
                 avg_down: bool = False, output_stride: int = 32, radix: int = 2,
                 avd: bool = True, avd_first: bool = False, mnist_stem: bool = False):
        super().__init__()
        if block not in _EXPANSION:
            raise NotImplementedError(
                f"block kind {block!r} is not ported yet (ported: {sorted(_EXPANSION)})")
        if stem_type not in ("", "deep"):
            raise NotImplementedError(f"stem_type {stem_type!r} is not ported yet")
        if output_stride != 32:
            raise NotImplementedError(f"output_stride {output_stride} is not ported yet")
        self.block = block
        deep_stem = stem_type == "deep"
        inplanes = stem_width * 2 if deep_stem else 64

        if mnist_stem:
            self.conv1 = conv2d(in_chans, 64, 3, stride=2, padding=1)
            inplanes = 64
        elif deep_stem:
            self.conv1 = nn.Sequential(
                conv2d(in_chans, stem_width, 3, stride=2, padding=1),
                batch_norm(stem_width), nn.ReLU(),
                conv2d(stem_width, stem_width, 3, padding=1),
                batch_norm(stem_width), nn.ReLU(),
                conv2d(stem_width, inplanes, 3, padding=1),
            )
        else:
            self.conv1 = conv2d(in_chans, inplanes, 7, stride=2, padding=3)
        self.bn1 = batch_norm(inplanes)

        expansion = _EXPANSION[block]
        current = inplanes
        for stage_idx, (planes, n_blocks, stage_stride) in enumerate(
                zip(_STAGE_PLANES, layers, _STAGE_STRIDES), start=1):
            blocks = []
            for block_idx in range(n_blocks):
                stride = stage_stride if block_idx == 0 else 1
                needs_ds = block_idx == 0 and (stride != 1 or current != planes * expansion)
                if block == "basic":
                    blocks.append(_BasicBlock(current, planes, stride, needs_ds, avg_down))
                else:
                    blocks.append(_ResNestBottleneck(
                        current, planes, stride, cardinality=cardinality,
                        base_width=base_width, radix=radix, avd=avd, avd_first=avd_first,
                        has_downsample=needs_ds, avg_down=avg_down))
                current = planes * expansion
            self.add_module(f"layer{stage_idx}", nn.Sequential(*blocks))
        self.num_features = current
        # num_classes=0 builds no classifier (timm's convention): the slot
        # model reads features only, and the reference checkpoint has no fc
        self.fc = nn.Linear(current, num_classes) if num_classes > 0 else None

    def forward(self, x: torch.Tensor, features_only: bool = False) -> torch.Tensor:
        """x: (B, C, H, W). Returns the (B, num_features, h, w) map when
        ``features_only``, else (B, num_classes) class scores."""
        x = max_pool_3x3_s2_p1(torch.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if features_only:
            return x
        x = global_avg_pool(x)
        return x if self.fc is None else self.fc(x)
