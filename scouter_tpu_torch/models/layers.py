"""NCHW layers for the backbones the port carries
(counterpart of ``scouter_tpu/models/layers.py``).

Torch conv padding, BatchNorm with eps 1e-5, and the pooling variants the
ResNet/ResNeSt skips use. Module names follow timm's, so state dicts carry the
reference's names.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "SplitAttnConv",
    "avg_pool_ceil_exclude_pad",
    "avg_pool_include_pad",
    "batch_norm",
    "conv2d",
    "global_avg_pool",
    "max_pool_3x3_s2_p1",
    "torch_conv_padding",
]


def torch_conv_padding(kernel_size: int, stride: int, dilation: int = 1) -> int:
    """The symmetric padding timm computes (``timm/models/resnet.py:137-139``)."""
    return ((stride - 1) + dilation * (kernel_size - 1)) // 2


def conv2d(in_channels: int, out_channels: int, kernel_size: int, *, stride: int = 1,
           padding=None, dilation: int = 1, groups: int = 1, bias: bool = False) -> nn.Conv2d:
    """``nn.Conv2d`` with timm's symmetric padding. Marked for the fan-out
    truncated-normal init of the JAX package's ``conv2d`` (models/__init__.py)."""
    p = torch_conv_padding(kernel_size, stride, dilation) if padding is None else padding
    conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride=stride, padding=p,
                     dilation=dilation, groups=groups, bias=bias)
    conv.fan_out_init = True
    return conv


def batch_norm(num_features: int, *, eps: float = 1e-5) -> nn.BatchNorm2d:
    """BatchNorm with torch defaults (momentum 0.1, eps 1e-5)."""
    return nn.BatchNorm2d(num_features, eps=eps, momentum=0.1)


def max_pool_3x3_s2_p1(x: torch.Tensor) -> torch.Tensor:
    """torch MaxPool2d(3, 2, 1)."""
    return F.max_pool2d(x, 3, 2, 1)


def avg_pool_include_pad(x: torch.Tensor, window: int, stride: int, pad: int) -> torch.Tensor:
    """AvgPool2d(window, stride, pad) with count_include_pad=True (the default)."""
    return F.avg_pool2d(x, window, stride, pad, count_include_pad=True)


def avg_pool_ceil_exclude_pad(x: torch.Tensor, window: int = 2, stride: int = 2) -> torch.Tensor:
    """AvgPool2d(window, stride, ceil_mode=True, count_include_pad=False), timm's
    ``downsample_avg`` in the ResNet-D / ResNeSt skips: on an odd map the last
    window hangs over the edge and divides by the elements it covers."""
    return F.avg_pool2d(x, window, stride, 0, ceil_mode=True, count_include_pad=False)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """SelectAdaptivePool2d('avg') + flatten: (B,C,H,W) -> (B,C)."""
    return x.mean(dim=(2, 3))


class SplitAttnConv(nn.Module):
    """ResNeSt split-attention conv (``timm/models/layers/split_attn.py:31-80``).

    conv (groups*radix) -> bn0 -> relu -> radix sum -> global pool -> fc1 ->
    bn1 -> relu -> fc2 -> radix softmax -> weighted sum over the radix splits.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, dilation: int = 1, groups: int = 1,
                 radix: int = 2, reduction_factor: int = 4):
        super().__init__()
        self.radix, self.groups = radix, groups
        mid_chs = out_channels * radix
        attn_chs = max(in_channels * radix // reduction_factor, 32)
        self.conv = nn.Conv2d(in_channels, mid_chs, kernel_size, stride=stride,
                              padding=padding, dilation=dilation, groups=groups * radix,
                              bias=False)
        self.bn0 = batch_norm(mid_chs)
        self.fc1 = nn.Conv2d(out_channels, attn_chs, 1, groups=groups)
        self.bn1 = batch_norm(attn_chs)
        self.fc2 = nn.Conv2d(attn_chs, mid_chs, 1, groups=groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn0(self.conv(x)))
        b, rc, h, w = x.shape
        chs = rc // self.radix
        if self.radix > 1:
            # channels are radix-major (the grouped conv's output order)
            x_r = x.view(b, self.radix, chs, h, w)
            gap = x_r.sum(dim=1).mean(dim=(2, 3), keepdim=True)
        else:
            x_r = x
            gap = x.mean(dim=(2, 3), keepdim=True)
        gap = torch.relu(self.bn1(self.fc1(gap)))
        attn = self.fc2(gap)  # (B, mid, 1, 1)
        if self.radix > 1:
            # RadixSoftmax (split_attn.py:14-28): view as (groups, radix, chs),
            # softmax over radix, applied in the transposed (radix, groups,
            # chs) flat order -- the reference's reshape quirk, kept as it is
            attn = attn.view(b, self.groups, self.radix, -1).transpose(1, 2)
            attn = torch.softmax(attn, dim=1).reshape(b, self.radix, chs, 1, 1)
            return (x_r * attn).sum(dim=1)
        return x_r * torch.sigmoid(attn)
