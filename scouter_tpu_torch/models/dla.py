"""DLA, Deep Layer Aggregation, in NCHW (counterpart of
``scouter_tpu/models/dla.py``, after ``timm/models/dla.py:51-470``).

Recursive aggregation trees (DlaTree :206-254) over basic, bottleneck and
Res2Net bottle2neck blocks (:51-184), 1x1 DlaRoot fusion nodes (:186-203),
conv-level stems (:292-301) and a 1x1-conv classifier (:282). Module names
are timm's (``base_layer.0``, ``level0.0``, ``level3.tree2.root.conv``,
``project.1``, ``convs.0``, ``fc``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from . import act
from .layers import Conv2d, avg_pool_include_pad, batch_norm, conv2d, head_dropout
from .registry import register_model
from .resnet import _Relu

__all__ = ["DLA"]


class _DlaBasic(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 cardinality: int = 1, base_width: int = 64, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.conv1 = conv2d(inplanes, planes, 3, stride=stride, padding=dilation,
                            dilation=dilation, compute_dtype=dt)
        self.bn1 = batch_norm(planes, compute_dtype=dt)
        self.conv2 = conv2d(planes, planes, 3, padding=dilation, dilation=dilation,
                            compute_dtype=dt)
        self.bn2 = batch_norm(planes, compute_dtype=dt)

    def forward(self, x, residual=None):
        residual = x if residual is None else residual
        out = act.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return act.relu(act.residual_add(out, residual))


class _DlaBottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 cardinality: int = 1, base_width: int = 64, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        mid = int(math.floor(planes * (base_width / 64)) * cardinality) // 2
        self.conv1 = conv2d(inplanes, mid, 1, padding=0, compute_dtype=dt)
        self.bn1 = batch_norm(mid, compute_dtype=dt)
        self.conv2 = conv2d(mid, mid, 3, stride=stride, padding=dilation, dilation=dilation,
                            groups=cardinality, compute_dtype=dt)
        self.bn2 = batch_norm(mid, compute_dtype=dt)
        self.conv3 = conv2d(mid, planes, 1, padding=0, compute_dtype=dt)
        self.bn3 = batch_norm(planes, compute_dtype=dt)

    def forward(self, x, residual=None):
        residual = x if residual is None else residual
        out = act.relu(self.bn1(self.conv1(x)))
        out = act.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return act.relu(act.residual_add(out, residual))


class _DlaBottle2neck(nn.Module):
    """Res2Net's split 3x3 inside a DLA bottleneck (dla.py:117-184); the last
    split passes through, average-pooled (include-pad) where the block
    strides."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 cardinality: int = 8, base_width: int = 4, scale: int = 4,
                 compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.is_first, self.stride, self.scale = stride > 1, stride, scale
        mid = int(math.floor(planes * (base_width / 64)) * cardinality) // 2
        self.width = mid
        n = max(1, scale - 1)
        self.conv1 = conv2d(inplanes, mid * scale, 1, padding=0, compute_dtype=dt)
        self.bn1 = batch_norm(mid * scale, compute_dtype=dt)
        self.convs = nn.ModuleList(
            conv2d(mid, mid, 3, stride=stride, padding=dilation, dilation=dilation,
                   groups=cardinality, compute_dtype=dt) for _ in range(n))
        self.bns = nn.ModuleList(batch_norm(mid, compute_dtype=dt) for _ in range(n))
        self.conv3 = conv2d(mid * scale, planes, 1, padding=0, compute_dtype=dt)
        self.bn3 = batch_norm(planes, compute_dtype=dt)

    def forward(self, x, residual=None):
        residual = x if residual is None else residual
        out = act.relu(self.bn1(self.conv1(x)))
        splits = out.split(self.width, dim=1)
        outs, sp = [], None
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            sp = splits[i] if (i == 0 or self.is_first) else sp + splits[i]
            sp = act.relu(bn(conv(sp)))
            outs.append(sp)
        if self.scale > 1:
            last = splits[-1]
            if self.is_first:
                last = avg_pool_include_pad(last, 3, self.stride, 1)
            outs.append(last)
        out = self.bn3(self.conv3(torch.cat(outs, dim=1)))
        return act.relu(act.residual_add(out, residual))


_DLA_BLOCKS = {"basic": _DlaBasic, "bottleneck": _DlaBottleneck,
               "bottle2neck": _DlaBottle2neck}


class _DlaRoot(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, residual: bool,
                 compute_dtype=None):
        super().__init__()
        self.residual = residual
        self.conv = conv2d(in_channels, out_channels, 1, padding=0, compute_dtype=compute_dtype)
        self.bn = batch_norm(out_channels, compute_dtype=compute_dtype)

    def forward(self, children):
        x = self.bn(self.conv(torch.cat(children, dim=1)))
        if self.residual:
            x = x + children[0]  # a plain add in JAX's root, which no hook reaches
        return act.relu(x)


class _DlaTree(nn.Module):
    def __init__(self, levels: int, block: str, in_channels: int, out_channels: int,
                 stride: int = 1, cardinality: int = 1, base_width: int = 64,
                 level_root: bool = False, root_dim: int = 0, root_residual: bool = False,
                 compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.levels, self.stride, self.level_root = levels, stride, level_root
        root_dim = 2 * out_channels if root_dim == 0 else root_dim
        if level_root:
            root_dim += in_channels
        bargs = dict(cardinality=cardinality, base_width=base_width, compute_dtype=dt)
        if levels == 1:
            cls = _DLA_BLOCKS[block]
            self.tree1 = cls(in_channels, out_channels, stride, **bargs)
            self.tree2 = cls(out_channels, out_channels, 1, **bargs)
            self.root = _DlaRoot(root_dim, out_channels, root_residual, dt)
        else:
            self.tree1 = _DlaTree(levels - 1, block, in_channels, out_channels, stride,
                                  cardinality, base_width, root_dim=0,
                                  root_residual=root_residual, compute_dtype=dt)
            self.tree2 = _DlaTree(levels - 1, block, out_channels, out_channels, 1,
                                  cardinality, base_width, root_dim=root_dim + out_channels,
                                  root_residual=root_residual, compute_dtype=dt)
        self.project = (nn.Sequential(conv2d(in_channels, out_channels, 1, padding=0,
                                             compute_dtype=dt),
                                      batch_norm(out_channels, compute_dtype=dt))
                        if in_channels != out_channels else None)

    def forward(self, x, children: Optional[list] = None):
        children = [] if children is None else children
        bottom = F.max_pool2d(x, self.stride, self.stride) if self.stride > 1 else x
        res = bottom if self.project is None else self.project(bottom)
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            x1 = self.tree1(x, res)
            x2 = self.tree2(x1)
            return self.root([x2, x1] + children)
        x1 = self.tree1(x)
        children.append(x1)
        return self.tree2(x1, children)


def _conv_level(in_chs: int, planes: int, convs: int, stride: int, dt) -> nn.Sequential:
    """timm's ``_make_conv_level``: [conv, bn, relu] x convs (dla.py:292-301)."""
    mods = []
    for i in range(convs):
        mods += [conv2d(in_chs if i == 0 else planes, planes, 3, stride=stride if i == 0 else 1,
                        padding=1, compute_dtype=dt),
                 batch_norm(planes, compute_dtype=dt), _Relu()]
    return nn.Sequential(*mods)


class DLA(nn.Module):
    """DLA (``timm/models/dla.py:257-330``). ``num_classes=0`` builds no
    ``fc``; ``features_only`` returns level5's map."""

    def __init__(self, levels: Sequence[int] = (1, 1, 1, 2, 2, 1),
                 channels: Sequence[int] = (16, 32, 64, 128, 256, 512), block: str = "basic",
                 cardinality: int = 1, base_width: int = 64, residual_root: bool = False,
                 num_classes: int = 1000, in_chans: int = 3, drop_rate: float = 0.0,
                 mnist_stem: bool = False, compute_dtype=None):
        super().__init__()
        del mnist_stem  # the JAX family takes and ignores it
        dt = compute_dtype
        ch = channels
        self.drop_rate = drop_rate
        self.base_layer = nn.Sequential(conv2d(in_chans, ch[0], 7, padding=3, compute_dtype=dt),
                                        batch_norm(ch[0], compute_dtype=dt), _Relu())
        self.level0 = _conv_level(ch[0], ch[0], levels[0], 1, dt)
        self.level1 = _conv_level(ch[0], ch[1], levels[1], 2, dt)
        targs = dict(block=block, cardinality=cardinality, base_width=base_width,
                     root_residual=residual_root, compute_dtype=dt)
        for i in range(2, 6):
            self.add_module(f"level{i}", _DlaTree(levels[i], in_channels=ch[i - 1],
                                                  out_channels=ch[i], stride=2,
                                                  level_root=i > 2, **targs))
        self.num_features = ch[5]
        self.fc = (Conv2d(ch[5], num_classes, 1, bias=True, compute_dtype=dt)
                   if num_classes > 0 else None)

    def forward(self, x: torch.Tensor, features_only: bool = False) -> torch.Tensor:
        x = self.level1(self.level0(self.base_layer(x)))
        for i in range(2, 6):
            x = getattr(self, f"level{i}")(x)
        return x if features_only else self.forward_head(x)

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        """The class scores of a ``features_only`` map: pool and the 1x1 conv."""
        pooled = head_dropout(x.mean(dim=(2, 3), keepdim=True), self.drop_rate, self.training)
        return self.fc(pooled).flatten(1)


def _dla(num_classes, in_chans, kw, **cfg):
    return DLA(num_classes=num_classes, in_chans=in_chans, **cfg, **kw)


_WIDE = (16, 32, 128, 256, 512, 1024)
_NARROW = (16, 32, 64, 64, 128, 256)


@register_model
def dla34(num_classes=1000, in_chans=3, **kw):
    return _dla(num_classes, in_chans, kw, levels=(1, 1, 1, 2, 2, 1),
                channels=(16, 32, 64, 128, 256, 512), block="basic")


@register_model
def dla46_c(num_classes=1000, in_chans=3, **kw):
    return _dla(num_classes, in_chans, kw, levels=(1, 1, 1, 2, 2, 1), channels=_NARROW,
                block="bottleneck")


@register_model
def dla60(num_classes=1000, in_chans=3, **kw):
    return _dla(num_classes, in_chans, kw, levels=(1, 1, 1, 2, 3, 1), channels=_WIDE,
                block="bottleneck")


@register_model
def dla102(num_classes=1000, in_chans=3, **kw):
    return _dla(num_classes, in_chans, kw, levels=(1, 1, 1, 3, 4, 1), channels=_WIDE,
                block="bottleneck", residual_root=True)


@register_model
def dla60_res2net(num_classes=1000, in_chans=3, **kw):
    return _dla(num_classes, in_chans, kw, levels=(1, 1, 1, 2, 3, 1), channels=_WIDE,
                block="bottle2neck", cardinality=1, base_width=28)


@register_model
def dla60_res2next(num_classes=1000, in_chans=3, **kw):
    return _dla(num_classes, in_chans, kw, levels=(1, 1, 1, 2, 3, 1), channels=_WIDE,
                block="bottle2neck", cardinality=8, base_width=4)


@register_model
def dla46x_c(num_classes=1000, in_chans=3, **kw):
    """DLA-X-46-C (timm/models/dla.py:381-389)."""
    return _dla(num_classes, in_chans, kw, levels=(1, 1, 1, 2, 2, 1), channels=_NARROW,
                block="bottleneck", cardinality=32, base_width=4)


@register_model
def dla60x_c(num_classes=1000, in_chans=3, **kw):
    """DLA-X-60-C (dla.py:393-401)."""
    return _dla(num_classes, in_chans, kw, levels=(1, 1, 1, 2, 3, 1), channels=_NARROW,
                block="bottleneck", cardinality=32, base_width=4)


@register_model
def dla60x(num_classes=1000, in_chans=3, **kw):
    """DLA-X-60 (dla.py:416-424)."""
    return _dla(num_classes, in_chans, kw, levels=(1, 1, 1, 2, 3, 1), channels=_WIDE,
                block="bottleneck", cardinality=32, base_width=4)


@register_model
def dla102x(num_classes=1000, in_chans=3, **kw):
    """DLA-X-102 (dla.py:440-448)."""
    return _dla(num_classes, in_chans, kw, levels=(1, 1, 1, 3, 4, 1), channels=_WIDE,
                block="bottleneck", cardinality=32, base_width=4, residual_root=True)


@register_model
def dla102x2(num_classes=1000, in_chans=3, **kw):
    """DLA-X-102 64 (dla.py:452-460)."""
    return _dla(num_classes, in_chans, kw, levels=(1, 1, 1, 3, 4, 1), channels=_WIDE,
                block="bottleneck", cardinality=64, base_width=4, residual_root=True)


@register_model
def dla169(num_classes=1000, in_chans=3, **kw):
    """DLA-169 (dla.py:464-472)."""
    return _dla(num_classes, in_chans, kw, levels=(1, 1, 2, 3, 5, 1), channels=_WIDE,
                block="bottleneck", residual_root=True)
