"""The RegNet X/Y families in NCHW (counterpart of ``scouter_tpu/models/regnet.py``,
after ``timm/models/regnet.py``).

The widths come from (w0, wa, wm, depth) quantized to multiples of 8 and
adjusted to whole groups (regnet.py:98-122, 291-309); the blocks are grouped
bottlenecks at bottle ratio 1, with SE after conv2 in the Y models
(:124-171); the stem is one 3x3/2 ConvBnAct (:259). Module names are timm's
(``stem.conv``, ``s1.b1.conv1.bn``, ``s1.b1.se.fc1``, ``s1.b1.downsample.
conv``, ``head.fc``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from . import act
from .layers import (Conv2d, Linear, batch_norm, conv2d, global_avg_pool, head_dropout,
                     head_dtype)
from .registry import register_model

__all__ = ["RegNet"]


def _generate_widths(w0: float, wa: float, wm: float, depth: int, q: int = 8):
    widths_cont = np.arange(depth) * wa + w0
    width_exps = np.round(np.log(widths_cont / w0) / np.log(wm))
    widths = w0 * np.power(wm, width_exps)
    return (np.round(widths / q) * q).astype(int)


def _stage_params(w0, wa, wm, depth, group_w, bottle_ratio=1.0):
    """(depth, width, group width) of each stage, the group-compatibility
    adjustment applied (regnet.py:103-109)."""
    widths = _generate_widths(w0, wa, wm, depth)
    stage_widths, stage_depths = np.unique(widths, return_counts=True)
    ws, gs = [], []
    for w in stage_widths:
        w_bot = int(w * bottle_ratio)
        g = min(group_w, w_bot)
        w_bot = int(round(w_bot / g) * g)
        ws.append(int(w_bot / bottle_ratio))
        gs.append(g)
    return list(zip(stage_depths.tolist(), ws, gs))


class _ConvBnAct(nn.Module):
    def __init__(self, in_chs: int, out_chs: int, kernel_size: int = 3, stride: int = 1,
                 groups: int = 1, apply_act: bool = True, compute_dtype=None):
        super().__init__()
        self.apply_act = apply_act
        self.conv = conv2d(in_chs, out_chs, kernel_size, stride=stride, groups=groups,
                           compute_dtype=compute_dtype)
        self.bn = batch_norm(out_chs, compute_dtype=compute_dtype)

    def forward(self, x):
        x = self.bn(self.conv(x))
        return act.relu(x) if self.apply_act else x


class _SE(nn.Module):
    """fc1/fc2 are flax ``nn.Conv`` in JAX: plain ``Conv2d`` (LeCun init)."""

    def __init__(self, channels: int, reduction_channels: int, compute_dtype=None):
        super().__init__()
        self.fc1 = Conv2d(channels, reduction_channels, 1, bias=True,
                          compute_dtype=compute_dtype)
        self.fc2 = Conv2d(reduction_channels, channels, 1, bias=True,
                          compute_dtype=compute_dtype)

    def forward(self, x):
        s = self.fc2(act.relu(self.fc1(x.mean(dim=(2, 3), keepdim=True))))
        return x * torch.sigmoid(s)


class _Block(nn.Module):
    def __init__(self, in_chs: int, out_chs: int, stride: int, bottle_ratio: float,
                 group_width: int, se_ratio: float, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        bottleneck = int(round(out_chs * bottle_ratio))
        groups = bottleneck // group_width
        self.conv1 = _ConvBnAct(in_chs, bottleneck, 1, compute_dtype=dt)
        self.conv2 = _ConvBnAct(bottleneck, bottleneck, 3, stride=stride, groups=groups,
                                compute_dtype=dt)
        self.se = (_SE(bottleneck, int(round(in_chs * se_ratio)), dt) if se_ratio else None)
        self.conv3 = _ConvBnAct(bottleneck, out_chs, 1, apply_act=False, compute_dtype=dt)
        self.downsample = (_ConvBnAct(in_chs, out_chs, 1, stride=stride, apply_act=False,
                                      compute_dtype=dt)
                           if in_chs != out_chs or stride != 1 else None)

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        if self.se is not None:
            out = self.se(out)
        out = self.conv3(out)
        shortcut = x if self.downsample is None else self.downsample(x)
        # a plain add in JAX's block, which no hook reaches
        return act.relu(out + shortcut)


class _Head(nn.Module):
    def __init__(self, in_chs: int, num_classes: int, compute_dtype=None):
        super().__init__()
        self.fc = Linear(in_chs, num_classes, compute_dtype=head_dtype(compute_dtype))


class RegNet(nn.Module):
    """RegNet (``timm/models/regnet.py:236-330``): stem, stages s1..s4 of
    blocks b1.., head. ``num_classes=0`` builds no head."""

    def __init__(self, w0: float = 24, wa: float = 36.44, wm: float = 2.49, depth: int = 13,
                 group_w: int = 8, se_ratio: float = 0.0, bottle_ratio: float = 1.0,
                 stem_width: int = 32, num_classes: int = 1000, in_chans: int = 3,
                 drop_rate: float = 0.0, mnist_stem: bool = False, compute_dtype=None):
        super().__init__()
        del mnist_stem  # the JAX family takes and ignores it
        dt = compute_dtype
        self.drop_rate = drop_rate
        self.stem = _ConvBnAct(in_chans, stem_width, 3, stride=2, compute_dtype=dt)
        prev = stem_width
        params = _stage_params(w0, wa, wm, depth, group_w, bottle_ratio)
        self.num_stages = len(params)
        for i, (d, w, g) in enumerate(params, start=1):
            stage = nn.Module()
            for j in range(d):
                stage.add_module(f"b{j + 1}", _Block(prev if j == 0 else w, w, 2 if j == 0 else 1,
                                                     bottle_ratio, g, se_ratio, dt))
            self.add_module(f"s{i}", stage)
            prev = w
        self.num_features = prev
        self.head = _Head(prev, num_classes, dt) if num_classes > 0 else None

    def forward(self, x: torch.Tensor, features_only: bool = False) -> torch.Tensor:
        x = self.stem(x)
        for i in range(1, self.num_stages + 1):
            for block in getattr(self, f"s{i}").children():
                x = block(x)
        return x if features_only else self.forward_head(x)

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        """The class scores of a ``features_only`` map."""
        return self.head.fc(head_dropout(global_avg_pool(x), self.drop_rate, self.training))


_REGNET_CFGS = {
    "regnetx_002": dict(w0=24, wa=36.44, wm=2.49, group_w=8, depth=13),
    "regnetx_004": dict(w0=24, wa=24.48, wm=2.54, group_w=16, depth=22),
    "regnetx_006": dict(w0=48, wa=36.97, wm=2.24, group_w=24, depth=16),
    "regnetx_008": dict(w0=56, wa=35.73, wm=2.28, group_w=16, depth=16),
    "regnetx_016": dict(w0=80, wa=34.01, wm=2.25, group_w=24, depth=18),
    "regnetx_032": dict(w0=88, wa=26.31, wm=2.25, group_w=48, depth=25),
    "regnetx_040": dict(w0=96, wa=38.65, wm=2.43, group_w=40, depth=23),
    "regnetx_064": dict(w0=184, wa=60.83, wm=2.07, group_w=56, depth=17),
    "regnetx_080": dict(w0=80, wa=49.56, wm=2.88, group_w=120, depth=23),
    "regnetx_120": dict(w0=168, wa=73.36, wm=2.37, group_w=112, depth=19),
    "regnetx_160": dict(w0=216, wa=55.59, wm=2.1, group_w=128, depth=22),
    "regnetx_320": dict(w0=320, wa=69.86, wm=2.0, group_w=168, depth=23),
    "regnety_002": dict(w0=24, wa=36.44, wm=2.49, group_w=8, depth=13, se_ratio=0.25),
    "regnety_004": dict(w0=48, wa=27.89, wm=2.09, group_w=8, depth=16, se_ratio=0.25),
    "regnety_006": dict(w0=48, wa=32.54, wm=2.32, group_w=16, depth=15, se_ratio=0.25),
    "regnety_008": dict(w0=56, wa=38.84, wm=2.4, group_w=16, depth=14, se_ratio=0.25),
    "regnety_016": dict(w0=48, wa=20.71, wm=2.65, group_w=24, depth=27, se_ratio=0.25),
    "regnety_032": dict(w0=80, wa=42.63, wm=2.66, group_w=24, depth=21, se_ratio=0.25),
    "regnety_040": dict(w0=96, wa=31.41, wm=2.24, group_w=64, depth=22, se_ratio=0.25),
    "regnety_064": dict(w0=112, wa=33.22, wm=2.27, group_w=72, depth=25, se_ratio=0.25),
    "regnety_080": dict(w0=192, wa=76.82, wm=2.19, group_w=56, depth=17, se_ratio=0.25),
    "regnety_120": dict(w0=168, wa=73.36, wm=2.37, group_w=112, depth=19, se_ratio=0.25),
    "regnety_160": dict(w0=200, wa=106.23, wm=2.48, group_w=112, depth=18, se_ratio=0.25),
    "regnety_320": dict(w0=232, wa=115.89, wm=2.53, group_w=232, depth=20, se_ratio=0.25),
}


def _make_entry(name, cfg):
    def entry(num_classes=1000, in_chans=3, **kw):
        return RegNet(num_classes=num_classes, in_chans=in_chans, **cfg, **kw)

    entry.__name__ = name
    return register_model(entry)


for _name, _cfg in _REGNET_CFGS.items():
    _make_entry(_name, _cfg)
