"""Dual Path Networks in NCHW (counterpart of ``scouter_tpu/models/dpn.py``,
after ``timm/models/dpn.py:52-355``).

Pre-activation BnActConv units (BatchNorm eps 1e-3, ReLU, conv)
(:74-83); a dual-path block keeps a residual lane of fixed width and a
dense lane that grows by ``inc`` a block, with a 1x1 -> grouped 3x3 -> 1x1
body and a projection on 'proj' and 'down' blocks (:104-187); the 'b'
variant ends its body in a BatchNorm + ReLU named ``c1x1_c`` and two
parallel 1x1 convs (:137-140); the stem is a conv, BatchNorm, ReLU and a
3x3/2 max pool (:86-101); the features end in BatchNorm + ELU
(``conv5_bn_ac``, :193, 247) and the head is a 1x1 conv with a bias named
``classifier`` over the pooled map (:247-275). Module names are timm's
(``features.conv2_1.c1x1_a.bn``, ``features.conv5_bn_ac.bn``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import act
from .layers import Conv2d, batch_norm, conv2d, head_dropout, max_pool_3x3_s2_p1
from .registry import register_model

__all__ = ["DPN"]


def _bn(chs: int, compute_dtype=None):
    return batch_norm(chs, eps=1e-3, compute_dtype=compute_dtype)


class _BnActConv(nn.Module):
    def __init__(self, in_chs: int, out_chs: int, kernel_size: int, stride: int,
                 padding: int = 0, groups: int = 1, compute_dtype=None):
        super().__init__()
        self.bn = _bn(in_chs, compute_dtype)
        self.conv = conv2d(in_chs, out_chs, kernel_size, stride=stride, padding=padding,
                           groups=groups, compute_dtype=compute_dtype)

    def forward(self, x):
        return self.conv(act.relu(self.bn(x)))


class _InputBlock(nn.Module):
    def __init__(self, in_chans: int, features: int, kernel_size: int, padding: int,
                 compute_dtype=None):
        super().__init__()
        self.conv = conv2d(in_chans, features, kernel_size, stride=2, padding=padding,
                           compute_dtype=compute_dtype)
        self.bn = _bn(features, compute_dtype)

    def forward(self, x):
        return max_pool_3x3_s2_p1(act.relu(self.bn(self.conv(x))))


class _CatBnAct(nn.Module):
    """BatchNorm and ReLU, or ELU for the final ``conv5_bn_ac``."""

    def __init__(self, chs: int, elu: bool = False, compute_dtype=None):
        super().__init__()
        self.bn = _bn(chs, compute_dtype)
        self.elu = elu

    def forward(self, x):
        x = self.bn(x)
        return F.elu(x) if self.elu else act.relu(x)


class _DualPathBlock(nn.Module):
    def __init__(self, in_chs: int, num_1x1_a: int, num_3x3_b: int, num_1x1_c: int, inc: int,
                 groups: int, block_type: str = "normal", b: bool = False,
                 compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.num_1x1_c, self.b = num_1x1_c, b
        key_stride = 2 if block_type == "down" else 1
        # the projection's name says its stride: c1x1_w_s1 or c1x1_w_s2
        self.proj = (f"c1x1_w_s{key_stride}" if block_type in ("proj", "down") else None)
        if self.proj:
            self.add_module(self.proj, _BnActConv(in_chs, num_1x1_c + 2 * inc, 1, key_stride,
                                                  compute_dtype=dt))
        self.c1x1_a = _BnActConv(in_chs, num_1x1_a, 1, 1, compute_dtype=dt)
        self.c3x3_b = _BnActConv(num_1x1_a, num_3x3_b, 3, key_stride, padding=1, groups=groups,
                                 compute_dtype=dt)
        if b:
            self.c1x1_c = _CatBnAct(num_3x3_b, compute_dtype=dt)
            self.c1x1_c1 = conv2d(num_3x3_b, num_1x1_c, 1, padding=0, compute_dtype=dt)
            self.c1x1_c2 = conv2d(num_3x3_b, inc, 1, padding=0, compute_dtype=dt)
        else:
            self.c1x1_c = _BnActConv(num_3x3_b, num_1x1_c + inc, 1, 1, compute_dtype=dt)

    def forward(self, x: Tuple[torch.Tensor, torch.Tensor]):
        x_in = torch.cat(x, dim=1)
        c = self.num_1x1_c
        if self.proj:
            x_s = getattr(self, self.proj)(x_in)
            x_s1, x_s2 = x_s[:, :c], x_s[:, c:]
        else:
            x_s1, x_s2 = x
        out = self.c3x3_b(self.c1x1_a(x_in))
        if self.b:
            out = self.c1x1_c(out)
            out1, out2 = self.c1x1_c1(out), self.c1x1_c2(out)
        else:
            out = self.c1x1_c(out)
            out1, out2 = out[:, :c], out[:, c:]
        return x_s1 + out1, torch.cat([x_s2, out2], dim=1)


class DPN(nn.Module):
    """DPN (``timm/models/dpn.py:190-282``). ``num_classes=0`` builds no
    ``classifier``; ``features_only`` returns ``conv5_bn_ac``'s map."""

    def __init__(self, small: bool = False, num_init_features: int = 64, k_r: int = 96,
                 groups: int = 32, b: bool = False, k_sec: Sequence[int] = (3, 4, 20, 3),
                 inc_sec: Sequence[int] = (16, 32, 24, 128), num_classes: int = 1000,
                 in_chans: int = 3, drop_rate: float = 0.0, mnist_stem: bool = False,
                 compute_dtype=None):
        super().__init__()
        del mnist_stem  # the JAX family takes and ignores it
        dt = compute_dtype
        self.drop_rate = drop_rate
        bw_factor = 1 if small else 4
        k, p = (3, 1) if small else (7, 3)
        self.features = nn.ModuleDict()
        self.features["conv1_1"] = _InputBlock(in_chans, num_init_features, k, p, dt)
        resid, dense = num_init_features, 0
        for stage, (mult, depth, inc) in enumerate(zip((64, 128, 256, 512), k_sec, inc_sec),
                                                   start=2):
            bw = mult * bw_factor
            r = (k_r * bw) // (64 * bw_factor)
            for i in range(1, depth + 1):
                btype = "normal" if i > 1 else ("proj" if stage == 2 else "down")
                self.features[f"conv{stage}_{i}"] = _DualPathBlock(
                    resid + dense, r, r, bw, inc, groups, btype, b, dt)
                resid, dense = bw, (3 * inc if btype != "normal" else dense + inc)
        self.num_features = resid + dense
        self.features["conv5_bn_ac"] = _CatBnAct(self.num_features, elu=True, compute_dtype=dt)
        self.classifier = (Conv2d(self.num_features, num_classes, 1, bias=True,
                                  compute_dtype=dt) if num_classes > 0 else None)

    def forward(self, x: torch.Tensor, features_only: bool = False) -> torch.Tensor:
        blocks = list(self.features.values())
        x = blocks[0](x)
        pair = (x, x[:, :0])
        for block in blocks[1:-1]:
            pair = block(pair)
        x = blocks[-1](torch.cat(pair, dim=1))
        return x if features_only else self.forward_head(x)

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        """The class scores of a ``features_only`` map: the 1x1 classifier on
        the pooled map (``dpn.py:274-275``)."""
        pooled = head_dropout(x.mean(dim=(2, 3), keepdim=True), self.drop_rate, self.training)
        return self.classifier(pooled).flatten(1)


def _dpn(num_classes, in_chans, kw, **cfg):
    return DPN(num_classes=num_classes, in_chans=in_chans, **cfg, **kw)


@register_model
def dpn68(num_classes=1000, in_chans=3, **kw):
    return _dpn(num_classes, in_chans, kw, small=True, num_init_features=10, k_r=128,
                groups=32, k_sec=(3, 4, 12, 3), inc_sec=(16, 32, 32, 64))


@register_model
def dpn68b(num_classes=1000, in_chans=3, **kw):
    return _dpn(num_classes, in_chans, kw, small=True, num_init_features=10, k_r=128,
                groups=32, b=True, k_sec=(3, 4, 12, 3), inc_sec=(16, 32, 32, 64))


@register_model
def dpn92(num_classes=1000, in_chans=3, **kw):
    return _dpn(num_classes, in_chans, kw, num_init_features=64, k_r=96, groups=32,
                k_sec=(3, 4, 20, 3), inc_sec=(16, 32, 24, 128))


@register_model
def dpn98(num_classes=1000, in_chans=3, **kw):
    return _dpn(num_classes, in_chans, kw, num_init_features=96, k_r=160, groups=40,
                k_sec=(3, 6, 20, 3), inc_sec=(16, 32, 32, 128))


@register_model
def dpn131(num_classes=1000, in_chans=3, **kw):
    return _dpn(num_classes, in_chans, kw, num_init_features=128, k_r=160, groups=40,
                k_sec=(4, 8, 28, 3), inc_sec=(16, 32, 32, 128))


@register_model
def dpn107(num_classes=1000, in_chans=3, **kw):
    return _dpn(num_classes, in_chans, kw, num_init_features=128, k_r=200, groups=50,
                k_sec=(4, 8, 20, 3), inc_sec=(20, 64, 64, 128))
