"""The VoVNet v2 family in NCHW (counterpart of ``scouter_tpu/models/vovnet.py``,
after ``timm/models/vovnet.py``).

An OSA block is ``layer_per_block`` 3x3 ConvNormActs in sequence, their
outputs and the block's input concatenated and fused by a 1x1 ConvNormAct,
with an identity residual after a stage's first block and an eSE or ECA
gate on its last (vovnet.py:179-225, se.py:27-40); stages downsample with a
ceil-mode 3x3/2 max pool (:227-251); the stem is three ConvNormActs at
stride 4 (:291-298). The norm+act is BatchNorm and ReLU, InplaceABN's
BatchNorm and leaky ReLU 0.01 ('iabn'), or EvoNormSample2d ('evos'), which
acts itself. Module names are timm's (``stem.0.conv``, ``stages.0.blocks.
0.conv_mid.0.conv``, ``stages.1.blocks.0.attn.fc``, ``head.fc``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (Conv2d, Eca, Linear, batch_norm, conv2d, global_avg_pool, head_dropout,
                     head_dtype, norm_act)
from .registry import register_model
from .senet import max_pool_3x3_s2_ceil

__all__ = ["VovNet"]


class EvoNormSample2d(nn.Module):
    """EvoNormSample2d (``timm/models/layers/evo_norm.py:53-85``): grouped
    sample statistics with a built-in sigmoid gate. It keeps the vendored
    version's quirk: it normalises sigmoid(x * v), not x * sigmoid(x * v).
    ``weight``, ``bias`` and ``v`` are timm's (1, C, 1, 1) and start at
    ones, zeros and ones."""

    def __init__(self, num_features: int, groups: int = 8, eps: float = 1e-5):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(1, num_features, 1, 1))
        self.bias = nn.Parameter(torch.zeros(1, num_features, 1, 1))
        self.v = nn.Parameter(torch.ones(1, num_features, 1, 1))

    def forward(self, x):
        b, c, h, w = x.shape
        # the group statistics over (C / g, H, W), torch's view(B, g, -1)
        var = x.reshape(b, self.groups, -1).var(dim=-1, unbiased=False)
        std = (var + self.eps).sqrt().repeat_interleave(c // self.groups, dim=1)
        n = torch.sigmoid(x * self.v)
        return n / std[:, :, None, None] * self.weight + self.bias


class _ConvNormAct(nn.Module):
    """The conv and its norm+act; with ``depthwise``, a depthwise conv
    ``conv_dw`` and a pointwise ``conv_pw`` before it (SeparableConvNormAct)."""

    def __init__(self, in_chs: int, out_chs: int, kernel_size: int = 3, stride: int = 1,
                 norm: str = "bn", depthwise: bool = False, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.kind = norm
        if depthwise:
            self.conv_dw = conv2d(in_chs, in_chs, kernel_size, stride=stride, groups=in_chs,
                                  compute_dtype=dt)
            self.conv_pw = conv2d(in_chs, out_chs, 1, padding=0, compute_dtype=dt)
            self.conv = None
        else:
            self.conv = conv2d(in_chs, out_chs, kernel_size, stride=stride, compute_dtype=dt)
        self.bn = (EvoNormSample2d(out_chs) if norm == "evos"
                   else batch_norm(out_chs, compute_dtype=dt))

    def forward(self, x):
        x = self.conv(x) if self.conv is not None else self.conv_pw(self.conv_dw(x))
        x = self.bn(x)
        return x if self.kind == "evos" else norm_act(self.kind, x)


class _Ese(nn.Module):
    """Effective SE (``layers/se.py:27-40``): global average -> fc (bias) ->
    hard sigmoid gate. ``fc`` is a flax ``nn.Conv`` in JAX: plain
    ``Conv2d`` (LeCun init, no conv policy). ``in_channels`` is the gated
    tensor's width where it is not ``channels``."""

    def __init__(self, channels: int, in_channels: Optional[int] = None, compute_dtype=None):
        super().__init__()
        self.fc = Conv2d(in_channels or channels, channels, 1, bias=True,
                         compute_dtype=compute_dtype)

    def forward(self, x):
        s = self.fc(x.mean(dim=(2, 3), keepdim=True))
        return x * (F.relu6(s + 3.0) / 6.0)


class _OsaBlock(nn.Module):
    def __init__(self, in_chs: int, mid_chs: int, out_chs: int, layer_per_block: int,
                 residual: bool = False, depthwise: bool = False, attn: str = "",
                 norm: str = "bn", compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.residual = residual
        self.conv_reduction = (_ConvNormAct(in_chs, mid_chs, 1, norm=norm, compute_dtype=dt)
                               if depthwise and in_chs != mid_chs else None)
        chs = mid_chs if self.conv_reduction is not None else in_chs
        mids = []
        for _ in range(layer_per_block):
            mids.append(_ConvNormAct(chs, mid_chs, 3, norm=norm, depthwise=depthwise,
                                     compute_dtype=dt))
            chs = mid_chs
        self.conv_mid = nn.Sequential(*mids)
        self.conv_concat = _ConvNormAct(in_chs + layer_per_block * mid_chs, out_chs, 1,
                                        norm=norm, compute_dtype=dt)
        if attn == "ese":
            self.attn = _Ese(out_chs, compute_dtype=dt)
        elif attn == "eca":
            self.attn = Eca(out_chs, compute_dtype=dt)
        else:
            self.attn = None

    def forward(self, x):
        inp = x
        feats = [inp]  # the block's input joins the concat (vovnet.py:214-218)
        if self.conv_reduction is not None:
            x = self.conv_reduction(x)
        for conv in self.conv_mid:
            x = conv(x)
            feats.append(x)
        x = self.conv_concat(torch.cat(feats, dim=1))
        if self.attn is not None:
            x = self.attn(x)
        if self.residual:
            x = x + inp  # a plain add in JAX's block, which no hook reaches
        return x


class _OsaStage(nn.Module):
    def __init__(self, in_chs: int, conv_chs: int, out_chs: int, block_per_stage: int,
                 layer_per_block: int, downsample: bool, residual: bool, depthwise: bool,
                 attn: str, norm: str = "bn", compute_dtype=None):
        super().__init__()
        self.downsample = downsample
        blocks = []
        for b in range(block_per_stage):
            last = b == block_per_stage - 1
            blocks.append(_OsaBlock(in_chs if b == 0 else out_chs, conv_chs, out_chs,
                                    layer_per_block, residual=residual and b > 0,
                                    depthwise=depthwise, attn=attn if last else "", norm=norm,
                                    compute_dtype=compute_dtype))
        self.blocks = nn.Sequential(*blocks)

    def forward(self, x):
        if self.downsample:
            x = max_pool_3x3_s2_ceil(x)
        return self.blocks(x)


class _Head(nn.Module):
    def __init__(self, in_chs: int, num_classes: int, compute_dtype=None):
        super().__init__()
        self.fc = Linear(in_chs, num_classes, compute_dtype=head_dtype(compute_dtype))


class VovNet(nn.Module):
    """VoVNet (``timm/models/vovnet.py:254-320``). ``num_classes=0`` builds
    no head; ``features_only`` returns the last stage's map."""

    def __init__(self, stem_chs: Sequence[int] = (64, 64, 128),
                 stage_conv_chs: Sequence[int] = (128, 160, 192, 224),
                 stage_out_chs: Sequence[int] = (256, 512, 768, 1024), layer_per_block: int = 5,
                 block_per_stage: Sequence[int] = (1, 1, 2, 2), residual: bool = True,
                 depthwise: bool = False, attn: str = "ese", norm: str = "bn",
                 num_classes: int = 1000, in_chans: int = 3, drop_rate: float = 0.0,
                 mnist_stem: bool = False, compute_dtype=None):
        super().__init__()
        del mnist_stem  # the JAX family takes and ignores it
        dt = compute_dtype
        self.drop_rate = drop_rate
        self.stem = nn.Sequential(
            _ConvNormAct(in_chans, stem_chs[0], 3, stride=2, norm=norm, compute_dtype=dt),
            _ConvNormAct(stem_chs[0], stem_chs[1], 3, norm=norm, depthwise=depthwise,
                         compute_dtype=dt),
            _ConvNormAct(stem_chs[1], stem_chs[2], 3, stride=2, norm=norm, depthwise=depthwise,
                         compute_dtype=dt))
        prev, stages = stem_chs[2], []
        for i in range(4):
            stages.append(_OsaStage(prev, stage_conv_chs[i], stage_out_chs[i], block_per_stage[i],
                                    layer_per_block, downsample=i > 0, residual=residual,
                                    depthwise=depthwise, attn=attn, norm=norm, compute_dtype=dt))
            prev = stage_out_chs[i]
        self.stages = nn.Sequential(*stages)
        self.num_features = prev
        self.head = _Head(prev, num_classes, dt) if num_classes > 0 else None

    def forward(self, x: torch.Tensor, features_only: bool = False) -> torch.Tensor:
        x = self.stages(self.stem(x))
        return x if features_only else self.forward_head(x)

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        """The class scores of a ``features_only`` map."""
        return self.head.fc(head_dropout(global_avg_pool(x), self.drop_rate, self.training))


def _vov(num_classes, in_chans, kw, **cfg):
    return VovNet(num_classes=num_classes, in_chans=in_chans, **cfg, **kw)


_SLIM = dict(stage_conv_chs=(64, 80, 96, 112), stage_out_chs=(112, 256, 384, 512))


@register_model
def vovnet39a(num_classes=1000, in_chans=3, **kw):
    return _vov(num_classes, in_chans, kw, residual=False, attn="")


@register_model
def vovnet57a(num_classes=1000, in_chans=3, **kw):
    return _vov(num_classes, in_chans, kw, block_per_stage=(1, 1, 4, 3), residual=False,
                attn="")


@register_model
def ese_vovnet19b(num_classes=1000, in_chans=3, **kw):
    return _vov(num_classes, in_chans, kw, layer_per_block=3, block_per_stage=(1, 1, 1, 1))


@register_model
def ese_vovnet19b_dw(num_classes=1000, in_chans=3, **kw):
    return _vov(num_classes, in_chans, kw, stem_chs=(64, 64, 64), layer_per_block=3,
                block_per_stage=(1, 1, 1, 1), depthwise=True)


@register_model
def ese_vovnet39b(num_classes=1000, in_chans=3, **kw):
    return _vov(num_classes, in_chans, kw)


@register_model
def ese_vovnet57b(num_classes=1000, in_chans=3, **kw):
    return _vov(num_classes, in_chans, kw, block_per_stage=(1, 1, 4, 3))


@register_model
def ese_vovnet99b(num_classes=1000, in_chans=3, **kw):
    return _vov(num_classes, in_chans, kw, block_per_stage=(1, 3, 9, 3))


@register_model
def eca_vovnet39b(num_classes=1000, in_chans=3, **kw):
    """VoVNet-39b with ECA attention (vovnet.py:124-133, :400-401)."""
    return _vov(num_classes, in_chans, kw, attn="eca")


@register_model
def ese_vovnet19b_slim(num_classes=1000, in_chans=3, **kw):
    """Slim V2-19 (vovnet.py:72-80)."""
    return _vov(num_classes, in_chans, kw, layer_per_block=3, block_per_stage=(1, 1, 1, 1),
                **_SLIM)


@register_model
def ese_vovnet19b_slim_dw(num_classes=1000, in_chans=3, **kw):
    """Slim depthwise V2-19 (vovnet.py:51-59): dw stem convs + dw OSA convs."""
    return _vov(num_classes, in_chans, kw, stem_chs=(64, 64, 64), layer_per_block=3,
                block_per_stage=(1, 1, 1, 1), depthwise=True, **_SLIM)


@register_model
def ese_vovnet39b_evos(num_classes=1000, in_chans=3, **kw):
    """V2-39 with EvoNormSample norm-act (vovnet.py:135, :406-410)."""
    return _vov(num_classes, in_chans, kw, norm="evos")


@register_model
def ese_vovnet99b_iabn(num_classes=1000, in_chans=3, **kw):
    """V2-99 with Inplace-ABN norm-act (vovnet.py:136, :412-415)."""
    return _vov(num_classes, in_chans, kw, block_per_stage=(1, 3, 9, 3), norm="iabn")
