"""The ResNet family in NCHW (counterpart of ``scouter_tpu/models/resnet.py``).

One configurable ``ResNet`` after timm's universal ResNet
(``timm/models/resnet.py:309-509``): the stems '' (7x7), 'deep',
'deep_tiered' and 'deep_tiered_narrow', the MNIST stem, avg_down skips,
output strides 32, 16 and 8 (dilated stages), anti-aliasing, a
space-to-depth stem conv and pruned widths, over six block kinds: basic and
bottleneck (``resnet.py:142-275``, with ``extra_layers.create_attn``'s
gates), ResNeSt's split-attention bottleneck (``resnest.py:58-143``), Res2Net's
(``res2net.py:47-130``) and the selective-kernel blocks (``sknet.py:45-137``).
Module names are timm's (conv1, bn1, layer2.0, downsample.1, layer3.1.se.fc1,
conv2.paths.0.conv, convs.2, ...), so ``state_dict()`` carries the
reference's keys.

The blocks' ReLUs and residual adds go through ``act.relu`` and
``act.residual_add`` where the JAX package's call its ``act``'s, so the
attribution methods can swap their rules in (``models/act.py``).

PyTorch modules are built with their input widths, which flax infers from
the data: each block takes the width of the tensor before it, which a
pruned table may make differ from the unpruned count that decides the skip
projections.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import act
from .extra_layers import create_attn
from .layers import (
    Conv2d,
    Linear,
    SpaceToDepthStemConv,
    SplitAttnConv,
    avg_pool_ceil_exclude_pad,
    avg_pool_include_pad,
    avg_pool_same_zero_pad,
    batch_norm,
    blur_pool,
    conv2d,
    global_avg_pool,
    head_dropout,
    max_pool_3x3_s2_p1,
)
from .pruned import WidthOverrides, scope_widths, width_of

__all__ = ["ResNet", "BlockKind"]

BlockKind = str  # 'basic' | 'bottleneck' | 'resnest' | 'res2net' | 'sk_basic' | 'sk_bottleneck'

_EXPANSION = {"basic": 1, "bottleneck": 4, "resnest": 4, "res2net": 4,
              "sk_basic": 1, "sk_bottleneck": 4}


class _Relu(nn.Module):
    """The deep stem's ReLU module (timm's ``conv1.2``/``conv1.5``) through
    ``act.relu``, as the JAX package's stem calls it."""

    def forward(self, x):
        return act.relu(x)


class _SkipPool(nn.Module):
    """The pool at index 0 of an avg-path skip: ceil-mode exclude-pad at the
    block's stride, or on a dilated stage the SAME-zero-padded pool at
    stride 1 (``resnet.py:292-306``)."""

    def __init__(self, stride: int, same_zero_pad: bool):
        super().__init__()
        self.stride, self.same_zero_pad = stride, same_zero_pad

    def forward(self, x):
        if self.same_zero_pad:
            return avg_pool_same_zero_pad(x, 2, 1)
        return avg_pool_ceil_exclude_pad(x, 2, self.stride)


def _downsample(in_channels: int, out_channels: int, stride: int, avg_down: bool,
                kernel_size: int = 1, dilation: int = 1, first_dilation: int = 0,
                compute_dtype=None) -> nn.Sequential:
    """Skip projection with timm's Sequential indices: conv path
    [conv(0), bn(1)]; avg path [pool(0), conv(1), bn(2)]
    (``timm/models/resnet.py:277-306``)."""
    dt = compute_dtype
    if avg_down:
        if stride == 1 and dilation == 1:
            pool = nn.Identity()
        else:
            pool = _SkipPool(stride if dilation == 1 else 1, same_zero_pad=dilation > 1)
        return nn.Sequential(pool, conv2d(in_channels, out_channels, 1, padding=0,
                                          compute_dtype=dt),
                             batch_norm(out_channels, compute_dtype=dt))
    # stride-1 undilated projections are 1x1 whatever down_kernel_size says
    k = 1 if (stride == 1 and dilation == 1) else kernel_size
    fd = (first_dilation or dilation) if k > 1 else 1
    pad = ((stride - 1) + fd * (k - 1)) // 2  # timm's get_padding
    return nn.Sequential(conv2d(in_channels, out_channels, k, stride=stride, padding=pad,
                                dilation=fd, compute_dtype=dt),
                         batch_norm(out_channels, compute_dtype=dt))


def _attn(attn: str, channels: int, in_channels: int, compute_dtype=None) -> Optional[nn.Module]:
    """timm's ``create_attn`` ('' | 'se' | 'eca' | 'ceca' | 'cbam' | 'lcbam' |
    'ese'), the module a block names ``se``; another kind raises ValueError.
    ``channels`` is the unpruned width (ECA's kernel size and SE's
    reduction follow it), ``in_channels`` the gated tensor's."""
    return create_attn(attn, channels, in_channels=in_channels, compute_dtype=compute_dtype)


class _Block(nn.Module):
    """What every block shares: the skip, the residual add and the last ReLU."""

    downsample: Optional[nn.Module]

    def residual(self, x):
        return x if self.downsample is None else self.downsample(x)


class _BasicBlock(_Block):
    """conv3x3(stride)-bn-relu-conv3x3-bn [-attn] [+proj] -relu
    (``resnet.py:142-199``)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 first_dilation: int = 1, reduce_first: int = 1,
                 has_downsample: bool = False, avg_down: bool = False,
                 down_kernel_size: int = 1, attn: str = "", aa: bool = False,
                 compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        first_planes = planes // reduce_first
        self.conv1 = conv2d(inplanes, first_planes, 3, stride=1 if aa else stride,
                            padding=first_dilation, dilation=first_dilation, compute_dtype=dt)
        self.bn1 = batch_norm(first_planes, compute_dtype=dt)
        self.blur = aa and stride == 2
        self.conv2 = conv2d(first_planes, planes, 3, padding=dilation, dilation=dilation,
                            compute_dtype=dt)
        self.bn2 = batch_norm(planes, compute_dtype=dt)
        self.se = _attn(attn, planes, planes, dt)
        self.downsample = (_downsample(inplanes, planes, stride, avg_down, down_kernel_size,
                                       dilation, first_dilation, dt)
                           if has_downsample else None)
        self.out_channels = planes

    def forward(self, x):
        out = act.relu(self.bn1(self.conv1(x)))
        if self.blur:
            out = blur_pool(out, stride=2)
        out = self.bn2(self.conv2(out))
        if self.se is not None:
            out = self.se(out)
        return act.relu(act.residual_add(out, self.residual(x)))


class _Bottleneck(_Block):
    """1x1-bn-relu / 3x3(stride, groups)-bn-relu [-blur] / 1x1-bn [-attn]
    [+proj] -relu (``resnet.py:202-275``), at pruned ``widths`` where a
    table gives them."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 first_dilation: int = 1, cardinality: int = 1, base_width: int = 64,
                 reduce_first: int = 1, has_downsample: bool = False, avg_down: bool = False,
                 down_kernel_size: int = 1, attn: str = "", aa: bool = False,
                 widths: WidthOverrides = None, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        width = int(planes * (base_width / 64.0)) * cardinality
        outplanes = planes * 4
        c1 = width_of(widths, "conv1", width // reduce_first)
        c2 = width_of(widths, "conv2", width)
        c3 = width_of(widths, "conv3", outplanes)
        self.conv1 = conv2d(inplanes, c1, 1, padding=0, compute_dtype=dt)
        self.bn1 = batch_norm(c1, compute_dtype=dt)
        self.conv2 = conv2d(c1, c2, 3, stride=1 if aa else stride, padding=first_dilation,
                            dilation=first_dilation, groups=cardinality, compute_dtype=dt)
        self.bn2 = batch_norm(c2, compute_dtype=dt)
        self.blur = aa and stride == 2
        self.conv3 = conv2d(c2, c3, 1, padding=0, compute_dtype=dt)
        self.bn3 = batch_norm(c3, compute_dtype=dt)
        self.se = _attn(attn, outplanes, c3, dt)
        self.downsample = (_downsample(inplanes, c3, stride, avg_down, down_kernel_size,
                                       dilation, first_dilation, dt)
                           if has_downsample else None)
        self.out_channels = c3

    def forward(self, x):
        out = act.relu(self.bn1(self.conv1(x)))
        out = act.relu(self.bn2(self.conv2(out)))
        if self.blur:
            out = blur_pool(out, stride=2)
        out = self.bn3(self.conv3(out))
        if self.se is not None:
            out = self.se(out)
        return act.relu(act.residual_add(out, self.residual(x)))


class _ResNestBottleneck(_Block):
    """ResNeSt bottleneck: 1x1 / split-attn 3x3 (+avd pool) / 1x1 (resnest.py:58-143)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 first_dilation: int = 1, cardinality: int = 1, base_width: int = 64,
                 radix: int = 2, avd: bool = True, avd_first: bool = False,
                 has_downsample: bool = False, avg_down: bool = True, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        group_width = int(planes * (base_width / 64.0)) * cardinality
        outplanes = planes * 4
        # avd: the stride moves out of the 3x3 conv into a 3x3 avg pool
        if avd and stride > 1:
            self.avd_stride, conv_stride = stride, 1
        else:
            self.avd_stride, conv_stride = 0, stride
        self.avd_first = avd_first
        self.conv1 = conv2d(inplanes, group_width, 1, padding=0, compute_dtype=dt)
        self.bn1 = batch_norm(group_width, compute_dtype=dt)
        self.conv2 = SplitAttnConv(group_width, group_width, 3, stride=conv_stride,
                                   padding=first_dilation, dilation=first_dilation,
                                   groups=cardinality, radix=radix, compute_dtype=dt)
        self.conv3 = conv2d(group_width, outplanes, 1, padding=0, compute_dtype=dt)
        self.bn3 = batch_norm(outplanes, compute_dtype=dt)
        self.downsample = (_downsample(inplanes, outplanes, stride, avg_down,
                                       dilation=dilation, first_dilation=first_dilation,
                                       compute_dtype=dt)
                           if has_downsample else None)
        self.out_channels = outplanes

    def forward(self, x):
        out = act.relu(self.bn1(self.conv1(x)))
        if self.avd_stride and self.avd_first:
            out = avg_pool_include_pad(out, 3, self.avd_stride, 1)
        out = self.conv2(out)
        if self.avd_stride and not self.avd_first:
            out = avg_pool_include_pad(out, 3, self.avd_stride, 1)
        out = self.bn3(self.conv3(out))
        return act.relu(act.residual_add(out, self.residual(x)))


class _Res2NetBottleneck(_Block):
    """Res2Net's Bottle2neck (``timm/models/res2net.py:47-130``): the 3x3 conv
    split into ``scale`` width groups with hierarchical residuals; the last
    split passes through, average-pooled (include-pad) on a block's first
    unit."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 first_dilation: int = 1, cardinality: int = 1, base_width: int = 26,
                 scale: int = 4, has_downsample: bool = False, avg_down: bool = False,
                 compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        width = int(math.floor(planes * (base_width / 64.0))) * cardinality
        outplanes = planes * 4
        self.width, self.scale, self.stride = width, scale, stride
        self.is_first = stride > 1 or has_downsample
        self.conv1 = conv2d(inplanes, width * scale, 1, padding=0, compute_dtype=dt)
        self.bn1 = batch_norm(width * scale, compute_dtype=dt)
        n = max(1, scale - 1)
        self.convs = nn.ModuleList(
            conv2d(width, width, 3, stride=stride, padding=first_dilation,
                   dilation=first_dilation, groups=cardinality, compute_dtype=dt)
            for _ in range(n))
        self.bns = nn.ModuleList(batch_norm(width, compute_dtype=dt) for _ in range(n))
        self.conv3 = conv2d(width * scale, outplanes, 1, padding=0, compute_dtype=dt)
        self.bn3 = batch_norm(outplanes, compute_dtype=dt)
        self.downsample = (_downsample(inplanes, outplanes, stride, avg_down,
                                       dilation=dilation, first_dilation=first_dilation,
                                       compute_dtype=dt)
                           if has_downsample else None)
        self.out_channels = outplanes

    def forward(self, x):
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
        return act.relu(act.residual_add(out, self.residual(x)))


class _ConvBn(nn.Module):
    """ConvBnAct with timm's child names (conv, bn)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: Optional[int] = None, dilation: int = 1,
                 groups: int = 1, act: bool = True, compute_dtype=None):
        super().__init__()
        self.conv = conv2d(in_channels, out_channels, kernel_size, stride=stride,
                           padding=padding, dilation=dilation, groups=groups,
                           compute_dtype=compute_dtype)
        self.bn = batch_norm(out_channels, compute_dtype=compute_dtype)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return act.relu(x) if self.act else x


class _SKAttn(nn.Module):
    """SelectiveKernelAttn (``selective_kernel.py:20-47``): the path
    weights, a softmax over the paths. fc_reduce and fc_select are flax
    ``nn.Conv`` in the JAX package: plain ``Conv2d`` here, LeCun init, no
    conv policy."""

    def __init__(self, channels: int, num_paths: int, attn_channels: int, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.channels, self.num_paths = channels, num_paths
        self.fc_reduce = Conv2d(channels, attn_channels, 1, bias=False, compute_dtype=dt)
        self.bn = batch_norm(attn_channels, compute_dtype=dt)
        self.fc_select = Conv2d(attn_channels, channels * num_paths, 1, bias=False,
                                compute_dtype=dt)

    def forward(self, stacked):
        """stacked: (B, P, C, H, W) -> (B, P, C, 1, 1)."""
        s = stacked.sum(dim=1).mean(dim=(2, 3), keepdim=True)
        s = self.fc_select(act.relu(self.bn(self.fc_reduce(s))))
        s = s.view(s.shape[0], self.num_paths, self.channels, 1, 1)
        return torch.softmax(s, dim=1)


class _SKConv(nn.Module):
    """SelectiveKernelConv (``timm/models/layers/selective_kernel.py:50-117``):
    two 3x3 paths at dilation d and 2d (the nominal 3 and 5 kernels), mixed
    by the softmax path attention over their sum."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 dilation: int = 1, groups: int = 1, attn_reduction: int = 16,
                 min_attn_channels: int = 32, split_input: bool = False, compute_dtype=None):
        super().__init__()
        dilations = [dilation * (k - 1) // 2 for k in (3, 5)]  # keep_3x3
        num_paths = len(dilations)
        self.split = in_channels // num_paths if split_input else 0
        path_in = self.split or in_channels
        groups = min(out_channels, groups)
        self.paths = nn.ModuleList(
            _ConvBn(path_in, out_channels, 3, stride=stride, padding=d, dilation=d,
                    groups=groups, compute_dtype=compute_dtype) for d in dilations)
        attn_chs = max(int(out_channels / attn_reduction), min_attn_channels)
        self.attn = _SKAttn(out_channels, num_paths, attn_chs, compute_dtype)

    def forward(self, x):
        w = self.split
        paths = [p(x[:, i * w:(i + 1) * w] if w else x) for i, p in enumerate(self.paths)]
        stacked = torch.stack(paths, dim=1)  # (B, P, C, H, W)
        return (stacked * self.attn(stacked)).sum(dim=1)


class _SKBasicBlock(_Block):
    """SelectiveKernelBasic (``timm/models/sknet.py:45-89``)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 first_dilation: int = 1, sk_attn_reduction: int = 16,
                 sk_min_attn_channels: int = 32, sk_split_input: bool = False,
                 has_downsample: bool = False, avg_down: bool = False, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.conv1 = _SKConv(inplanes, planes, stride=stride, dilation=first_dilation,
                             attn_reduction=sk_attn_reduction,
                             min_attn_channels=sk_min_attn_channels,
                             split_input=sk_split_input, compute_dtype=dt)
        self.conv2 = _ConvBn(planes, planes, 3, padding=dilation, dilation=dilation,
                             act=False, compute_dtype=dt)
        self.downsample = (_downsample(inplanes, planes, stride, avg_down, dilation=dilation,
                                       first_dilation=first_dilation, compute_dtype=dt)
                           if has_downsample else None)
        self.out_channels = planes

    def forward(self, x):
        return act.relu(act.residual_add(self.conv2(self.conv1(x)), self.residual(x)))


class _SKBottleneck(_Block):
    """SelectiveKernelBottleneck (``timm/models/sknet.py:92-137``)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 first_dilation: int = 1, cardinality: int = 1, base_width: int = 64,
                 sk_attn_reduction: int = 16, sk_min_attn_channels: int = 32,
                 sk_split_input: bool = False, has_downsample: bool = False,
                 avg_down: bool = False, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        width = int(math.floor(planes * (base_width / 64)) * cardinality)
        outplanes = planes * 4
        self.conv1 = _ConvBn(inplanes, width, 1, padding=0, compute_dtype=dt)
        self.conv2 = _SKConv(width, width, stride=stride, dilation=first_dilation,
                             groups=cardinality, attn_reduction=sk_attn_reduction,
                             min_attn_channels=sk_min_attn_channels,
                             split_input=sk_split_input, compute_dtype=dt)
        self.conv3 = _ConvBn(width, outplanes, 1, padding=0, act=False, compute_dtype=dt)
        self.downsample = (_downsample(inplanes, outplanes, stride, avg_down,
                                       dilation=dilation, first_dilation=first_dilation,
                                       compute_dtype=dt)
                           if has_downsample else None)
        self.out_channels = outplanes

    def forward(self, x):
        return act.relu(act.residual_add(self.conv3(self.conv2(self.conv1(x))),
                                          self.residual(x)))


_BLOCKS = {
    "basic": _BasicBlock,
    "bottleneck": _Bottleneck,
    "resnest": _ResNestBottleneck,
    "res2net": _Res2NetBottleneck,
    "sk_basic": _SKBasicBlock,
    "sk_bottleneck": _SKBottleneck,
}


@dataclasses.dataclass(frozen=True)
class _StageSpec:
    planes: int
    blocks: int
    stride: int
    dilation: int


def _stage_specs(layers: Sequence[int], output_stride: int) -> Tuple[_StageSpec, ...]:
    """The stages' channels, strides and dilations (timm/models/resnet.py:428-437)."""
    channels = [64, 128, 256, 512]
    strides = [1, 2, 2, 2]
    dilations = [1, 1, 1, 1]
    if output_stride == 16:
        strides[3], dilations[3] = 1, 2
    elif output_stride == 8:
        strides[2:4], dilations[2:4] = [1, 1], [2, 4]
    elif output_stride != 32:
        raise ValueError(f"unsupported output_stride {output_stride}")
    return tuple(
        _StageSpec(c, n, s, d) for c, n, s, d in zip(channels, layers, strides, dilations)
    )


class ResNet(nn.Module):
    """Universal ResNet/ResNeXt/ResNeSt/Res2Net/SKNet (timm/models/resnet.py:309-509).

    ``block``: a ``BlockKind``. ``stem_type``: '' (7x7) | 'deep' |
    'deep_tiered' | 'deep_tiered_narrow' (three 3x3 convs), read as JAX
    reads it: 'deep' in it makes the three-conv stem, 'tiered' and
    'narrow' its widths.
    ``mnist_stem``: the stem conv becomes Conv(in_chans->64, 3x3, s2, p1), the
    reference's MNIST surgery (``sloter/slot_model.py:23-24``).
    ``s2d_stem``: the stem's first stride-2 conv runs through space-to-depth
    (``layers.SpaceToDepthStemConv``, the same products).
    ``aa``: BlurPool anti-aliasing in the stem and the strided blocks.
    ``drop_rate``: head dropout before ``fc`` in training, its mask drawn
    from torch's default generator, which the caller seeds. JAX folds the
    step count into the mask's rng, so a resumed run replays its masks; the
    port would need a generator handed in at each step for that, and no
    entry point of it sets ``drop_rate`` (the CLIs pass no
    ``backbone_kwargs``), so none is threaded through. ``layers.drop_path``
    takes one because JAX's is the identity without an rng.
    ``widths``: a pruned out-channel table (``pruned.load_pruned_widths``).
    ``compute_dtype``: the dtype the layers compute in over f32 parameters
    (flax's ``dtype``), or None for the parameters' own.
    """

    def __init__(self, block: BlockKind = "basic", layers: Sequence[int] = (2, 2, 2, 2),
                 num_classes: int = 1000, in_chans: int = 3, cardinality: int = 1,
                 base_width: int = 64, stem_width: int = 64, stem_type: str = "",
                 avg_down: bool = False, output_stride: int = 32, radix: int = 2,
                 avd: bool = True, avd_first: bool = False, attn: str = "", aa: bool = False,
                 reduce_first: int = 1, down_kernel_size: int = 1, scale: int = 4,
                 sk_attn_reduction: int = 16, sk_min_attn_channels: int = 32,
                 sk_split_input: bool = False, drop_rate: float = 0.0,
                 mnist_stem: bool = False, s2d_stem: bool = False,
                 widths: WidthOverrides = None, compute_dtype=None):
        super().__init__()
        if block not in _BLOCKS:
            raise ValueError(f"unknown block kind {block!r} (kinds: {sorted(_BLOCKS)})")
        self.block = block
        self.aa = aa
        self.drop_rate = drop_rate
        dt = compute_dtype
        deep_stem = "deep" in stem_type
        inplanes = stem_width * 2 if deep_stem else 64

        def stem_conv(cin, cout, k):
            if s2d_stem:
                return SpaceToDepthStemConv(cin, cout, k, compute_dtype=dt)
            return conv2d(cin, cout, k, stride=2, padding=(k - 1) // 2, compute_dtype=dt)

        if mnist_stem:
            inplanes = 64
            self.conv1 = stem_conv(in_chans, 64, 3)
            stem_out = 64
        elif deep_stem:
            if "tiered" in stem_type:
                chs_1 = 3 * (stem_width // 4)
                chs_2 = stem_width if "narrow" in stem_type else 6 * (stem_width // 4)
            else:
                chs_1 = chs_2 = stem_width
            w0 = width_of(widths, "conv1.0", chs_1)
            w3 = width_of(widths, "conv1.3", chs_2)
            stem_out = width_of(widths, "conv1.6", inplanes)
            self.conv1 = nn.Sequential(
                stem_conv(in_chans, w0, 3),
                batch_norm(w0, compute_dtype=dt), _Relu(),
                conv2d(w0, w3, 3, padding=1, compute_dtype=dt),
                batch_norm(w3, compute_dtype=dt), _Relu(),
                conv2d(w3, stem_out, 3, padding=1, compute_dtype=dt),
            )
        else:
            self.conv1 = stem_conv(in_chans, inplanes, 7)
            stem_out = inplanes
        self.bn1 = batch_norm(stem_out, compute_dtype=dt)

        expansion = _EXPANSION[block]
        current = inplanes  # the unpruned width: it decides the skip projections
        channels = stem_out  # the width of the tensor itself
        for stage_idx, spec in enumerate(_stage_specs(layers, output_stride), start=1):
            first_dilation = 1 if spec.dilation in (1, 2) else 2
            blocks = []
            for block_idx in range(spec.blocks):
                stride = spec.stride if block_idx == 0 else 1
                needs_ds = block_idx == 0 and (stride != 1 or current != spec.planes * expansion)
                current = spec.planes * expansion
                kw = dict(stride=stride, dilation=spec.dilation,
                          first_dilation=first_dilation if block_idx == 0 else spec.dilation,
                          has_downsample=needs_ds, avg_down=avg_down, compute_dtype=dt)
                if block in ("basic", "bottleneck"):
                    kw.update(attn=attn, aa=aa, reduce_first=reduce_first,
                              down_kernel_size=down_kernel_size)
                if block == "bottleneck" and widths:
                    kw.update(widths=scope_widths(widths, f"layer{stage_idx}.{block_idx}"))
                if block in ("bottleneck", "resnest", "res2net", "sk_bottleneck"):
                    kw.update(cardinality=cardinality, base_width=base_width)
                if block == "resnest":
                    kw.update(radix=radix, avd=avd, avd_first=avd_first)
                if block == "res2net":
                    kw.update(scale=scale)
                if block in ("sk_basic", "sk_bottleneck"):
                    kw.update(sk_attn_reduction=sk_attn_reduction,
                              sk_min_attn_channels=sk_min_attn_channels,
                              sk_split_input=sk_split_input)
                blocks.append(_BLOCKS[block](channels, spec.planes, **kw))
                channels = blocks[-1].out_channels
            self.add_module(f"layer{stage_idx}", nn.Sequential(*blocks))
        self.num_features = channels
        # num_classes=0 builds no classifier (timm's convention): the slot
        # model reads features only, and the reference checkpoint has no fc
        self.fc = (Linear(channels, num_classes, compute_dtype=dt) if num_classes > 0
                   else None)

    def forward(self, x: torch.Tensor, features_only: bool = False,
                stop_after: Optional[str] = None,
                start_from: Optional[str] = None) -> torch.Tensor:
        """x: (B, C, H, W). Returns the (B, num_features, h, w) map when
        ``features_only``, else (B, num_classes) class scores.

        ``stop_after``/``start_from`` ('layer1'..'layer4') split the forward
        at a stage boundary, the functional stand-in for forward hooks:
        ``stop_after='layer2'`` returns layer2's output, and
        ``start_from='layer2'`` takes such a tensor and goes on at layer3."""
        resume_after = int(start_from[-1]) if start_from is not None else 0
        if start_from is None:
            x = act.relu(self.bn1(self.conv1(x)))
            if self.aa:
                # the stem pool becomes max-pool at stride 1 and a blurred
                # stride-2 downsample (resnet.py:414-418)
                x = blur_pool(F.max_pool2d(x, 3, 1, 1), stride=2)
            else:
                x = max_pool_3x3_s2_p1(x)
        for stage_idx in range(resume_after + 1, 5):
            x = getattr(self, f"layer{stage_idx}")(x)
            if stop_after == f"layer{stage_idx}":
                return x
        return x if features_only else self.forward_head(x)

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        """The class scores of a ``features_only`` map (the pooled features
        where no ``fc`` was built)."""
        x = head_dropout(global_avg_pool(x), self.drop_rate, self.training)
        return x if self.fc is None else self.fc(x)
