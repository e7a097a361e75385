"""The EfficientNet superfamily in NCHW (counterpart of
``scouter_tpu/models/efficientnet.py``, after timm's ``efficientnet.py``,
``efficientnet_builder.py``, ``efficientnet_blocks.py`` and
``mobilenetv3.py``).

Families: MNASNet B1/A1/small, MobileNetV2, FBNet-C, SPNASNet,
EfficientNet B0-B8/L2, EfficientNet-EdgeTPU ES/EM/EL, EfficientNet-CondConv,
EfficientNet-Lite, MixNet S/M/L/XL/XXL, MobileNetV3 large/small/minimal/rw,
the pruned B1-B3, and every ``tf_*`` twin (TF SAME padding, BatchNorm eps
1e-3).

The architectures are timm's block strings, decoded by
:func:`decode_arch_def` with its repeat scaling (the port's own copy of the
JAX package's decoder). The blocks:

- DepthwiseSeparable: dw -> bn -> act -> SE -> pw -> bn [-> act for 'dsa']
  [+ skip] (efficientnet_blocks.py:145-205)
- InvertedResidual: pw expand -> bn -> act -> dw -> bn -> act -> SE -> pw
  linear -> bn [+ skip], mid = make_divisible(in x e) (:208-283)
- CondConvResidual: the same with per-sample kernels mixed from experts by
  sigmoid(Linear(pooled input)) (:285-339, layers/cond_conv2d.py:34-106)
- EdgeResidual: kxk expand -> bn -> act -> SE -> strided pw linear -> bn
  [+ skip], mid from fake_in_chs where given (:341-410)
- MixedConv: channel splits, the first taking the remainder, each with its
  own kernel (layers/mixed_conv2d.py:14-52)
- SE: reduced = make_divisible(base x ratio, divisor), base the block's
  input or its mid (resolve_se_args)

Module names are timm's (``conv_stem``, ``bn1``, ``blocks.{s}.{i}.conv_pw``,
``conv_dw.{k}`` of a mixed conv, ``se.conv_reduce``, ``conv_head``,
``classifier``); a CondConv weight is timm's (experts, params). The ReLUs
and residual adds go through ``act`` where JAX's call its ``act``'s; relu6,
swish and the hard activations are plain ops there and here.

PyTorch modules are built with their input widths, which flax infers: each
block takes the width of the tensor before it (``in_rt``), which a pruned
table may make differ from the unpruned width (``in_chs``) that decides
the skips and the SE reductions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import act as _act
from .layers import (
    Conv2d,
    Linear,
    batch_norm,
    conv2d,
    global_avg_pool,
    head_dropout,
    head_dtype,
    pad_same,
    torch_conv_padding,
)
from .pruned import WidthOverrides, load_pruned_widths, scope_widths, width_of
from .registry import register_model

__all__ = ["EfficientNet", "MobileNetV3", "decode_arch_def", "BlockSpec"]


def make_divisible(v: float, divisor: int = 8, min_value: Optional[int] = None) -> int:
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def round_channels(channels: float, multiplier: float = 1.0, divisor: int = 8) -> int:
    if not multiplier:
        return int(channels)
    return make_divisible(channels * multiplier, divisor)


def swish(x):
    return F.silu(x)


def hard_swish(x):
    return x * F.relu6(x + 3.0) / 6.0


def hard_sigmoid(x):
    return F.relu6(x + 3.0) / 6.0


_ACTS = {
    "swish": swish,
    "relu": _act.relu,
    "relu6": F.relu6,
    "hard_swish": hard_swish,
}



@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One fully-expanded block (post repeat-scaling, stride already fixed)."""

    kind: str  # 'ds' | 'dsa' | 'ir' | 'er' | 'cn'
    kernel: Tuple[int, ...] = (3,)  # dw kernel(s); er: expansion kernel(s); cn: conv kernel
    exp_kernel: Tuple[int, ...] = (1,)  # ir: pw-expansion kernel(s)
    pw_kernel: Tuple[int, ...] = (1,)  # ir/ds/er: pw-linear kernel(s)
    stride: int = 1
    exp_ratio: float = 1.0
    channels: int = 0
    se_ratio: float = 0.0
    act: Optional[str] = None  # None -> model default act
    noskip: bool = False
    fake_in: int = 0  # er only (efficientnet.py:768 'fc24')
    num_experts: int = 0  # CondConv
    # SE behavior (model-level se_kwargs merged in at decode time)
    se_from_mid: bool = False
    se_gate: str = "sigmoid"
    se_divisor: int = 1
    se_act: Optional[str] = None  # None -> block act


_BLOCK_ACTS = {"re": "relu", "r6": "relu6", "hs": "hard_swish", "sw": "swish"}


def _parse_ksize(s: str) -> Tuple[int, ...]:
    return tuple(int(k) for k in s.split("."))


def _decode_block_str(block_str: str):
    """timm block-string grammar (``efficientnet_builder.py:22-139``) ->
    (field dict, num_repeat)."""
    ops = block_str.split("_")
    kind, ops = ops[0], ops[1:]
    opts = {}
    noskip = False
    for op in ops:
        if op == "noskip":
            noskip = True
        elif op.startswith("n"):
            opts["n"] = _BLOCK_ACTS[op[1:]]
        else:
            # key = leading letters, value = rest starting at the first digit
            for i, ch in enumerate(op):
                if ch.isdigit():
                    opts[op[:i]] = op[i:]
                    break
    fields = dict(
        kind=kind,
        stride=int(opts["s"]),
        channels=int(opts["c"]),
        act=opts.get("n"),
        noskip=noskip or kind == "dsa",
        se_ratio=float(opts.get("se", 0.0)),
    )
    if kind in ("ds", "dsa", "ir"):
        fields["kernel"] = _parse_ksize(opts["k"])
        fields["pw_kernel"] = _parse_ksize(opts.get("p", "1"))
    if kind == "ir":
        fields["exp_kernel"] = _parse_ksize(opts.get("a", "1"))
        fields["exp_ratio"] = float(opts["e"])
        if "cc" in opts:
            fields["num_experts"] = int(opts["cc"])
    elif kind == "er":
        fields["kernel"] = _parse_ksize(opts["k"])
        fields["pw_kernel"] = _parse_ksize(opts.get("p", "1"))
        fields["exp_ratio"] = float(opts["e"])
        fields["fake_in"] = int(opts.get("fc", 0))
    elif kind == "cn":
        fields["kernel"] = (int(opts["k"]),)
    return fields, int(opts["r"])


def _scale_stage_depth(defs, repeats, depth_multiplier, depth_trunc):
    """Stage repeat scaling — reverse proportional allocation so the first
    block def is least likely to be duplicated (builder:142-177)."""
    num_repeat = sum(repeats)
    if depth_trunc == "round":
        num_repeat_scaled = max(1, round(num_repeat * depth_multiplier))
    else:
        num_repeat_scaled = int(math.ceil(num_repeat * depth_multiplier))
    scaled = []
    for r in repeats[::-1]:
        rs = max(1, round(r / num_repeat * num_repeat_scaled))
        scaled.append(rs)
        num_repeat -= r
        num_repeat_scaled -= rs
    scaled = scaled[::-1]
    out = []
    for fields, rep in zip(defs, scaled):
        out.extend([dict(fields)] * rep)
    return out


def decode_arch_def(
    arch_def: Sequence[Sequence[str]],
    depth_multiplier: float = 1.0,
    depth_trunc: str = "ceil",
    experts_multiplier: int = 1,
    fix_first_last: bool = False,
    se_overrides: Optional[dict] = None,
) -> Tuple[Tuple[BlockSpec, ...], ...]:
    """Decode + expand an arch table (``efficientnet_builder.py:180-197``).

    Beyond the reference decoder this also resolves two things the torch
    builder does later, so the model shells stay a plain loop: strides of
    non-first blocks in a stage are forced to 1 (builder:312-314), and
    model-level SE kwargs are merged into each SE-carrying block
    (resolve_se_args, efficientnet_blocks.py:40-52).
    """
    stages = []
    for stack_idx, block_strs in enumerate(arch_def):
        defs, repeats = [], []
        for s in block_strs:
            fields, rep = _decode_block_str(s)
            if fields.get("num_experts", 0) and experts_multiplier > 1:
                fields["num_experts"] *= experts_multiplier
            defs.append(fields)
            repeats.append(rep)
        dm = 1.0 if fix_first_last and stack_idx in (0, len(arch_def) - 1) else depth_multiplier
        expanded = _scale_stage_depth(defs, repeats, dm, depth_trunc)
        specs = []
        for i, fields in enumerate(expanded):
            if i >= 1:
                fields["stride"] = 1
            if fields["se_ratio"] > 0 and se_overrides:
                fields.update(se_overrides)
            specs.append(BlockSpec(**fields))
        stages.append(tuple(specs))
    return tuple(stages)



# ---------------------------------------------------------------------------
# conv building blocks
# ---------------------------------------------------------------------------


def _split_channels(num_chan: int, num_groups: int):
    split = [num_chan // num_groups] * num_groups
    split[0] += num_chan - sum(split)
    return split


class _MixedConv(nn.ModuleDict):
    """MixedConv2d (``layers/mixed_conv2d.py:20-52``): the input's channel
    splits, each through its own kernel size, concatenated; the convs are
    the dict's "0", "1", ... as timm's."""

    def __init__(self, in_chs: int, out_chs: int, kernels: Tuple[int, ...], stride: int,
                 pad, depthwise: bool, compute_dtype=None):
        in_splits = _split_channels(in_chs, len(kernels))
        out_splits = _split_channels(out_chs, len(kernels))
        super().__init__({
            str(i): conv2d(ci, co, k, stride=stride, padding=pad,
                           groups=co if depthwise else 1, compute_dtype=compute_dtype)
            for i, (k, ci, co) in enumerate(zip(kernels, in_splits, out_splits))})
        self.in_splits = in_splits

    def forward(self, x):
        parts = x.split(self.in_splits, dim=1)
        return torch.cat([conv(p) for conv, p in zip(self.values(), parts)], dim=1)


def _create_conv(in_chs: int, out_chs: int, kernels: Tuple[int, ...], *, stride: int = 1,
                 pad=None, depthwise: bool = False, compute_dtype=None) -> nn.Module:
    """timm's ``create_conv2d``: one conv, or a mixed conv for several kernel
    sizes; a depthwise conv has one group per output channel."""
    if len(kernels) == 1:
        return conv2d(in_chs, out_chs, kernels[0], stride=stride, padding=pad,
                      groups=out_chs if depthwise else 1, compute_dtype=compute_dtype)
    return _MixedConv(in_chs, out_chs, kernels, stride, pad, depthwise, compute_dtype)


class CondConv2d(nn.Module):
    """CondConv2d (``timm/models/layers/cond_conv2d.py:34-106``): each
    sample's kernel is its routing weights' mix of ``num_experts`` expert
    kernels, ``weight`` (experts, out x in/groups x k x k) in timm's flat
    (O, I/g, kh, kw) order. The batch runs as one conv with the samples as
    groups, as timm's does; the JAX package vmaps one conv a sample. Each
    expert is initialised as a conv of its own (kaiming-uniform over the
    expert's fan, ``models/__init__.py``)."""

    def __init__(self, in_chs: int, out_chs: int, kernel_size: int, stride: int = 1,
                 groups: int = 1, num_experts: int = 4, pad=None, compute_dtype=None):
        super().__init__()
        self.in_chs, self.out_chs, self.kernel_size = in_chs, out_chs, kernel_size
        self.stride, self.groups, self.same = stride, groups, pad == "same"
        self.padding = 0 if self.same else torch_conv_padding(kernel_size, stride)
        self.compute_dtype = compute_dtype
        num_params = out_chs * (in_chs // groups) * kernel_size * kernel_size
        self.weight = nn.Parameter(torch.empty(num_experts, num_params))
        bound = 1.0 / math.sqrt(in_chs // groups * kernel_size * kernel_size)
        nn.init.uniform_(self.weight, -bound, bound)

    def forward(self, x, routing):
        dt = self.compute_dtype or x.dtype
        x = x.to(dt)
        if self.same:
            x = pad_same(x, self.kernel_size, self.stride)
        b, c, h, w = x.shape
        k = self.kernel_size
        weight = (routing.to(dt) @ self.weight.to(dt)).reshape(
            b * self.out_chs, self.in_chs // self.groups, k, k)
        groups = self.groups * b

        def conv(a, kernel, bias):
            return F.conv2d(a, kernel, bias, stride=self.stride, padding=self.padding,
                            groups=groups)

        out = _act.linear(conv, x.reshape(1, b * c, h, w), weight)
        return out.reshape(b, self.out_chs, out.shape[-2], out.shape[-1])


class _SE(nn.Module):
    """The blocks' SqueezeExcite: conv_reduce (bias) -> act -> conv_expand
    (bias) -> sigmoid or hard-sigmoid gate. flax ``nn.Conv`` in JAX: plain
    ``Conv2d`` here (LeCun init, no conv policy)."""

    def __init__(self, in_width: int, out_chs: int, reduced_chs: int, act: str, gate: str,
                 compute_dtype=None):
        super().__init__()
        self.act, self.gate = act, gate
        self.conv_reduce = Conv2d(in_width, reduced_chs, 1, bias=True,
                                  compute_dtype=compute_dtype)
        self.conv_expand = Conv2d(reduced_chs, out_chs, 1, bias=True,
                                  compute_dtype=compute_dtype)

    def forward(self, x):
        s = self.conv_reduce(x.mean(dim=(2, 3), keepdim=True))
        s = self.conv_expand(_ACTS[self.act](s))
        gate = hard_sigmoid if self.gate == "hard_sigmoid" else torch.sigmoid
        return x * gate(s)


def _se_module(spec: BlockSpec, block_in: int, mid: int, act: str, in_width: int,
               compute_dtype=None, widths: WidthOverrides = None,
               mid_runtime: Optional[int] = None) -> Optional[_SE]:
    """``block_in``/``mid`` are the unpruned widths the reduction follows,
    ``mid_runtime`` the pruned width the gate must match and ``in_width``
    the gated tensor's. A pruned table sets both 1x1 convs."""
    if spec.se_ratio <= 0:
        return None
    base = mid if spec.se_from_mid else block_in
    reduced = width_of(widths, "se.conv_reduce",
                       make_divisible(base * spec.se_ratio, spec.se_divisor))
    expand = width_of(widths, "se.conv_expand", mid_runtime or mid)
    return _SE(in_width, expand, reduced, spec.se_act or act, spec.se_gate, compute_dtype)


class _Block(nn.Module):
    """What the blocks share: the act, the BatchNorms' eps and the skip."""

    def __init__(self, spec: BlockSpec, in_chs: int, out_chs: int, act: str):
        super().__init__()
        self.act = act
        self.has_skip = spec.stride == 1 and in_chs == out_chs and not spec.noskip

    def skip(self, x, shortcut):
        return _act.residual_add(x, shortcut) if self.has_skip else x


class _DsBlock(_Block):
    def __init__(self, spec: BlockSpec, in_chs: int, out_chs: int, act: str, in_rt: int,
                 pad=None, bn_eps: float = 1e-5, widths: WidthOverrides = None,
                 compute_dtype=None):
        super().__init__(spec, in_chs, out_chs, act)
        dt = compute_dtype
        self.pw_act = spec.kind == "dsa"
        dw = width_of(widths, "conv_dw", in_chs)
        pw = width_of(widths, "conv_pw", out_chs)
        self.conv_dw = _create_conv(in_rt, dw, spec.kernel, stride=spec.stride, pad=pad,
                                    depthwise=True, compute_dtype=dt)
        self.bn1 = batch_norm(dw, eps=bn_eps, compute_dtype=dt)
        self.se = _se_module(spec, in_chs, in_chs, act, dw, dt, widths, mid_runtime=dw)
        self.conv_pw = _create_conv(dw, pw, spec.pw_kernel, pad=pad, compute_dtype=dt)
        self.bn2 = batch_norm(pw, eps=bn_eps, compute_dtype=dt)
        self.out_rt = pw

    def forward(self, x):
        act = _ACTS[self.act]
        out = act(self.bn1(self.conv_dw(x)))
        if self.se is not None:
            out = self.se(out)
        out = self.bn2(self.conv_pw(out))
        if self.pw_act:
            out = act(out)
        return self.skip(out, x)


class _IrBlock(_Block):
    """InvertedResidual; with ``spec.num_experts`` it is CondConvResidual,
    its three convs routed from the block's input."""

    def __init__(self, spec: BlockSpec, in_chs: int, out_chs: int, act: str, in_rt: int,
                 pad=None, bn_eps: float = 1e-5, widths: WidthOverrides = None,
                 compute_dtype=None):
        super().__init__(spec, in_chs, out_chs, act)
        dt = compute_dtype
        mid = make_divisible(in_chs * spec.exp_ratio)
        pw = width_of(widths, "conv_pw", mid)
        dw = width_of(widths, "conv_dw", pw)
        pwl = width_of(widths, "conv_pwl", out_chs)
        e = spec.num_experts
        self.routing_fn = Linear(in_rt, e, compute_dtype=dt) if e else None
        if e:
            self.conv_pw = CondConv2d(in_rt, pw, spec.exp_kernel[0], num_experts=e, pad=pad,
                                      compute_dtype=dt)
            self.conv_dw = CondConv2d(pw, dw, spec.kernel[0], stride=spec.stride, groups=dw,
                                      num_experts=e, pad=pad, compute_dtype=dt)
            self.conv_pwl = CondConv2d(dw, pwl, spec.pw_kernel[0], num_experts=e, pad=pad,
                                       compute_dtype=dt)
        else:
            self.conv_pw = _create_conv(in_rt, pw, spec.exp_kernel, pad=pad, compute_dtype=dt)
            self.conv_dw = _create_conv(pw, dw, spec.kernel, stride=spec.stride, pad=pad,
                                        depthwise=True, compute_dtype=dt)
            self.conv_pwl = _create_conv(dw, pwl, spec.pw_kernel, pad=pad, compute_dtype=dt)
        self.bn1 = batch_norm(pw, eps=bn_eps, compute_dtype=dt)
        self.bn2 = batch_norm(dw, eps=bn_eps, compute_dtype=dt)
        self.se = _se_module(spec, in_chs, mid, act, dw, dt, widths, mid_runtime=dw)
        self.bn3 = batch_norm(pwl, eps=bn_eps, compute_dtype=dt)
        self.out_rt = pwl

    def forward(self, x):
        act = _ACTS[self.act]
        if self.routing_fn is not None:
            # sigmoid(Linear(the pooled block input)) (efficientnet_blocks.py:306-311)
            routing = torch.sigmoid(self.routing_fn(x.mean(dim=(2, 3))))
            convs = [lambda t, c=c: c(t, routing)
                     for c in (self.conv_pw, self.conv_dw, self.conv_pwl)]
        else:
            convs = [self.conv_pw, self.conv_dw, self.conv_pwl]
        out = act(self.bn1(convs[0](x)))
        out = act(self.bn2(convs[1](out)))
        if self.se is not None:
            out = self.se(out)
        out = self.bn3(convs[2](out))
        return self.skip(out, x)


class _ErBlock(_Block):
    """EdgeResidual (efficientnet_blocks.py:341-410): the kxk expansion conv,
    SE, then the strided pointwise-linear projection."""

    def __init__(self, spec: BlockSpec, in_chs: int, out_chs: int, act: str, in_rt: int,
                 pad=None, bn_eps: float = 1e-5, widths: WidthOverrides = None,
                 compute_dtype=None):
        super().__init__(spec, in_chs, out_chs, act)
        dt = compute_dtype
        mid = make_divisible((spec.fake_in or in_chs) * spec.exp_ratio)
        self.conv_exp = _create_conv(in_rt, mid, spec.kernel, pad=pad, compute_dtype=dt)
        self.bn1 = batch_norm(mid, eps=bn_eps, compute_dtype=dt)
        self.se = _se_module(spec, in_chs, mid, act, mid, dt)
        self.conv_pwl = _create_conv(mid, out_chs, spec.pw_kernel, stride=spec.stride, pad=pad,
                                     compute_dtype=dt)
        self.bn2 = batch_norm(out_chs, eps=bn_eps, compute_dtype=dt)
        self.out_rt = out_chs

    def forward(self, x):
        out = _ACTS[self.act](self.bn1(self.conv_exp(x)))
        if self.se is not None:
            out = self.se(out)
        return self.skip(self.bn2(self.conv_pwl(out)), x)


class _CnBlock(_Block):
    def __init__(self, spec: BlockSpec, in_chs: int, out_chs: int, act: str, in_rt: int,
                 pad=None, bn_eps: float = 1e-5, widths: WidthOverrides = None,
                 compute_dtype=None):
        super().__init__(spec, in_chs, out_chs, act)
        self.has_skip = False
        width = width_of(widths, "conv", out_chs)
        self.conv = _create_conv(in_rt, width, spec.kernel, stride=spec.stride, pad=pad,
                                 compute_dtype=compute_dtype)
        self.bn1 = batch_norm(width, eps=bn_eps, compute_dtype=compute_dtype)
        self.out_rt = width

    def forward(self, x):
        return _ACTS[self.act](self.bn1(self.conv(x)))


_BLOCK_CLS = {"ds": _DsBlock, "dsa": _DsBlock, "ir": _IrBlock, "er": _ErBlock,
              "cn": _CnBlock}


def _build_blocks(arch, in_chs: int, in_rt: int, channel_multiplier: float, default_act: str,
                  pad=None, bn_eps: float = 1e-5, widths: WidthOverrides = None,
                  compute_dtype=None):
    """The decoded stages as timm's ``blocks`` (a Sequential of stage
    Sequentials). ``in_chs`` follows the unpruned widths (the skip and
    SE-reduction decisions predate timm's pruning surgery,
    helpers.py:157-186), ``in_rt`` the tensor's. Returns (blocks, unpruned
    width, tensor width)."""
    stages = []
    for stage_idx, stage in enumerate(arch):
        blocks = []
        for block_idx, spec in enumerate(stage):
            out_chs = round_channels(spec.channels, channel_multiplier)
            block = _BLOCK_CLS[spec.kind](
                spec, in_chs, out_chs, spec.act or default_act, in_rt, pad=pad, bn_eps=bn_eps,
                widths=scope_widths(widths, f"blocks.{stage_idx}.{block_idx}"),
                compute_dtype=compute_dtype)
            blocks.append(block)
            in_chs, in_rt = out_chs, block.out_rt
        stages.append(nn.Sequential(*blocks))
    return nn.Sequential(*stages), in_chs, in_rt


# ---------------------------------------------------------------------------
# model shells
# ---------------------------------------------------------------------------


class EfficientNet(nn.Module):
    """The EfficientNet shell (timm/models/efficientnet.py:302-410):
    conv_stem/bn1/act -> the decoded stages -> conv_head/bn2/act -> global
    pool -> classifier; every family but MobileNetV3. ``features_only``
    returns the map after conv_head's act (the reference strips the pool
    and the classifier of 'efficient' models, slot_model.py:41-43);
    ``num_classes=0`` builds no classifier."""

    def __init__(self, arch, channel_multiplier: float = 1.0, num_classes: int = 1000,
                 in_chans: int = 3, stem_size: int = 32, fix_stem: bool = False,
                 num_features: int = 1280, act: str = "relu", drop_rate: float = 0.0,
                 pad=None, bn_eps: float = 1e-5, widths: WidthOverrides = None,
                 compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.act, self.drop_rate = act, drop_rate
        unpruned_stem = stem_size if fix_stem else round_channels(stem_size, channel_multiplier)
        stem = width_of(widths, "conv_stem", unpruned_stem)
        self.conv_stem = conv2d(in_chans, stem, 3, stride=2, padding=pad, compute_dtype=dt)
        self.bn1 = batch_norm(stem, eps=bn_eps, compute_dtype=dt)
        self.blocks, _, chs = _build_blocks(arch, unpruned_stem, stem, channel_multiplier, act,
                                            pad=pad, bn_eps=bn_eps, widths=widths,
                                            compute_dtype=dt)
        head = width_of(widths, "conv_head", num_features)
        self.conv_head = conv2d(chs, head, 1, padding=0, compute_dtype=dt)
        self.bn2 = batch_norm(head, eps=bn_eps, compute_dtype=dt)
        self.num_features = head
        self.classifier = (Linear(head, num_classes, compute_dtype=head_dtype(dt))
                           if num_classes > 0 else None)

    def forward(self, x: torch.Tensor, features_only: bool = False) -> torch.Tensor:
        act = _ACTS[self.act]
        x = self.blocks(act(self.bn1(self.conv_stem(x))))
        x = act(self.bn2(self.conv_head(x)))
        return x if features_only else self.forward_head(x)

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        """The class scores of a ``features_only`` map: pool and classifier."""
        return self.classifier(head_dropout(global_avg_pool(x), self.drop_rate, self.training))


class MobileNetV3(nn.Module):
    """The MobileNetV3 shell (timm/models/mobilenetv3.py:70-150): the head
    conv comes after the global pool, with a bias and no BatchNorm (no bias
    for the rw variant, mobilenetv3.py:286). ``features_only`` returns the
    last stage's map (the reference's mobilenet head strip,
    slot_model.py:47-51), so ``num_features`` is its width."""

    def __init__(self, arch, channel_multiplier: float = 1.0, num_classes: int = 1000,
                 in_chans: int = 3, stem_size: int = 16, num_features: int = 1280,
                 act: str = "hard_swish", head_bias: bool = True, drop_rate: float = 0.0,
                 pad=None, bn_eps: float = 1e-5, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.act, self.drop_rate = act, drop_rate
        stem = round_channels(stem_size, channel_multiplier)
        self.conv_stem = conv2d(in_chans, stem, 3, stride=2, padding=pad, compute_dtype=dt)
        self.bn1 = batch_norm(stem, eps=bn_eps, compute_dtype=dt)
        self.blocks, _, chs = _build_blocks(arch, stem, stem, channel_multiplier, act, pad=pad,
                                            bn_eps=bn_eps, compute_dtype=dt)
        self.num_features = chs
        if num_classes > 0:
            self.conv_head = Conv2d(chs, num_features, 1, bias=head_bias, compute_dtype=dt)
            self.classifier = Linear(num_features, num_classes, compute_dtype=head_dtype(dt))
        else:
            self.conv_head = self.classifier = None

    def forward(self, x: torch.Tensor, features_only: bool = False) -> torch.Tensor:
        act = _ACTS[self.act]
        x = self.blocks(act(self.bn1(self.conv_stem(x))))
        return x if features_only else self.forward_head(x)

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        """The class scores of a ``features_only`` map: pool, head conv, act
        and classifier."""
        x = _ACTS[self.act](self.conv_head(x.mean(dim=(2, 3), keepdim=True))).flatten(1)
        return self.classifier(head_dropout(x, self.drop_rate, self.training))


# ---------------------------------------------------------------------------
# architecture tables (block strings = the published spec; cited per family)
# ---------------------------------------------------------------------------

_EFFNET_ARCH = (  # efficientnet.py:737-745
    ("ds_r1_k3_s1_e1_c16_se0.25",),
    ("ir_r2_k3_s2_e6_c24_se0.25",),
    ("ir_r2_k5_s2_e6_c40_se0.25",),
    ("ir_r3_k3_s2_e6_c80_se0.25",),
    ("ir_r3_k5_s1_e6_c112_se0.25",),
    ("ir_r4_k5_s2_e6_c192_se0.25",),
    ("ir_r1_k3_s1_e6_c320_se0.25",),
)

_EDGE_ARCH = (  # efficientnet.py:766-775
    ("er_r1_k3_s1_e4_c24_fc24_noskip",),
    ("er_r2_k3_s2_e8_c32",),
    ("er_r4_k3_s2_e8_c48",),
    ("ir_r5_k5_s2_e8_c96",),
    ("ir_r4_k5_s1_e8_c144",),
    ("ir_r2_k5_s2_e8_c192",),
)

_CONDCONV_ARCH = (  # efficientnet.py:795-803
    ("ds_r1_k3_s1_e1_c16_se0.25",),
    ("ir_r2_k3_s2_e6_c24_se0.25",),
    ("ir_r2_k5_s2_e6_c40_se0.25",),
    ("ir_r3_k3_s2_e6_c80_se0.25",),
    ("ir_r3_k5_s1_e6_c112_se0.25_cc4",),
    ("ir_r4_k5_s2_e6_c192_se0.25_cc4",),
    ("ir_r1_k3_s1_e6_c320_se0.25_cc4",),
)

_LITE_ARCH = (  # efficientnet.py:837-845
    ("ds_r1_k3_s1_e1_c16",),
    ("ir_r2_k3_s2_e6_c24",),
    ("ir_r2_k5_s2_e6_c40",),
    ("ir_r3_k3_s2_e6_c80",),
    ("ir_r3_k5_s1_e6_c112",),
    ("ir_r4_k5_s2_e6_c192",),
    ("ir_r1_k3_s1_e6_c320",),
)

_MNASNET_A1_ARCH = (  # efficientnet.py:527-543
    ("ds_r1_k3_s1_e1_c16_noskip",),
    ("ir_r2_k3_s2_e6_c24",),
    ("ir_r3_k5_s2_e3_c40_se0.25",),
    ("ir_r4_k3_s2_e6_c80",),
    ("ir_r2_k3_s1_e6_c112_se0.25",),
    ("ir_r3_k5_s2_e6_c160_se0.25",),
    ("ir_r1_k3_s1_e6_c320",),
)

_MNASNET_B1_ARCH = (  # efficientnet.py:563-579
    ("ds_r1_k3_s1_c16_noskip",),
    ("ir_r3_k3_s2_e3_c24",),
    ("ir_r3_k5_s2_e3_c40",),
    ("ir_r3_k5_s2_e6_c80",),
    ("ir_r2_k3_s1_e6_c96",),
    ("ir_r4_k5_s2_e6_c192",),
    ("ir_r1_k3_s1_e6_c320_noskip",),
)

_MNASNET_SMALL_ARCH = (  # efficientnet.py:599-607
    ("ds_r1_k3_s1_c8",),
    ("ir_r1_k3_s2_e3_c16",),
    ("ir_r2_k3_s2_e6_c16",),
    ("ir_r4_k5_s2_e6_c32_se0.25",),
    ("ir_r3_k3_s1_e6_c32_se0.25",),
    ("ir_r3_k5_s2_e6_c88_se0.25",),
    ("ir_r1_k3_s1_e6_c144",),
)

_MOBILENET_V2_ARCH = (  # efficientnet.py:625-633
    ("ds_r1_k3_s1_c16",),
    ("ir_r2_k3_s2_e6_c24",),
    ("ir_r3_k3_s2_e6_c32",),
    ("ir_r4_k3_s2_e6_c64",),
    ("ir_r3_k3_s1_e6_c96",),
    ("ir_r3_k3_s2_e6_c160",),
    ("ir_r1_k3_s1_e6_c320",),
)

_FBNETC_ARCH = (  # efficientnet.py:657-665
    ("ir_r1_k3_s1_e1_c16",),
    ("ir_r1_k3_s2_e6_c24", "ir_r2_k3_s1_e1_c24"),
    ("ir_r1_k5_s2_e6_c32", "ir_r1_k5_s1_e3_c32", "ir_r1_k5_s1_e6_c32",
     "ir_r1_k3_s1_e6_c32"),
    ("ir_r1_k5_s2_e6_c64", "ir_r1_k5_s1_e3_c64", "ir_r2_k5_s1_e6_c64"),
    ("ir_r3_k5_s1_e6_c112", "ir_r1_k5_s1_e3_c112"),
    ("ir_r4_k5_s2_e6_c184",),
    ("ir_r1_k3_s1_e6_c352",),
)

_SPNASNET_ARCH = (  # efficientnet.py:686-702
    ("ds_r1_k3_s1_c16_noskip",),
    ("ir_r3_k3_s2_e3_c24",),
    ("ir_r1_k5_s2_e6_c40", "ir_r3_k3_s1_e3_c40"),
    ("ir_r1_k5_s2_e6_c80", "ir_r3_k3_s1_e3_c80"),
    ("ir_r1_k5_s1_e6_c96", "ir_r3_k5_s1_e3_c96"),
    ("ir_r4_k5_s2_e6_c192",),
    ("ir_r1_k3_s1_e6_c320_noskip",),
)

_MIXNET_S_ARCH = (  # efficientnet.py:866-880
    ("ds_r1_k3_s1_e1_c16",),
    ("ir_r1_k3_a1.1_p1.1_s2_e6_c24", "ir_r1_k3_a1.1_p1.1_s1_e3_c24"),
    ("ir_r1_k3.5.7_s2_e6_c40_se0.5_nsw", "ir_r3_k3.5_a1.1_p1.1_s1_e6_c40_se0.5_nsw"),
    ("ir_r1_k3.5.7_p1.1_s2_e6_c80_se0.25_nsw", "ir_r2_k3.5_p1.1_s1_e6_c80_se0.25_nsw"),
    ("ir_r1_k3.5.7_a1.1_p1.1_s1_e6_c120_se0.5_nsw",
     "ir_r2_k3.5.7.9_a1.1_p1.1_s1_e3_c120_se0.5_nsw"),
    ("ir_r1_k3.5.7.9.11_s2_e6_c200_se0.5_nsw",
     "ir_r2_k3.5.7.9_p1.1_s1_e6_c200_se0.5_nsw"),
)

_MIXNET_M_ARCH = (  # efficientnet.py:899-913
    ("ds_r1_k3_s1_e1_c24",),
    ("ir_r1_k3.5.7_a1.1_p1.1_s2_e6_c32", "ir_r1_k3_a1.1_p1.1_s1_e3_c32"),
    ("ir_r1_k3.5.7.9_s2_e6_c40_se0.5_nsw", "ir_r3_k3.5_a1.1_p1.1_s1_e6_c40_se0.5_nsw"),
    ("ir_r1_k3.5.7_s2_e6_c80_se0.25_nsw", "ir_r3_k3.5.7.9_a1.1_p1.1_s1_e6_c80_se0.25_nsw"),
    ("ir_r1_k3_s1_e6_c120_se0.5_nsw", "ir_r3_k3.5.7.9_a1.1_p1.1_s1_e3_c120_se0.5_nsw"),
    ("ir_r1_k3.5.7.9_s2_e6_c200_se0.5_nsw", "ir_r3_k3.5.7.9_p1.1_s1_e6_c200_se0.5_nsw"),
)

_MBV3_LARGE_ARCH = (  # mobilenetv3.py:365-381
    ("ds_r1_k3_s1_e1_c16_nre",),
    ("ir_r1_k3_s2_e4_c24_nre", "ir_r1_k3_s1_e3_c24_nre"),
    ("ir_r3_k5_s2_e3_c40_se0.25_nre",),
    ("ir_r1_k3_s2_e6_c80", "ir_r1_k3_s1_e2.5_c80", "ir_r2_k3_s1_e2.3_c80"),
    ("ir_r2_k3_s1_e6_c112_se0.25",),
    ("ir_r3_k5_s2_e6_c160_se0.25",),
    ("cn_r1_k1_s1_c960",),
)

_MBV3_LARGE_MINIMAL_ARCH = (  # mobilenetv3.py:346-362
    ("ds_r1_k3_s1_e1_c16",),
    ("ir_r1_k3_s2_e4_c24", "ir_r1_k3_s1_e3_c24"),
    ("ir_r3_k3_s2_e3_c40",),
    ("ir_r1_k3_s2_e6_c80", "ir_r1_k3_s1_e2.5_c80", "ir_r2_k3_s1_e2.3_c80"),
    ("ir_r2_k3_s1_e6_c112",),
    ("ir_r3_k3_s2_e6_c160",),
    ("cn_r1_k1_s1_c960",),
)

_MBV3_SMALL_ARCH = (  # mobilenetv3.py:327-342
    ("ds_r1_k3_s2_e1_c16_se0.25_nre",),
    ("ir_r1_k3_s2_e4.5_c24_nre", "ir_r1_k3_s1_e3.67_c24_nre"),
    ("ir_r1_k5_s2_e4_c40_se0.25", "ir_r2_k5_s1_e6_c40_se0.25"),
    ("ir_r2_k5_s1_e3_c48_se0.25",),
    ("ir_r3_k5_s2_e6_c96_se0.25",),
    ("cn_r1_k1_s1_c576",),
)

_MBV3_SMALL_MINIMAL_ARCH = (  # mobilenetv3.py:311-324
    ("ds_r1_k3_s2_e1_c16",),
    ("ir_r1_k3_s2_e4.5_c24", "ir_r1_k3_s1_e3.67_c24",),
    ("ir_r1_k3_s2_e4_c40", "ir_r2_k3_s1_e6_c40"),
    ("ir_r2_k3_s1_e3_c48",),
    ("ir_r3_k3_s2_e6_c96",),
    ("cn_r1_k1_s1_c576",),
)

_MBV3_RW_ARCH = (  # mobilenetv3.py:269-284
    ("ds_r1_k3_s1_e1_c16_nre_noskip",),
    ("ir_r1_k3_s2_e4_c24_nre", "ir_r1_k3_s1_e3_c24_nre"),
    ("ir_r3_k5_s2_e3_c40_se0.25_nre",),
    ("ir_r1_k3_s2_e6_c80", "ir_r1_k3_s1_e2.5_c80", "ir_r2_k3_s1_e2.3_c80"),
    ("ir_r2_k3_s1_e6_c112_se0.25",),
    ("ir_r3_k5_s2_e6_c160_se0.25",),
    ("cn_r1_k1_s1_c960",),
)

# model-level SE kwargs (resolve_se_args inputs)
_SE_MBV3 = dict(se_act="relu", se_gate="hard_sigmoid", se_from_mid=True, se_divisor=8)
_SE_MBV3_RW = dict(se_gate="hard_sigmoid", se_from_mid=True, se_divisor=1)


# ---------------------------------------------------------------------------
# generators (one per reference _gen_*) + entrypoint registration
# ---------------------------------------------------------------------------


def _common(kw):
    kw.pop("mnist_stem", None)
    tf = kw.pop("tf", False)
    if tf:  # tf_ twins: kwargs['bn_eps']=1e-3, pad_type='same' (efficientnet.py:1289-1290)
        kw.setdefault("bn_eps", 1e-3)
        kw.setdefault("pad", "same")
    return kw


def _gen_efficientnet(cm, dm, num_classes=1000, in_chans=3, arch=_EFFNET_ARCH,
                      act="swish", **kw):
    """_gen_efficientnet (efficientnet.py:713-757)."""
    return EfficientNet(arch=decode_arch_def(arch, dm),
                        channel_multiplier=cm, num_classes=num_classes,
                        in_chans=in_chans, stem_size=32,
                        num_features=round_channels(1280, cm), act=act,
                        **_common(kw))


def _gen_efficientnet_edge(cm, dm, num_classes=1000, in_chans=3, **kw):
    """_gen_efficientnet_edge (efficientnet.py:760-786)."""
    return EfficientNet(arch=decode_arch_def(_EDGE_ARCH, dm),
                        channel_multiplier=cm, num_classes=num_classes,
                        in_chans=in_chans, stem_size=32,
                        num_features=round_channels(1280, cm), act="relu",
                        **_common(kw))


def _gen_efficientnet_condconv(cm, dm, experts_multiplier=1, num_classes=1000,
                               in_chans=3, **kw):
    """_gen_efficientnet_condconv (efficientnet.py:789-816)."""
    return EfficientNet(arch=decode_arch_def(_CONDCONV_ARCH, dm,
                                             experts_multiplier=experts_multiplier),
                        channel_multiplier=cm, num_classes=num_classes,
                        in_chans=in_chans, stem_size=32,
                        num_features=round_channels(1280, cm), act="swish",
                        **_common(kw))


def _gen_efficientnet_lite(cm, dm, num_classes=1000, in_chans=3, **kw):
    """_gen_efficientnet_lite (efficientnet.py:819-858): fixed stem/head, relu6."""
    return EfficientNet(arch=decode_arch_def(_LITE_ARCH, dm, fix_first_last=True),
                        channel_multiplier=cm, num_classes=num_classes,
                        in_chans=in_chans, stem_size=32, fix_stem=True,
                        num_features=1280, act="relu6", **_common(kw))


def _gen_mixnet_s(cm, num_classes=1000, in_chans=3, **kw):
    """_gen_mixnet_s (efficientnet.py:860-890)."""
    return EfficientNet(arch=decode_arch_def(_MIXNET_S_ARCH),
                        channel_multiplier=cm, num_classes=num_classes,
                        in_chans=in_chans, stem_size=16, num_features=1536,
                        act="relu", **_common(kw))


def _gen_mixnet_m(cm, dm=1.0, num_classes=1000, in_chans=3, **kw):
    """_gen_mixnet_m (efficientnet.py:893-925): depth_trunc='round'."""
    return EfficientNet(arch=decode_arch_def(_MIXNET_M_ARCH, dm, depth_trunc="round"),
                        channel_multiplier=cm, num_classes=num_classes,
                        in_chans=in_chans, stem_size=24, num_features=1536,
                        act="relu", **_common(kw))


def _gen_mnasnet(arch, cm, stem_size=32, num_features=1280, num_classes=1000,
                 in_chans=3, **kw):
    """_gen_mnasnet_a1/_b1/_small + _gen_fbnetc/_gen_spnasnet share this shell
    (efficientnet.py:518-710): default relu act, default SE args."""
    return EfficientNet(arch=decode_arch_def(arch), channel_multiplier=cm,
                        num_classes=num_classes, in_chans=in_chans,
                        stem_size=stem_size, num_features=num_features,
                        act="relu", **_common(kw))


def _gen_mobilenet_v2(cm, dm=1.0, fix_stem_head=False, num_classes=1000,
                      in_chans=3, **kw):
    """_gen_mobilenet_v2 (efficientnet.py:619-645): relu6; the 110d/120d
    variants fix stem+head widths and first/last stage depths."""
    return EfficientNet(arch=decode_arch_def(_MOBILENET_V2_ARCH, dm,
                                             fix_first_last=fix_stem_head),
                        channel_multiplier=cm, num_classes=num_classes,
                        in_chans=in_chans, stem_size=32, fix_stem=fix_stem_head,
                        num_features=1280 if fix_stem_head else round_channels(1280, cm),
                        act="relu6", **_common(kw))


def _gen_mobilenet_v3(cm, variant, num_classes=1000, in_chans=3, **kw):
    """_gen_mobilenet_v3 (mobilenetv3.py:298-414)."""
    if "small" in variant:
        num_features = 1024
        if "minimal" in variant:
            arch, act = _MBV3_SMALL_MINIMAL_ARCH, "relu"
        else:
            arch, act = _MBV3_SMALL_ARCH, "hard_swish"
    else:
        num_features = 1280
        if "minimal" in variant:
            arch, act = _MBV3_LARGE_MINIMAL_ARCH, "relu"
        else:
            arch, act = _MBV3_LARGE_ARCH, "hard_swish"
    return MobileNetV3(arch=decode_arch_def(arch, se_overrides=_SE_MBV3),
                       channel_multiplier=cm, num_classes=num_classes,
                       in_chans=in_chans, stem_size=16, num_features=num_features,
                       act=act, **_common(kw))


def _gen_mobilenet_v3_rw(cm, num_classes=1000, in_chans=3, **kw):
    """_gen_mobilenet_v3_rw (mobilenetv3.py:260-296): head conv without bias,
    SE acts with the block act, divisor 1."""
    return MobileNetV3(arch=decode_arch_def(_MBV3_RW_ARCH, se_overrides=_SE_MBV3_RW),
                       channel_multiplier=cm, num_classes=num_classes,
                       in_chans=in_chans, stem_size=16, num_features=1280,
                       act="hard_swish", head_bias=False, **_common(kw))


def _register(name, gen, *args, **cfg):
    def fn(num_classes=1000, in_chans=3, **kw):
        return gen(*args, num_classes=num_classes, in_chans=in_chans, **{**cfg, **kw})

    fn.__name__ = name
    register_model(fn)


# EfficientNet B0-B8 / L2 (efficientnet.py:1050-1180): (cm, dm) per letter
_B = {"b0": (1.0, 1.0), "b1": (1.0, 1.1), "b2": (1.1, 1.2), "b3": (1.2, 1.4),
      "b4": (1.4, 1.8), "b5": (1.6, 2.2), "b6": (1.8, 2.6), "b7": (2.0, 3.1),
      "b8": (2.2, 3.6), "l2": (4.3, 5.3)}
for _n, (_cm, _dm) in _B.items():
    _register(f"efficientnet_{_n}", _gen_efficientnet, _cm, _dm)
for _n in ("b2a", "b3a"):  # 288/320-eval twins of b2/b3 (efficientnet.py:1076-1103)
    _register(f"efficientnet_{_n}", _gen_efficientnet, *_B[_n[:2]])
for _n in list(_B) + [f"{k}_ap" for k in _B if k != "l2"] + \
        [f"{k}_ns" for k in _B if k not in ("b8", "l2")]:
    if _n.startswith("l2"):
        continue
    _register(f"tf_efficientnet_{_n}", _gen_efficientnet, *_B[_n[:2]], tf=True)
_register("tf_efficientnet_l2_ns", _gen_efficientnet, *_B["l2"], tf=True)
_register("tf_efficientnet_l2_ns_475", _gen_efficientnet, *_B["l2"], tf=True)

# EdgeTPU ES/EM/EL (efficientnet.py:1121-1156)
_EDGE = {"es": (1.0, 1.0), "em": (1.0, 1.1), "el": (1.2, 1.4)}
for _n, (_cm, _dm) in _EDGE.items():
    _register(f"efficientnet_{_n}", _gen_efficientnet_edge, _cm, _dm)
    _register(f"tf_efficientnet_{_n}", _gen_efficientnet_edge, _cm, _dm, tf=True)

# CondConv (efficientnet.py:1181-1215)
_CC = {"cc_b0_4e": (1.0, 1.0, 1), "cc_b0_8e": (1.0, 1.0, 2), "cc_b1_8e": (1.0, 1.1, 2)}
for _n, (_cm, _dm, _em) in _CC.items():
    _register(f"efficientnet_{_n}", _gen_efficientnet_condconv, _cm, _dm, _em)
    _register(f"tf_efficientnet_{_n}", _gen_efficientnet_condconv, _cm, _dm, _em, tf=True)

# Lite 0-4 (efficientnet.py:1216-1254)
_LITE = {"lite0": (1.0, 1.0), "lite1": (1.0, 1.1), "lite2": (1.1, 1.2),
         "lite3": (1.2, 1.4), "lite4": (1.4, 1.8)}
for _n, (_cm, _dm) in _LITE.items():
    _register(f"efficientnet_{_n}", _gen_efficientnet_lite, _cm, _dm)
    _register(f"tf_efficientnet_{_n}", _gen_efficientnet_lite, _cm, _dm, tf=True)

# MixNet (efficientnet.py:1696-1772)
_register("mixnet_s", _gen_mixnet_s, 1.0)
_register("mixnet_m", _gen_mixnet_m, 1.0)
_register("mixnet_l", _gen_mixnet_m, 1.3)
_register("mixnet_xl", _gen_mixnet_m, 1.6, 1.2)
_register("mixnet_xxl", _gen_mixnet_m, 2.4, 1.3)
_register("tf_mixnet_s", _gen_mixnet_s, 1.0, tf=True)
_register("tf_mixnet_m", _gen_mixnet_m, 1.0, tf=True)
_register("tf_mixnet_l", _gen_mixnet_m, 1.3, tf=True)

# MNASNet family (efficientnet.py:941-1016)
for _n, _cm in (("050", 0.5), ("075", 0.75), ("100", 1.0), ("140", 1.4)):
    _register(f"mnasnet_{_n}", _gen_mnasnet, _MNASNET_B1_ARCH, _cm)
    _register(f"semnasnet_{_n}", _gen_mnasnet, _MNASNET_A1_ARCH, _cm)
_register("mnasnet_b1", _gen_mnasnet, _MNASNET_B1_ARCH, 1.0)  # alias of mnasnet_100
_register("mnasnet_a1", _gen_mnasnet, _MNASNET_A1_ARCH, 1.0)  # alias of semnasnet_100
_register("mnasnet_small", _gen_mnasnet, _MNASNET_SMALL_ARCH, 1.0, stem_size=8)
_register("fbnetc_100", _gen_mnasnet, _FBNETC_ARCH, 1.0, stem_size=16,
          num_features=1984)
_register("spnasnet_100", _gen_mnasnet, _SPNASNET_ARCH, 1.0)

# MobileNetV2 (efficientnet.py:1002-1030)
_register("mobilenetv2_100", _gen_mobilenet_v2, 1.0)
_register("mobilenetv2_140", _gen_mobilenet_v2, 1.4)
_register("mobilenetv2_110d", _gen_mobilenet_v2, 1.1, 1.2, True)
_register("mobilenetv2_120d", _gen_mobilenet_v2, 1.2, 1.4, True)

# MobileNetV3 (mobilenetv3.py:416-520)
for _n, _cm in (("large_075", 0.75), ("large_100", 1.0),
                ("small_075", 0.75), ("small_100", 1.0)):
    _register(f"mobilenetv3_{_n}", _gen_mobilenet_v3, _cm, _n)
_register("mobilenetv3_rw", _gen_mobilenet_v3_rw, 1.0)
for _n, _cm in (("large_075", 0.75), ("large_100", 1.0), ("large_minimal_100", 1.0),
                ("small_075", 0.75), ("small_100", 1.0), ("small_minimal_100", 1.0)):
    _register(f"tf_mobilenetv3_{_n}", _gen_mobilenet_v3, _cm, _n, tf=True)


def _effnet_pruned(variant, cm, dm, num_classes, in_chans, **kw):
    """Pruned EfficientNets (timm efficientnet.py:1255-1283): TF-SAME padding,
    TF bn eps 1e-3, widths from the pruned surgery table."""
    return _gen_efficientnet(cm, dm, num_classes=num_classes, in_chans=in_chans,
                             pad="same", bn_eps=1e-3,
                             widths=load_pruned_widths(variant), **kw)


@register_model
def efficientnet_b1_pruned(num_classes=1000, in_chans=3, **kw):
    kw.pop("mnist_stem", None)
    return _effnet_pruned("efficientnet_b1_pruned", 1.0, 1.1, num_classes, in_chans, **kw)


@register_model
def efficientnet_b2_pruned(num_classes=1000, in_chans=3, **kw):
    kw.pop("mnist_stem", None)
    return _effnet_pruned("efficientnet_b2_pruned", 1.1, 1.2, num_classes, in_chans, **kw)


@register_model
def efficientnet_b3_pruned(num_classes=1000, in_chans=3, **kw):
    kw.pop("mnist_stem", None)
    return _effnet_pruned("efficientnet_b3_pruned", 1.2, 1.4, num_classes, in_chans, **kw)
