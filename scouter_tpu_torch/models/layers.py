"""NCHW layers for the backbones the port carries
(counterpart of ``scouter_tpu/models/layers.py``).

Torch conv padding, BatchNorm with eps 1e-5 (and flax's running-variance
update in train mode), and the pooling variants the
ResNet/ResNeSt skips use. Module names follow timm's, so state dicts carry the
reference's names.

A ``compute_dtype`` (e.g. bf16) is flax's ``dtype`` with f32 ``param_dtype``:
``Conv2d`` and ``Linear`` cast their input and their f32 parameters to it at
use, and ``BatchNorm2d`` takes its statistics in f32 from an input in it and
returns it, with f32 scale, bias and running stats. ``None`` computes in the
parameters' own dtype.

The conv-substitution hook (the JAX package's ``_conv_policy``,
``scouter_tpu/models/layers.py:20-30, 74-78``) lives on the built model:
:func:`set_conv_policy` asks a policy, for each conv built by :func:`conv2d`
(the convs JAX's ``conv2d`` builds), for a replacement by its kernel size and
groups (``serve/quant.py``'s int8 pointwise convs). JAX installs its policy
in a thread-local at trace time; eager PyTorch has no trace, so the model
carries it, and whichever thread calls the model (the engine's dispatcher)
runs the substituted convs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "BatchNorm2d",
    "Conv2d",
    "Linear",
    "SplitAttnConv",
    "avg_pool_ceil_exclude_pad",
    "avg_pool_include_pad",
    "batch_norm",
    "conv2d",
    "global_avg_pool",
    "max_pool_3x3_s2_p1",
    "set_conv_policy",
    "torch_conv_padding",
]


def torch_conv_padding(kernel_size: int, stride: int, dilation: int = 1) -> int:
    """The symmetric padding timm computes (``timm/models/resnet.py:137-139``)."""
    return ((stride - 1) + dilation * (kernel_size - 1)) // 2


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype`` where one is given: the
    input, weight and bias are cast to it at use (the ``dtype`` of
    ``scouter_tpu/models/layers.py:88``), the parameters keep their dtype.
    ``substitute`` (set by :func:`set_conv_policy`) replaces the conv: it
    gets the input cast to the compute dtype."""

    def __init__(self, *args, compute_dtype=None, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype
        self.substitute = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.substitute is not None:
            return self.substitute(x if dt is None else x.to(dt))
        if dt is None:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` where one is given, as
    ``Conv2d``."""

    def __init__(self, *args, compute_dtype=None, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def conv2d(in_channels: int, out_channels: int, kernel_size: int, *, stride: int = 1,
           padding=None, dilation: int = 1, groups: int = 1, bias: bool = False,
           compute_dtype=None) -> Conv2d:
    """``Conv2d`` with timm's symmetric padding. Marked for the fan-out
    truncated-normal init of the JAX package's ``conv2d`` (models/__init__.py)."""
    p = torch_conv_padding(kernel_size, stride, dilation) if padding is None else padding
    conv = Conv2d(in_channels, out_channels, kernel_size, stride=stride, padding=p,
                  dilation=dilation, groups=groups, bias=bias, compute_dtype=compute_dtype)
    conv.fan_out_init = True
    return conv


def set_conv_policy(model: nn.Module, policy) -> int:
    """Install a conv-substitution ``policy`` on ``model``: for each conv built
    by :func:`conv2d`, ``policy(kernel_size, groups)`` gives None (the conv
    stays as it is) or a factory, and ``factory(conv)`` the callable that
    replaces the conv's forward (it may prepare the conv's weights once).
    ``policy=None`` puts every conv back. Returns the number substituted."""
    count = 0
    for m in model.modules():
        if isinstance(m, Conv2d) and getattr(m, "fan_out_init", False):
            make = policy(m.kernel_size[0], m.groups) if policy is not None else None
            m.substitute = make(m) if make is not None else None
            count += m.substitute is not None
    return count


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode updates the running variance with
    the biased batch variance, as flax's BatchNorm in the JAX package does
    (``scouter_tpu/models/layers.py:104-106``); ``nn.BatchNorm2d`` itself
    folds in the unbiased one, n/(n-1) larger per channel.

    Train mode normalises with the batch statistics through the stock
    ``F.batch_norm`` (cuDNN on the card) and hands it fresh per-channel
    buffers with momentum 1, which it fills with the batch mean and unbiased
    variance; the running stats then move by ``momentum`` towards the mean
    and the variance rescaled by (n-1)/n. That is a few per-channel ops more
    per layer and no extra pass over the activations. Eval mode is the stock
    module, unchanged.

    With ``compute_dtype`` (flax's BatchNorm ``dtype``,
    ``scouter_tpu/models/layers.py:94-106``) the input is cast to it and
    normalised by ``F.batch_norm`` with the f32 scale, bias and statistics:
    the statistics and the arithmetic are f32, the output is in
    ``compute_dtype``.
    """

    def __init__(self, *args, compute_dtype=None, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        if not self.training:
            return super().forward(x)
        c = x.shape[1]
        n = x.numel() // c
        mean = torch.zeros(c, dtype=self.running_mean.dtype, device=x.device)
        var = torch.ones(c, dtype=self.running_var.dtype, device=x.device)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m * (n - 1) / n)
            self.num_batches_tracked.add_(1)
        return y


def batch_norm(num_features: int, *, eps: float = 1e-5, compute_dtype=None) -> BatchNorm2d:
    """BatchNorm with torch defaults (momentum 0.1, eps 1e-5), flax's
    running-variance update in train mode (``BatchNorm2d``)."""
    return BatchNorm2d(num_features, eps=eps, momentum=0.1, compute_dtype=compute_dtype)


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
                 radix: int = 2, reduction_factor: int = 4, compute_dtype=None):
        super().__init__()
        self.radix, self.groups = radix, groups
        mid_chs = out_channels * radix
        attn_chs = max(in_channels * radix // reduction_factor, 32)
        dt = compute_dtype
        self.conv = Conv2d(in_channels, mid_chs, kernel_size, stride=stride, padding=padding,
                           dilation=dilation, groups=groups * radix, bias=False,
                           compute_dtype=dt)
        self.bn0 = batch_norm(mid_chs, compute_dtype=dt)
        self.fc1 = Conv2d(out_channels, attn_chs, 1, groups=groups, compute_dtype=dt)
        self.bn1 = batch_norm(attn_chs, compute_dtype=dt)
        self.fc2 = Conv2d(attn_chs, mid_chs, 1, groups=groups, compute_dtype=dt)

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
