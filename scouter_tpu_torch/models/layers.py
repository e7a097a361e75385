"""NCHW layers for the backbone zoo
(counterpart of ``scouter_tpu/models/layers.py``).

Torch conv padding (or TF's SAME, for the tf_ EfficientNets), BatchNorm
with eps 1e-5 (and flax's running-variance update in train mode), the
pooling variants the ResNet/ResNeSt skips use, the SE and ECA gates, the
anti-aliasing blur, stochastic depth, head dropout and the space-to-depth
stem conv. Module names follow timm's, so state dicts
carry the reference's names.

A ``compute_dtype`` (e.g. bf16) is flax's ``dtype`` with f32 ``param_dtype``:
``Conv2d`` and ``Linear`` cast their input and their f32 parameters to it at
use, and ``BatchNorm2d`` takes its statistics in f32 from an input in it and
returns it, with f32 scale, bias and running stats. ``None`` computes in the
parameters' own dtype.

Every conv and dense product (``Conv2d``, ``Conv1d``, ``Linear``, the blur
and space-to-depth stem convs) goes through ``act.linear`` and every
BatchNorm's output through ``act.norm_output``: the plain op unless
excitation backprop installs its rules there (``models/act.py``), where
the JAX package patches ``conv_general_dilated``/``dot_general`` and
flax's BatchNorm.

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

import contextlib
import math
import threading
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import act

__all__ = [
    "Apply",
    "BatchNorm2d",
    "Conv1d",
    "Conv2d",
    "Eca",
    "Linear",
    "SpaceToDepthStemConv",
    "SplitAttnConv",
    "SqueezeExcite",
    "avg_pool_ceil_exclude_pad",
    "avg_pool_include_pad",
    "avg_pool_same_zero_pad",
    "batch_norm",
    "batch_norm_group",
    "blur_pool",
    "conv2d",
    "drop_path",
    "global_avg_pool",
    "head_dropout",
    "head_dtype",
    "max_pool_3x3_s2_p1",
    "norm_act",
    "pad_same",
    "set_conv_policy",
    "torch_conv_padding",
]


def torch_conv_padding(kernel_size: int, stride: int, dilation: int = 1) -> int:
    """The symmetric padding timm computes (``timm/models/resnet.py:137-139``)."""
    return ((stride - 1) + dilation * (kernel_size - 1)) // 2


def pad_same(x: torch.Tensor, kernel_size: int, stride: int, dilation: int = 1) -> torch.Tensor:
    """TF's SAME zero padding (XLA's ``'SAME'``, timm's ``pad_same``): the
    output is ceil(size / stride), and an odd total pad puts the extra row
    and column at the bottom and right."""
    pads = []
    for size in (x.shape[-1], x.shape[-2]):
        total = max((-(-size // stride) - 1) * stride + (kernel_size - 1) * dilation + 1 - size,
                    0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype`` where one is given: the
    input, weight and bias are cast to it at use (the ``dtype`` of
    ``scouter_tpu/models/layers.py:88``), the parameters keep their dtype.
    ``substitute`` (set by :func:`set_conv_policy`) replaces the conv: it
    gets the input cast to the compute dtype. ``same`` pads the input to
    TF's SAME (:func:`pad_same`) before a conv built with padding 0."""

    def __init__(self, *args, compute_dtype=None, same: bool = False, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype
        self.substitute = None
        self.same = same

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.same:
            x = pad_same(x, self.kernel_size[0], self.stride[0], self.dilation[0])
        if self.substitute is not None:
            return self.substitute(x if dt is None else x.to(dt))
        if dt is None:
            return act.linear(self._conv_forward, x, self.weight, self.bias)
        bias = None if self.bias is None else self.bias.to(dt)
        return act.linear(self._conv_forward, x.to(dt), self.weight.to(dt), bias)


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` computing in ``compute_dtype`` where one is given, as
    ``Conv2d`` (ECA's channel conv)."""

    def __init__(self, *args, compute_dtype=None, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return act.linear(self._conv_forward, x, self.weight, self.bias)
        bias = None if self.bias is None else self.bias.to(dt)
        return act.linear(self._conv_forward, x.to(dt), self.weight.to(dt), bias)


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` where one is given, as
    ``Conv2d``."""

    def __init__(self, *args, compute_dtype=None, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return act.linear(F.linear, x, self.weight, self.bias)
        return act.linear(F.linear, x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Apply(nn.Module):
    """A stage of a Sequential with no parameters (a pool, a pad, an act):
    ``fn`` on the input, so the stages after it keep timm's indices."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)


def conv2d(in_channels: int, out_channels: int, kernel_size: int, *, stride: int = 1,
           padding=None, dilation: int = 1, groups: int = 1, bias: bool = False,
           compute_dtype=None) -> Conv2d:
    """``Conv2d`` with timm's symmetric padding, or TF's SAME where
    ``padding='same'`` (timm's ``Conv2dSame``; the tf_ and pruned
    EfficientNets). Marked for the fan-out truncated-normal init of the JAX
    package's ``conv2d`` (models/__init__.py)."""
    same = padding == "same"
    if same:
        p = 0
    else:
        p = torch_conv_padding(kernel_size, stride, dilation) if padding is None else padding
    conv = Conv2d(in_channels, out_channels, kernel_size, stride=stride, padding=p,
                  dilation=dilation, groups=groups, bias=bias, compute_dtype=compute_dtype,
                  same=same)
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
        # the space-to-depth stem conv is not built by JAX's conv2d
        if (isinstance(m, Conv2d) and getattr(m, "fan_out_init", False)
                and not isinstance(m, SpaceToDepthStemConv)):
            make = policy(m.kernel_size[0], m.groups) if policy is not None else None
            m.substitute = make(m) if make is not None else None
            count += m.substitute is not None
    return count


_BN_GROUP = threading.local()


@contextlib.contextmanager
def batch_norm_group(group):
    """Within: every ``BatchNorm2d`` in train mode takes its batch statistics
    over the ranks of ``group`` (a ``torch.distributed`` process group; None
    keeps them local), as flax's BatchNorm does over a sharded global batch.
    A train step sets it around its forward (``train/steps.py``)."""
    before = getattr(_BN_GROUP, "group", None)
    _BN_GROUP.group = group
    try:
        yield
    finally:
        _BN_GROUP.group = before


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

    Under :func:`batch_norm_group` the batch statistics are the group's
    (:meth:`_global`): the per-channel count and sum, then the sum of squared
    deviations from the global mean, cross ranks through collectives whose
    gradient is summed over the group, so the gradient flows through the
    global mean and variance as it does in one process over the whole batch.
    The running variance takes the biased global variance.
    """

    def __init__(self, *args, compute_dtype=None, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return act.norm_output(x, self._normalise(x))

    def _normalise(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        if not self.training:
            return super().forward(x)
        group = getattr(_BN_GROUP, "group", None)
        if group is not None:
            return self._global(x, group)
        c = x.shape[1]
        n = x.numel() // c
        if n == 1:
            return self._single_value(x)
        mean = torch.zeros(c, dtype=self.running_mean.dtype, device=x.device)
        var = torch.ones(c, dtype=self.running_var.dtype, device=x.device)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m * (n - 1) / n)
            self.num_batches_tracked.add_(1)
        return y

    def _single_value(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over one value a channel (a (1, C, 1, 1) gate at batch
        1), where ``F.batch_norm`` refuses: flax takes the value as the mean
        and a variance of 0, so the output is the bias and the running
        variance decays towards 0."""
        mean = x.float().reshape(1, -1)[0]
        y = ((x.float() - mean[None, :, None, None]) * self.eps ** -0.5
             * self.weight[None, :, None, None] + self.bias[None, :, None, None])
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m)
            self.num_batches_tracked.add_(1)
        return y.to(x.dtype)

    def _global(self, x: torch.Tensor, group) -> torch.Tensor:
        """Train mode over the group's global batch, in f32. A global count
        of one value a channel is ``_single_value``'s case: the deviation and
        so the variance are 0, the output is the bias."""
        from ..parallel.mesh import all_reduce_sum

        xf = x.float()
        c = x.shape[1]
        count = torch.full((1,), x.numel() // c, dtype=torch.float32, device=x.device)
        sums = all_reduce_sum(torch.cat([xf.sum(dim=(0, 2, 3)), count]), group)
        n = sums[c]
        mean = sums[:c] / n
        dev = xf - mean[None, :, None, None]
        var = all_reduce_sum(dev.square().sum(dim=(0, 2, 3)), group) / n
        y = (dev * torch.rsqrt(var + self.eps)[None, :, None, None]
             * self.weight[None, :, None, None] + self.bias[None, :, None, None])
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
            self.num_batches_tracked.add_(1)
        return y.to(x.dtype)


def batch_norm(num_features: int, *, eps: float = 1e-5, compute_dtype=None) -> BatchNorm2d:
    """BatchNorm with torch defaults (momentum 0.1, eps 1e-5), flax's
    running-variance update in train mode (``BatchNorm2d``)."""
    return BatchNorm2d(num_features, eps=eps, momentum=0.1, compute_dtype=compute_dtype)


def head_dtype(compute_dtype):
    """The dtype of a flax ``nn.Dense`` built without ``dtype`` over an input
    in ``compute_dtype`` (the classifiers of the families other than
    ResNet): the promotion of it and the f32 kernel, f32."""
    return None if compute_dtype is None else torch.float32


def norm_act(kind: str, x: torch.Tensor) -> torch.Tensor:
    """The act after a BatchNorm in DenseNet's and VoVNet's norm+act:
    ``act.relu``, or InplaceABN's leaky ReLU 0.01 for 'iabn'
    (``layers/inplace_abn.py:40-41``), which no hook reaches in JAX."""
    return F.leaky_relu(x, 0.01) if kind == "iabn" else act.relu(x)


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
        x = act.relu(self.bn0(self.conv(x)))
        b, rc, h, w = x.shape
        chs = rc // self.radix
        if self.radix > 1:
            # channels are radix-major (the grouped conv's output order)
            x_r = x.view(b, self.radix, chs, h, w)
            gap = x_r.sum(dim=1).mean(dim=(2, 3), keepdim=True)
        else:
            x_r = x
            gap = x.mean(dim=(2, 3), keepdim=True)
        gap = act.relu(self.bn1(self.fc1(gap)))
        attn = self.fc2(gap)  # (B, mid, 1, 1)
        if self.radix > 1:
            # RadixSoftmax (split_attn.py:14-28): view as (groups, radix, chs),
            # softmax over radix, applied in the transposed (radix, groups,
            # chs) flat order -- the reference's reshape quirk, kept as it is
            attn = attn.view(b, self.groups, self.radix, -1).transpose(1, 2)
            attn = torch.softmax(attn, dim=1).reshape(b, self.radix, chs, 1, 1)
            return (x_r * attn).sum(dim=1)
        return x_r * torch.sigmoid(attn)


def avg_pool_same_zero_pad(x: torch.Tensor, window: int = 2, stride: int = 1) -> torch.Tensor:
    """timm's ``AvgPool2dSame(window, stride, ceil_mode=True,
    count_include_pad=False)``: TF SAME zero padding, then a plain average,
    so the padded zeros count and edge windows divide by the full window.
    ``downsample_avg`` uses it on dilated stride-1 skips (output stride 8
    and 16)."""
    h, w = x.shape[-2:]
    pad_h = max((-(-h // stride) - 1) * stride + window - h, 0)
    pad_w = max((-(-w // stride) - 1) * stride + window - w, 0)
    x = F.pad(x, (pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2))
    return F.avg_pool2d(x, window, stride)


def head_dropout(x: torch.Tensor, rate: float, train: bool,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """timm's head dropout before the classifier, as flax's ``nn.Dropout``:
    each element kept with probability 1 - rate and scaled by 1/(1 - rate).
    The identity unless training with rate > 0; ``generator`` draws the
    mask (None: torch's default generator)."""
    if rate <= 0.0 or not train:
        return x
    keep = 1.0 - rate
    dev = generator.device if generator is not None else x.device
    mask = torch.rand(x.shape, generator=generator, device=dev).to(x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """numpy's ``mode="reflect"`` as indices: the edge is not repeated, and a
    length-1 axis repeats its one value."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = i.remainder(period)
    return torch.where(i >= n, period - i, i)


def blur_pool(x: torch.Tensor, stride: int = 2, filt_size: int = 3) -> torch.Tensor:
    """BlurPool2d (``timm/models/layers/blur_pool.py:19-60``): reflect padding,
    then a binomial depthwise filter at ``stride``. The filter is a
    constant, made here, not a parameter or a buffer: the state dict has no
    ``filt``, as the JAX package's tree has none."""
    coeffs = [1.0]
    for _ in range(filt_size - 1):
        coeffs = [0.5 * a + 0.5 * b for a, b in zip(coeffs + [0.0], [0.0] + coeffs)]
    c = torch.tensor(coeffs, dtype=x.dtype, device=x.device)
    chs = x.shape[1]
    kernel = (c[:, None] * c[None, :]).expand(chs, 1, filt_size, filt_size)
    pad = ((stride - 1) + (filt_size - 1)) // 2
    h, w = x.shape[-2:]
    x = x.index_select(2, _reflect_index(h, pad, x.device))
    x = x.index_select(3, _reflect_index(w, pad, x.device))
    return act.linear(lambda a, k, b: F.conv2d(a, k, b, stride=stride, groups=chs), x, kernel)


def drop_path(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
              train: bool) -> torch.Tensor:
    """Stochastic depth (timm's ``DropPath``): each sample kept with
    probability 1 - rate and scaled by 1/(1 - rate). The identity unless
    training with rate > 0 and a ``generator``, as the JAX package's
    ``drop_path`` is without an rng."""
    if not train or rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    mask = torch.rand(shape, generator=generator, device=generator.device).to(x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class SqueezeExcite(nn.Module):
    """SE gate (timm's ``SEModule``): global average -> fc1 (bias) -> ReLU ->
    fc2 (bias) -> sigmoid scale, reduced to max(channels // 16, 8).

    fc1 and fc2 are flax ``nn.Conv`` in the JAX package, not its
    ``conv2d``: built as plain ``Conv2d``, they take the LeCun init and no
    conv policy replaces them. ``in_channels`` is the gated input's width
    where it is not ``channels`` (a pruned bottleneck keeps the unpruned
    count here, as JAX does)."""

    def __init__(self, channels: int, reduction: int = 16, min_channels: int = 8,
                 in_channels: Optional[int] = None, compute_dtype=None):
        super().__init__()
        reduced = max(channels // reduction, min_channels)
        self.fc1 = Conv2d(in_channels or channels, reduced, 1, bias=True,
                          compute_dtype=compute_dtype)
        self.fc2 = Conv2d(reduced, channels, 1, bias=True, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.fc2(act.relu(self.fc1(x.mean(dim=(2, 3), keepdim=True))))
        return x * torch.sigmoid(s)


def eca_kernel_size(channels: int, gamma: float = 2.0, beta: float = 1.0) -> int:
    """ECA's adaptive odd kernel size (``timm/models/layers/eca.py:41-73``)."""
    t = int(abs(math.log(channels, 2) + beta) / gamma)
    return max(t if t % 2 else t + 1, 3)


class Eca(nn.Module):
    """ECA gate: global average -> a bias-free ``Conv1d`` over the channel
    descriptor with the adaptive kernel -> sigmoid scale."""

    def __init__(self, channels: int, gamma: float = 2.0, beta: float = 1.0,
                 compute_dtype=None):
        super().__init__()
        k = eca_kernel_size(channels, gamma, beta)
        self.conv = Conv1d(1, 1, k, padding=(k - 1) // 2, bias=False,
                           compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.conv(x.mean(dim=(2, 3))[:, None, :])[:, 0]  # (B, C)
        return x * torch.sigmoid(s)[:, :, None, None]


class SpaceToDepthStemConv(Conv2d):
    """A stride-2 odd-kernel conv computed through space-to-depth, exactly.

    The input's 2x2 blocks become channels, (B, C, H, W) -> (B, 4C, H/2,
    W/2), and the k x k taps are scattered into the equivalent block-space
    kernel, so the conv runs at stride 1 on a quarter of the positions with
    the same products. The parameter is the plain conv's ``weight`` (out,
    in, k, k), so checkpoints load unchanged. Odd input sizes take the
    strided conv itself, as the JAX package's does."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 bias: bool = False, compute_dtype=None):
        if kernel_size % 2 != 1:
            raise ValueError("SpaceToDepthStemConv takes odd kernels only")
        super().__init__(in_channels, out_channels, kernel_size, stride=2,
                         padding=(kernel_size - 1) // 2, bias=bias,
                         compute_dtype=compute_dtype)
        self.fan_out_init = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        x, w = x.to(dt), self.weight.to(dt)
        bias = None if self.bias is None else self.bias.to(dt)
        b, cin, h, wd = x.shape
        k = self.kernel_size[0]
        p = (k - 1) // 2
        if h % 2 or wd % 2:
            return act.linear(lambda a, k, b: F.conv2d(a, k, b, stride=2, padding=p),
                              x, w, bias)
        dp_min, dp_max = -((p + 1) // 2), p // 2
        bk = dp_max - dp_min + 1
        # w2[o, (a*2 + b)*C + c, kp, kq] = w[o, c, 2(kp + dp_min) + a + p, ...]
        w2 = w.new_zeros((w.shape[0], 4 * cin, bk, bk))
        for kp in range(bk):
            for a in range(2):
                di = 2 * (kp + dp_min) + a
                if not -p <= di <= p:
                    continue
                for kq in range(bk):
                    for bb in range(2):
                        dj = 2 * (kq + dp_min) + bb
                        if -p <= dj <= p:
                            ch = (a * 2 + bb) * cin
                            w2[:, ch:ch + cin, kp, kq] = w[:, :, di + p, dj + p]
        y = x.reshape(b, cin, h // 2, 2, wd // 2, 2).permute(0, 3, 5, 1, 2, 4)
        y = F.pad(y.reshape(b, 4 * cin, h // 2, wd // 2), (-dp_min, dp_max, -dp_min, dp_max))
        return act.linear(F.conv2d, y, w2, bias)
