"""The timm layer-library members outside the ResNet zoo's own layers
(counterpart of ``scouter_tpu/models/extra_layers.py``): CBAM and light
CBAM, circular ECA, the ``create_attn`` switchboard the ResNet blocks
consult, the median filter, AdvProp's split BatchNorm, the avg+max pool
and the test-time pooling head.

Module names follow the JAX package's (``channel.fc1``,
``spatial.conv.conv``, ``aux_bn.0``), so ``variables_to_state_dict``
carries its trees here unchanged.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import act
from .layers import (
    Conv1d,
    Conv2d,
    Eca,
    SqueezeExcite,
    _reflect_index,
    avg_pool_include_pad,
    batch_norm,
    conv2d,
    eca_kernel_size,
)

__all__ = [
    "CbamModule", "LightCbamModule", "Ceca", "create_attn",
    "median_pool2d", "SplitBatchNorm", "adaptive_avgmax_pool",
    "test_time_pool",
]


class _ChannelAttn(nn.Module):
    """CBAM channel attention (``layers/cbam.py:16-33``): a shared bias-free
    1x1 MLP over the average- and max-pooled descriptors, summed; ``light``
    averages the two pools first (:36-45). fc1/fc2 are flax ``nn.Conv`` in
    JAX: plain ``Conv2d`` here (LeCun init, no conv policy)."""

    def __init__(self, channels: int, in_channels: int, reduction: int = 16,
                 light: bool = False, compute_dtype=None):
        super().__init__()
        self.light = light
        self.fc1 = Conv2d(in_channels, channels // reduction, 1, bias=False,
                          compute_dtype=compute_dtype)
        self.fc2 = Conv2d(channels // reduction, channels, 1, bias=False,
                          compute_dtype=compute_dtype)

    def forward(self, x):
        avg = x.mean(dim=(2, 3), keepdim=True)
        mx = x.amax(dim=(2, 3), keepdim=True)
        if self.light:
            attn = self.fc2(act.relu(self.fc1(0.5 * avg + 0.5 * mx)))
        else:
            attn = self.fc2(act.relu(self.fc1(avg))) + self.fc2(act.relu(self.fc1(mx)))
        return x * torch.sigmoid(attn)


class _ConvBn(nn.Module):
    """ConvBnAct without the act (children ``conv``, ``bn``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 compute_dtype=None):
        super().__init__()
        self.conv = conv2d(in_channels, out_channels, kernel_size, compute_dtype=compute_dtype)
        self.bn = batch_norm(out_channels, compute_dtype=compute_dtype)

    def forward(self, x):
        return self.bn(self.conv(x))


class _SpatialAttn(nn.Module):
    """CBAM spatial attention (``layers/cbam.py:48-76``): the channel mean
    and max maps, concatenated (averaged when ``light``), through a ConvBn
    without act, as a sigmoid gate."""

    def __init__(self, kernel_size: int = 7, light: bool = False, compute_dtype=None):
        super().__init__()
        self.light = light
        self.conv = _ConvBn(1 if light else 2, 1, kernel_size, compute_dtype)

    def forward(self, x):
        avg = x.mean(dim=1, keepdim=True)
        mx = x.amax(dim=1, keepdim=True)
        attn = 0.5 * avg + 0.5 * mx if self.light else torch.cat([avg, mx], dim=1)
        return x * torch.sigmoid(self.conv(attn))


class CbamModule(nn.Module):
    """CBAM (``layers/cbam.py:79-88``): channel attention, then spatial. Its
    BatchNorm follows the module's train mode, the ``train`` flag of JAX's.
    ``in_channels`` is the gated tensor's width where it is not
    ``channels``."""

    light = False

    def __init__(self, channels: int, spatial_kernel_size: int = 7,
                 in_channels: Optional[int] = None, compute_dtype=None):
        super().__init__()
        self.channel = _ChannelAttn(channels, in_channels or channels, light=self.light,
                                    compute_dtype=compute_dtype)
        self.spatial = _SpatialAttn(spatial_kernel_size, light=self.light,
                                    compute_dtype=compute_dtype)

    def forward(self, x):
        return self.spatial(self.channel(x))


class LightCbamModule(CbamModule):
    """Light CBAM (``layers/cbam.py:91-100``)."""

    light = True


class Ceca(nn.Module):
    """Circular-padding ECA (``layers/eca.py:75-131``): the 1-D conv over the
    channel descriptor wraps around instead of zero padding."""

    def __init__(self, channels: int, gamma: float = 2.0, beta: float = 1.0,
                 compute_dtype=None):
        super().__init__()
        k = eca_kernel_size(channels, gamma, beta)
        self.pad = (k - 1) // 2
        self.conv = Conv1d(1, 1, k, padding=0, bias=False, compute_dtype=compute_dtype)

    def forward(self, x):
        s = x.mean(dim=(2, 3))  # (B, C)
        p = self.pad
        s = torch.cat([s[:, -p:], s, s[:, :p]], dim=1)
        s = self.conv(s[:, None, :])[:, 0]
        return x * torch.sigmoid(s)[:, :, None, None]


def create_attn(attn_type, channels: int, in_channels: Optional[int] = None,
                compute_dtype=None) -> Optional[nn.Module]:
    """``timm/models/layers/create_attn.py:11-37``: '' | 'se' | 'eca' |
    'ceca' | 'cbam' | 'lcbam' | 'ese', or None; another kind raises
    ValueError. ``channels`` is the unpruned width the module is sized by,
    ``in_channels`` the gated tensor's (default ``channels``)."""
    if not attn_type:
        return None
    kind = attn_type.lower()
    dt = compute_dtype
    if kind == "se":
        return SqueezeExcite(channels, in_channels=in_channels, compute_dtype=dt)
    if kind == "eca":
        return Eca(channels, compute_dtype=dt)
    if kind == "ceca":
        return Ceca(channels, compute_dtype=dt)
    if kind == "cbam":
        return CbamModule(channels, in_channels=in_channels, compute_dtype=dt)
    if kind == "lcbam":
        return LightCbamModule(channels, in_channels=in_channels, compute_dtype=dt)
    if kind == "ese":
        from .vovnet import _Ese

        return _Ese(channels, in_channels=in_channels, compute_dtype=dt)
    raise ValueError(f"invalid attn module {attn_type!r}")


def median_pool2d(x: torch.Tensor, kernel_size=3, stride=1, padding=0,
                  same: bool = False) -> torch.Tensor:
    """MedianPool2d (``layers/median_pool.py:8-49``) on (B, C, H, W): reflect
    padding, then each window's median, numpy's (the mean of the two middle
    values of an even window). ``padding`` is (left, right, top, bottom)
    as ``F.pad`` takes it, or one int for all four."""
    kh, kw = (kernel_size, kernel_size) if isinstance(kernel_size, int) else kernel_size
    sh, sw = (stride, stride) if isinstance(stride, int) else stride
    h, w = x.shape[-2:]
    if same:
        ph = max(kh - sh, 0) if h % sh == 0 else max(kh - (h % sh), 0)
        pw = max(kw - sw, 0) if w % sw == 0 else max(kw - (w % sw), 0)
        pl, pt = pw // 2, ph // 2
        pr, pb = pw - pl, ph - pt
    elif isinstance(padding, int):
        pl = pr = pt = pb = padding
    else:
        pl, pr, pt, pb = padding
    x = x.index_select(2, _reflect_span(h, pt, pb, x.device))
    x = x.index_select(3, _reflect_span(w, pl, pr, x.device))
    windows = x.unfold(2, kh, sh).unfold(3, kw, sw).flatten(-2)  # (B, C, OH, OW, kh*kw)
    s = windows.sort(dim=-1).values
    n = kh * kw
    return 0.5 * (s[..., (n - 1) // 2] + s[..., n // 2])


def _reflect_span(n: int, lo: int, hi: int, device) -> torch.Tensor:
    """numpy's reflect padding of an axis of ``n`` by ``lo`` and ``hi``, as
    indices."""
    p = max(lo, hi)
    return _reflect_index(n, p, device)[p - lo:p + n + hi]


class SplitBatchNorm(nn.Module):
    """AdvProp's auxiliary BatchNorm (``layers/split_batchnorm.py:19-38``):
    in train mode the batch splits into ``num_splits`` equal parts, the
    first through the main BatchNorm ``bn``, the others through
    ``aux_bn.{i}``; eval mode uses ``bn`` alone."""

    def __init__(self, num_features: int, num_splits: int = 2, eps: float = 1e-5,
                 compute_dtype=None):
        super().__init__()
        self.num_splits = num_splits
        self.bn = batch_norm(num_features, eps=eps, compute_dtype=compute_dtype)
        self.aux_bn = nn.ModuleList(batch_norm(num_features, eps=eps, compute_dtype=compute_dtype)
                                    for _ in range(num_splits - 1))

    def forward(self, x):
        if not self.training:
            return self.bn(x)
        n = x.shape[0]
        split = n // self.num_splits
        if n != split * self.num_splits:
            raise ValueError(f"batch {n} does not divide into {self.num_splits} splits")
        parts = x.split(split)
        return torch.cat([self.bn(parts[0])] + [bn(p) for bn, p in zip(self.aux_bn, parts[1:])])


def adaptive_avgmax_pool(x: torch.Tensor) -> torch.Tensor:
    """0.5 x (global average + global max), (B, C, H, W) -> (B, C)
    (``layers/adaptive_avgmax_pool.py:24-27``)."""
    return 0.5 * (x.mean(dim=(2, 3)) + x.amax(dim=(2, 3)))


def test_time_pool(model: nn.Module, x: torch.Tensor, num_classes: int,
                   original_pool: int = 7, classifier: str = "fc") -> torch.Tensor:
    """TestTimePoolHead (``layers/test_time_pool.py:13-34``): at a test
    resolution above the training one, average-pool ``model``'s features
    with the training pool size at stride 1, apply its ``classifier``
    Linear as a 1x1 conv at every remaining position, and avg+max-pool the
    class maps. The JAX package takes the model and its variables; a torch
    module carries its own."""
    del num_classes  # the classifier's rows give it
    feats = avg_pool_include_pad(model(x, features_only=True), original_pool, 1, 0)
    head = getattr(model, classifier)
    out = F.conv2d(feats, head.weight[:, :, None, None].to(feats.dtype),
                   None if head.bias is None else head.bias.to(feats.dtype))
    return adaptive_avgmax_pool(out)


test_time_pool.__test__ = False  # a model function, not a test for pytest to collect
