"""Readout IBA (counterpart of ``scouter_tpu/explain/iba_readout.py``; the
capability of ``torchcam/IBA/pytorch_readout.py``).

In place of a per-sample ``alpha`` (iba.py), a small readout net (three 1x1
convs, conv3 started near identity: weights x1e-3, bias 5,
pytorch_readout.py:46-64) predicts alpha from the NORMALISED intermediate
feature maps of a nested forward, resized to the bottleneck's resolution.
It is trained once over a dataset on the IBA objective (model loss + beta x
mean capacity) with optax's Adam; analysis is one forward. Feature maps are
NCHW. ``models.convert.readout_params_to_state_dict`` carries a flax
``ReadoutNet``'s parameters into :class:`ReadoutNet`.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
from torch import nn

from ..models.layers import Conv2d
from ._resize import resize_bilinear
from .iba import FeatureStats, _Adam, _capacity, _gaussian_smooth, _saliency

__all__ = ["ReadoutNet", "readout_inputs", "train_readout", "readout_analyze"]


class ReadoutNet(nn.Module):
    """1x1 conv stack: in -> in//2 -> 2*out -> out (alpha logits). flax
    infers ``in_channels``; a torch module is built with it. conv3 starts
    near the identity, its kernel x1e-3 and its bias 5 (:60-62)."""

    def __init__(self, out_channels: int, in_channels: int):
        super().__init__()
        self.conv1 = Conv2d(in_channels, in_channels // 2, 1, bias=True)
        self.conv2 = Conv2d(in_channels // 2, out_channels * 2, 1, bias=True)
        self.conv3 = Conv2d(out_channels * 2, out_channels, 1, bias=True)
        with torch.no_grad():
            self.conv3.weight.mul_(1e-3)
            self.conv3.bias.fill_(5.0)

    def forward(self, x):
        x = torch.relu(self.conv1(x))
        x = torch.relu(self.conv2(x))
        return self.conv3(x)


def readout_inputs(feature_maps: Sequence[torch.Tensor], stats: Sequence[FeatureStats],
                   target_hw) -> torch.Tensor:
    """Each readout layer's features normalised and resized to the
    bottleneck's resolution, concatenated over channels. feature_maps: a
    list of (B, C, h, w)."""
    outs = []
    for f, s in zip(feature_maps, stats):
        z = (f - s.mean) / s.std.clamp_min(1e-5)
        if tuple(z.shape[2:]) != tuple(target_hw):
            z = resize_bilinear(z, tuple(target_hw))
        outs.append(z)
    return torch.cat(outs, dim=1)


def _bottleneck_forward(readout, inputs, feats, stats: FeatureStats, eps, sigma, min_std):
    lam = _gaussian_smooth(torch.sigmoid(readout(inputs)), sigma)
    std = stats.std.clamp_min(min_std)
    capacity = _capacity(feats, lam, stats.mean, std) * stats.active
    z = (lam * feats + (1.0 - lam) * (std * eps + stats.mean)) * stats.active
    return z, capacity


def train_readout(
    readout: ReadoutNet,
    batches: Callable,
    feature_fn: Callable,
    readout_feature_fn: Callable,
    readout_stats: Sequence[FeatureStats],
    bottleneck_stats: FeatureStats,
    model_loss_fn: Callable,
    seed: int = 0,
    *,
    steps: int = 100,
    lr: float = 1e-3,
    beta: float = 10.0,
    sigma: float = 1.0,
    min_std: float = 0.01,
    draw_eps: Optional[Callable[[int, torch.Size], torch.Tensor]] = None,
):
    """Train the readout net in place over a dataset (the pytorch_readout
    training loop). ``batches()`` yields (images, aux); ``feature_fn`` maps
    images to bottleneck features, ``readout_feature_fn`` to the list of
    readout maps; ``model_loss_fn(z, aux)`` completes the network from the
    bottlenecked features. ``draw_eps(step, shape)`` gives each step's noise
    (default N(0, 1) from ``seed``). Returns (readout, losses)."""
    params = list(readout.parameters())
    opts = [_Adam(p.detach(), lr) for p in params]
    if draw_eps is None:
        gen = torch.Generator().manual_seed(seed)

        def draw_eps(step, shape):
            return torch.randn(shape, generator=gen)

    losses: List[float] = []
    it = batches()
    for i in range(steps):
        try:
            images, aux = next(it)
        except StopIteration:
            it = batches()
            images, aux = next(it)
        with torch.no_grad():
            feats = feature_fn(images)
            inputs = readout_inputs(readout_feature_fn(images), readout_stats, feats.shape[2:])
        eps = draw_eps(i, feats.shape).to(feats.device)
        with torch.enable_grad():
            z, capacity = _bottleneck_forward(readout, inputs, feats, bottleneck_stats, eps,
                                              sigma, min_std)
            loss = model_loss_fn(z, aux) + beta * capacity.mean()
            grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for p, g, opt in zip(params, grads, opts):
                p.copy_(opt.step(p.detach(), g))
        losses.append(float(loss.detach()))
    return readout, losses


def readout_analyze(
    readout: ReadoutNet,
    image,
    feature_fn: Callable,
    readout_feature_fn: Callable,
    readout_stats: Sequence[FeatureStats],
    bottleneck_stats: FeatureStats,
    *,
    sigma: float = 1.0,
    min_std: float = 0.01,
    out_shape=None,
) -> torch.Tensor:
    """Single-pass saliency from the trained readout (analyze)."""
    with torch.no_grad():
        feats = feature_fn(image)
        inputs = readout_inputs(readout_feature_fn(image), readout_stats, feats.shape[2:])
        lam = _gaussian_smooth(torch.sigmoid(readout(inputs)), sigma)
        std = bottleneck_stats.std.clamp_min(min_std)
        capacity = _capacity(feats, lam, bottleneck_stats.mean, std) * bottleneck_stats.active
    return _saliency(capacity[0], out_shape)

