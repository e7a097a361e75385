"""Information Bottleneck Attribution (counterpart of
``scouter_tpu/explain/iba.py``; the capability of
``torchcam/IBA/pytorch.py:129-626``).

1. Feature statistics by a streaming Welford-equivalent estimator
   (TorchWelfordEstimator, :129-201): per-neuron mean, std (ddof=1) and
   active mask (nonzero fraction > threshold), combined on the device a
   batch at a time.
2. Per-sample analysis (:534-607): a per-neuron logit map ``alpha`` (init
   5.0) optimised with Adam(lr=1) for 10 steps on ``model_loss + beta *
   capacity.mean()``, the bottleneck replacing features by ``z = lam*x +
   (1-lam)*(std*eps + mean)`` with ``lam = smooth(sigmoid(alpha))``
   (Gaussian, sigma 1) and the capacity the feature-wise KL (:395-409).
3. Saliency: the channel-summed capacity in bits, rescaled and bilinearly
   resized to the input (:617-626, utils.py:128-150).

Features are NCHW: (B, K, h, w), statistics (K, h, w). The Adam step is
optax's (eps outside the square root, no eps_root), in its order. The
noise ``eps`` is drawn per step from a ``torch.Generator`` on the CPU
(``seed``), or given by ``draw_eps``.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.layers import _reflect_index
from ._resize import resize_bilinear

__all__ = ["FeatureStats", "estimate_stats", "iba_analyze"]


class FeatureStats(NamedTuple):
    mean: torch.Tensor
    std: torch.Tensor
    active: torch.Tensor  # float mask
    n_samples: int


def estimate_stats(feature_fn: Callable, batches: Iterable[torch.Tensor],
                   active_threshold: float = 0.01) -> FeatureStats:
    """Streaming per-neuron mean/std(ddof=1)/active fraction over batches,
    by the parallel combine form of the reference's per-sample Welford
    update (pytorch.py:171-183), each batch's combine on the device, in
    float32 (float64 for float64 features)."""
    n = None
    mean = m2 = nonzero = None
    with torch.no_grad():
        for batch in batches:
            feats = feature_fn(batch)  # (B, ...)
            b = feats.shape[0]
            b_mean = feats.mean(dim=0)
            b_m2 = ((feats - b_mean) ** 2).sum(dim=0)
            b_nonzero = (feats != 0).sum(dim=0)
            if mean is None:
                dt = torch.promote_types(feats.dtype, torch.float32)
                n = torch.zeros((), dtype=dt, device=feats.device)
                mean = torch.zeros(feats.shape[1:], dtype=dt, device=feats.device)
                m2 = torch.zeros_like(mean)
                nonzero = torch.zeros_like(mean)
            delta = b_mean - mean
            tot = n + b
            # n = 0 degenerates to (b_mean, b_m2), the host loop's first batch
            mean = mean + delta * (b / tot)
            m2 = m2 + b_m2 + delta ** 2 * (n * b / tot)
            nonzero = nonzero + b_nonzero
            n = tot
    count = int(n.item())
    std = torch.sqrt(m2 / max(count - 1, 1))
    active = (nonzero / count) > active_threshold
    return FeatureStats(mean=mean, std=std, active=active.to(mean.dtype), n_samples=count)


def _gaussian_smooth(lam: torch.Tensor, sigma: float) -> torch.Tensor:
    """Fixed 2-D Gaussian depthwise conv with reflection padding
    (_SpatialGaussianKernel, pytorch.py:94-127). lam: (B, C, H, W)."""
    if sigma is None or sigma <= 0:
        return lam
    ks = int(round(2 * sigma)) * 2 + 1
    coords = np.arange(ks, dtype=np.float32)
    g = np.exp(-((coords - (ks - 1) / 2.0) ** 2) / (2 * sigma ** 2))
    k2d = np.outer(g, g)
    k2d /= k2d.sum()
    pad = (ks - 1) // 2
    h, w = lam.shape[2:]
    lam = lam.index_select(2, _reflect_index(h, pad, lam.device))
    lam = lam.index_select(3, _reflect_index(w, pad, lam.device))
    c = lam.shape[1]
    kernel = torch.from_numpy(k2d.astype(np.float32)).to(lam.device, lam.dtype)
    return F.conv2d(lam, kernel.expand(c, 1, ks, ks), groups=c)


def _capacity(x, lam, mean, std):
    """Feature-wise KL of p(z|x) against q(z) (_kl_div, pytorch.py:400-409)."""
    r_norm = (x - mean) / std
    var_z = (1.0 - lam) ** 2
    log_var_z = torch.log(var_z)
    mu_z = r_norm * lam
    return -0.5 * (1 + log_var_z - mu_z ** 2 - var_z)


class _Adam:
    """optax.adam(lr) (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) in optax's
    order of operations."""

    def __init__(self, param: torch.Tensor, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = torch.zeros_like(param)
        self.nu = torch.zeros_like(param)
        self.count = 0

    def step(self, param: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
        f32 = np.float32
        self.mu = (1 - self.b1) * grad + self.b1 * self.mu
        self.nu = (1 - self.b2) * grad ** 2 + self.b2 * self.nu
        self.count += 1
        mu_hat = self.mu / float(1 - f32(self.b1) ** f32(self.count))
        nu_hat = self.nu / float(1 - f32(self.b2) ** f32(self.count))
        update = -self.lr * (mu_hat / (torch.sqrt(nu_hat) + self.eps))
        return param + update


def _saliency(capacity: torch.Tensor, out_shape: Optional[Tuple[int, int]]) -> torch.Tensor:
    """(C, h, w) capacity -> channel sum in bits, rescaled and resized."""
    saliency = torch.nansum(capacity, dim=0) / math.log(2.0)  # bits (:141-142)
    if out_shape is not None:
        ho, wo = saliency.shape
        h, w = out_shape
        saliency = saliency * (ho * wo) / (h * w)
        saliency = resize_bilinear(saliency, tuple(out_shape))
    return saliency


def iba_analyze(
    feature_fn: Callable,
    readout_loss_fn: Callable,
    x: torch.Tensor,
    stats: FeatureStats,
    seed: int = 0,
    *,
    beta: float = 10.0,
    optimization_steps: int = 10,
    lr: float = 1.0,
    batch_size: int = 10,
    sigma: float = 1.0,
    min_std: float = 0.01,
    initial_alpha: float = 5.0,
    out_shape: Optional[Tuple[int, int]] = None,
    draw_eps: Optional[Callable[[int], torch.Tensor]] = None,
) -> torch.Tensor:
    """Per-sample IBA saliency.

    feature_fn: (1, C_in, H, W) image -> (1, C, h, w) features at the
    bottleneck; readout_loss_fn: (B, C, h, w) bottlenecked features ->
    scalar model loss; stats: from :func:`estimate_stats` at the same layer;
    ``draw_eps(t)``: step t's (batch_size, C, h, w) noise (default N(0, 1)
    from ``seed``). Returns the (h, w), or ``out_shape``, map in bits."""
    with torch.no_grad():
        feats = feature_fn(x)  # (1, C, h, w)
    feats_b = feats.expand(batch_size, *feats.shape[1:])
    std = stats.std.clamp_min(min_std)
    mean, active = stats.mean, stats.active
    if draw_eps is None:
        gen = torch.Generator().manual_seed(seed)

        def draw_eps(t):
            return torch.randn(feats_b.shape, generator=gen).to(feats.device, alpha.dtype)

    alpha = torch.full(feats.shape[1:], initial_alpha,
                       dtype=torch.promote_types(feats.dtype, torch.float32), device=feats.device)
    opt = _Adam(alpha, lr)
    capacity = None
    for t in range(optimization_steps):
        eps = draw_eps(t)
        with torch.enable_grad():
            a = alpha.detach().requires_grad_(True)
            lam = torch.sigmoid(a)[None].expand(feats_b.shape)
            lam = _gaussian_smooth(lam, sigma)
            capacity = _capacity(feats_b, lam, mean, std) * active
            z = (lam * feats_b + (1.0 - lam) * (std * eps + mean)) * active
            loss = readout_loss_fn(z) + beta * capacity.mean()
            (grad,) = torch.autograd.grad(loss, a)
        alpha = opt.step(alpha, grad)
    capacity = capacity.detach().mean(dim=0)  # (C, h, w), batch-averaged (:612-615)
    return _saliency(capacity, out_shape)
