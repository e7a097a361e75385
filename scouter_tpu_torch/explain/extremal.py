"""Extremal perturbation (counterpart of ``scouter_tpu/explain/extremal.py``;
the capability of ``torchray/attribution/extremal_perturbation.py:90-691``).

- the blur/fade perturbation pyramid with per-pixel level interpolation
  (Perturbation, :90-220);
- the smooth-max mask generator from a low-resolution parameterisation:
  patch unfold, nearest upsample, radial kernel weights, coldness-20
  softmax pooling (MaskGenerator, :318-453);
- the simple and contrastive rewards (:230-316);
- 800 steps of SGD (momentum 0.9 with dampening 0.9) maximising the reward
  plus a sorted-mask area regulariser whose weight grows x1.0035 a step
  (:456-691).

JAX runs the steps as one ``lax.scan``; here they are a Python loop of
eager launches on the device, with JAX's hand-written momentum step.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "imsmooth",
    "perturbation_pyramid",
    "apply_pyramid",
    "MaskGenerator",
    "simple_reward",
    "contrastive_reward",
    "extremal_perturbation",
]

BLUR = "blur"
FADE = "fade"
PRESERVE = "preserve"
DELETE = "delete"
DUAL = "dual"

_SQRT2 = float(np.sqrt(np.float32(2.0)))
_EPS = float(np.finfo(np.float32).eps)


def imsmooth(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur, kernel half-width ceil(4*sigma), zero padding
    (``torchray/utils.py:344-409``). x: (B, C, H, W)."""
    if sigma <= 0:
        return x
    width = int(math.ceil(4 * sigma))
    i = np.arange(-width, width + 1, dtype=np.float32) / (_SQRT2 * sigma + _EPS)
    filt = np.exp(-i * i)
    filt /= filt.sum()
    k = torch.from_numpy(filt).to(x.device, x.dtype)
    b, c, h, w = x.shape
    xt = x.reshape(b * c, 1, h, w)
    out = F.conv2d(xt, k.view(1, 1, -1, 1), padding=(width, 0))
    out = F.conv2d(out, k.view(1, 1, 1, -1), padding=(0, width))
    return out.reshape(b, c, h, w)


def perturbation_pyramid(x: torch.Tensor, num_levels: int = 8, max_blur: float = 20.0,
                         kind: str = BLUR) -> torch.Tensor:
    """(L, C, H, W) pyramid; level L-1 is the input itself (Perturbation:141-156)."""
    levels = []
    for s in np.linspace(0.0, 1.0, num_levels):
        if kind == BLUR:
            levels.append(imsmooth(x, (1.0 - s) * max_blur)[0])
        elif kind == FADE:
            levels.append(x[0] * s)
        else:
            raise ValueError(kind)
    return torch.stack(levels)


def apply_pyramid(pyramid: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-pixel linear interpolation across the pyramid's levels
    (Perturbation.apply :158-204). pyramid: (L, C, H, W); mask: (K, H, W) in
    [0, 1] -> (K, C, H, W)."""
    levels = pyramid.shape[0]
    w = mask * (levels - 1)
    k = torch.floor(w)
    frac = (w - k)[:, None]  # (K, 1, H, W)
    k = k[:, None]
    nxt = (k + 1).clamp(max=levels - 1)
    out = torch.zeros((mask.shape[0], *pyramid.shape[1:]), dtype=pyramid.dtype,
                      device=pyramid.device)
    for lvl in range(levels):
        w0 = (k == lvl).to(pyramid.dtype) * (1.0 - frac)
        w1 = (nxt == lvl).to(pyramid.dtype) * frac
        out = out + (w0 + w1) * pyramid[lvl]
    return out


class MaskGenerator:
    """Smooth-max mask generator (MaskGenerator:318-453). The radial kernel
    weights are made once with numpy; ``generate`` runs on the mask's
    device."""

    def __init__(self, shape: Tuple[int, int], step: int = 7, sigma: float = 21.0,
                 clamp: bool = True, pooling_method: str = "softmax"):
        self.shape = tuple(shape)
        self.step = int(step)
        self.sigma = float(sigma)
        self.coldness = 20.0
        self.clamp = clamp
        self.pooling_method = pooling_method

        self.margin = self.sigma
        self.padding = 1 + math.ceil((self.margin + sigma) / step)
        self.radius = 1 + math.ceil(sigma / step)
        self.shape_in = [math.ceil(z / step) for z in self.shape]
        self.shape_mid = [
            z + 2 * self.padding - (2 * self.radius + 1) + 1 for z in self.shape_in
        ]
        self.shape_up = [self.step * z for z in self.shape_mid]
        self.shape_out = [z - step + 1 for z in self.shape_up]

        kside = 2 * self.radius + 1
        weight = np.zeros((1, kside ** 2, *self.shape_out), np.float32)
        step_inv = [zm / zo for zm, zo in zip(self.shape_mid, self.shape_up)]
        uy, ux = np.meshgrid(
            np.arange(self.shape_out[0], dtype=np.float32),
            np.arange(self.shape_out[1], dtype=np.float32),
            indexing="ij",
        )
        for ky in range(kside):
            for kx in range(kside):
                iy = np.floor(step_inv[0] * uy) + ky - self.padding
                ix = np.floor(step_inv[1] * ux) + kx - self.padding
                delta = np.sqrt(
                    (uy - (self.margin + self.step * iy)) ** 2
                    + (ux - (self.margin + self.step * ix)) ** 2
                )
                z = delta / sigma
                weight[0, ky * kside + kx] = np.exp(
                    -2.0 * np.clip(z - 0.5, 0.0, None) ** 2
                )  # kernel (:429)
        self.weight = torch.from_numpy(weight)

    def generate(self, pmask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """pmask: (K, h_in, w_in) -> (cropped (K, H, W), full (K, Ho, Wo))."""
        k = pmask.shape[0]
        kside = 2 * self.radius + 1
        patches = F.unfold(pmask[:, None], kside, padding=self.padding)
        hm, wm = self.shape_mid
        patches = patches.reshape(k, kside * kside, hm, wm)
        up = patches.repeat_interleave(self.step, dim=2).repeat_interleave(self.step, dim=3)
        up = up[:, :, : self.shape_out[0], : self.shape_out[1]]  # negative pad (:439)
        # moved once, to the first mask's device and dtype
        self.weight = self.weight.to(pmask.device, pmask.dtype)
        m = self.weight * up

        if self.pooling_method == "softmax":
            pooled = (m * torch.softmax(self.coldness * m, dim=1)).sum(1)
        elif self.pooling_method == "sigmoid":
            pooled = torch.sigmoid(self.coldness * m.sum(1) - 3.0)
        elif self.pooling_method == "sum":
            pooled = m.sum(1)
        else:
            raise ValueError(self.pooling_method)

        if self.clamp:
            pooled = pooled.clamp(0.0, 1.0)
        mg = int(round(self.margin))
        cropped = pooled[:, mg: mg + self.shape[0], mg: mg + self.shape[1]]
        return cropped, pooled


def simple_reward(y: torch.Tensor, target: int, variant: str) -> torch.Tensor:
    if variant == DELETE:
        return -y[:, target]
    if variant == PRESERVE:
        return y[:, target]
    if variant == DUAL:
        n = y.shape[0] // 2
        return y[:n, target] - y[n:, target]
    raise ValueError(variant)


def contrastive_reward(y: torch.Tensor, target: int, variant: str) -> torch.Tensor:
    def get(pred):
        masked = pred.clone()
        masked[:, target] = -100.0
        return pred[:, target] - masked.amax(dim=1)

    if variant == DELETE:
        return -get(y)
    if variant == PRESERVE:
        return get(y)
    if variant == DUAL:
        n = y.shape[0] // 2
        return get(y[:n]) - get(y[n:])
    raise ValueError(variant)


def extremal_perturbation(
    forward,
    x: torch.Tensor,
    target: int,
    areas: Sequence[float] = (0.1,),
    *,
    perturbation: str = BLUR,
    max_iter: int = 800,
    num_levels: int = 8,
    step: int = 7,
    sigma: float = 21.0,
    jitter: bool = True,
    variant: str = PRESERVE,
    reward_func=simple_reward,
    smooth: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (1, C, H, W). Returns (masks (K, 1, H, W), history (K, 2,
    max_iter): [reward, regul])."""
    momentum = 0.9
    learning_rate = 0.01
    regul_weight0 = 300.0

    h, w = x.shape[2:]
    dev = x.device
    with torch.no_grad():
        pyramid = perturbation_pyramid(x, num_levels, kind=perturbation)
    gen = MaskGenerator((h, w), step, sigma)
    k_areas = len(areas)

    max_area = int(np.prod(gen.shape_out))
    reference = np.ones((k_areas, max_area), np.float32)
    for i, a in enumerate(areas):
        reference[i, : int(max_area * (1 - a))] = 0.0
    dt = torch.promote_types(x.dtype, torch.float32)  # the mask's dtype
    reference = torch.from_numpy(reference).to(dev, dt)

    def energy(pmask, t):
        cropped, full = gen.generate(pmask)
        if variant == DELETE:
            imgs = apply_pyramid(pyramid, 1.0 - cropped)
        elif variant == PRESERVE:
            imgs = apply_pyramid(pyramid, cropped)
        else:  # DUAL
            imgs = torch.cat([apply_pyramid(pyramid, cropped),
                              apply_pyramid(pyramid, 1.0 - cropped)])
        if jitter and t % 2 == 0:
            imgs = imgs.flip(3)
        y = forward(imgs)
        reward = reward_func(y, target, variant).reshape(k_areas, -1).mean(dim=1)
        mask_sorted = torch.sort(full.reshape(k_areas, -1), dim=1).values
        regul_weight = regul_weight0 * float(np.float32(1.0035) ** np.float32(t))
        regul = -((mask_sorted - reference) ** 2).mean(dim=1) * regul_weight
        return -(reward + regul).sum(), reward.detach(), regul.detach()

    pmask = torch.ones((k_areas, *gen.shape_in), dtype=dt, device=dev)
    vel = None
    rewards, reguls = [], []
    # the reference returns the mask generated from pmask at the TOP of the
    # last iteration, before its optimizer.step() (extremal_perturbation.py
    # :586,674): max_iter - 1 updates, then the last energy for the history
    for t in range(max_iter):
        with torch.enable_grad():
            p = pmask.detach().requires_grad_(True)
            loss, reward, regul = energy(p, t)
            grads = torch.autograd.grad(loss, p)[0] if t < max_iter - 1 else None
        rewards.append(reward)
        reguls.append(regul)
        if grads is None:
            break
        # torch SGD(momentum=m, dampening=m): v <- m*v + (1-m)*g, p <- p - lr*v;
        # the first step sets the buffer to the raw gradient
        vel = grads if vel is None else momentum * vel + (1.0 - momentum) * grads
        pmask = (pmask - learning_rate * vel).clamp(0.0, 1.0)
    with torch.no_grad():
        cropped, _ = gen.generate(pmask)
        masks = cropped[:, None]
        if smooth > 0:
            masks = imsmooth(masks, smooth * min(h, w))
    hist = torch.stack([torch.stack(rewards, dim=1), torch.stack(reguls, dim=1)], dim=1)
    return masks, hist
