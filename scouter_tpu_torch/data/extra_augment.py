"""Batch-level augmentations (counterpart of ``scouter_tpu/data/extra_augment.py``,
timm's ``timm/data/mixup.py`` and ``random_erasing.py``), on the images'
device.

- :func:`mixup`: a convex combination of the batch with its reverse, one
  lambda a batch, plus label smoothing into soft targets;
- :func:`random_erasing`: a random rectangle of each chosen image replaced
  by gaussian noise ('pixel' mode), as masks (no per-image launches).

Images are (B, C, H, W). The random draws come from an explicit CPU
``torch.Generator``, so the card and the CPU see the same draws; each
function also takes its draws as arguments, in the JAX package's units, so a
caller can feed it draws made elsewhere (JAX's, regenerated from its keys).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["mixup", "one_hot_smooth", "random_erasing"]


def one_hot_smooth(labels: torch.Tensor, num_classes: int, smoothing: float = 0.0,
                   on_value: float = 1.0) -> torch.Tensor:
    """One-hot f32 targets with ``smoothing`` spread over every class."""
    off = smoothing / num_classes
    on = on_value - smoothing + off
    onehot = torch.nn.functional.one_hot(labels.long(), num_classes).to(torch.float32)
    return onehot * (on - off) + off


def mixup(images: torch.Tensor, labels: torch.Tensor, num_classes: int,
          generator: Optional[torch.Generator] = None, *, alpha: float = 0.2,
          smoothing: float = 0.1, lam: Optional[float] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """timm mixup: the batch blended with its reverse by ``lam ~ Beta(alpha,
    alpha)`` (drawn from ``generator`` unless ``lam`` is given), and the
    smoothed one-hot targets blended alike."""
    if lam is None:
        conc = torch.tensor([alpha, alpha], dtype=torch.float64)
        lam = float(torch._sample_dirichlet(conc, generator=generator)[0])
    lam32 = np.float32(lam)  # lam and 1 - lam in f32, as JAX's f32 draw gives them
    lam, rest = float(lam32), float(np.float32(1) - lam32)
    mixed = images * lam + images.flip(0) * rest
    y1 = one_hot_smooth(labels, num_classes, smoothing)
    y2 = one_hot_smooth(labels.flip(0), num_classes, smoothing)
    return mixed, y1 * lam + y2 * rest


def _draw(generator, b: int, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    u = torch.rand(b, generator=generator, dtype=torch.float32)
    return u * (hi - lo) + lo


def random_erasing(images: torch.Tensor, generator: Optional[torch.Generator] = None, *,
                   probability: float = 0.5, min_area: float = 0.02,
                   max_area: float = 1.0 / 3.0, min_aspect: float = 0.3,
                   do: Optional[torch.Tensor] = None, area: Optional[torch.Tensor] = None,
                   log_aspect: Optional[torch.Tensor] = None,
                   top: Optional[torch.Tensor] = None, left: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-image random erase with gaussian noise ('pixel' mode).

    Draws (each (B,), made from ``generator`` where not given): ``do``
    (bool, erase this image), ``area`` (the rectangle's share of the image,
    uniform in [min_area, max_area)), ``log_aspect`` (uniform in
    [log(min_aspect), log(1/min_aspect))), ``top``/``left`` (uniform in
    [0, 1), scaled by the room left); ``noise`` has the images' shape."""
    b, c, h, w = images.shape
    if do is None:
        do = torch.rand(b, generator=generator) < probability
    if area is None:
        area = _draw(generator, b, min_area, max_area)
    if log_aspect is None:
        log_aspect = _draw(generator, b, math.log(min_aspect), math.log(1 / min_aspect))
    if top is None:
        top = _draw(generator, b)
    if left is None:
        left = _draw(generator, b)
    if noise is None:
        noise = torch.randn(images.shape, generator=generator, dtype=torch.float32)
    dev = images.device
    target = area.to(dev, torch.float32) * float(h * w)
    aspect = torch.exp(log_aspect.to(dev, torch.float32))
    eh = torch.clamp(torch.sqrt(target * aspect), 1, h).to(torch.int32)
    ew = torch.clamp(torch.sqrt(target / aspect), 1, w).to(torch.int32)
    y0 = (top.to(dev, torch.float32) * (h - eh).to(torch.float32)).to(torch.int32)
    x0 = (left.to(dev, torch.float32) * (w - ew).to(torch.float32)).to(torch.int32)
    ys = torch.arange(h, device=dev)[None, :, None]
    xs = torch.arange(w, device=dev)[None, None, :]
    in_rect = ((ys >= y0[:, None, None]) & (ys < (y0 + eh)[:, None, None])
               & (xs >= x0[:, None, None]) & (xs < (x0 + ew)[:, None, None]))
    mask = (in_rect & do.to(dev)[:, None, None])[:, None]
    return torch.where(mask, noise.to(dev, images.dtype), images)
