"""Batched preprocessing on the images' device (counterpart of
``scouter_tpu/data/transforms.py``):

- train: Resize(img_size, bilinear) -> [Aug] -> /255 -> Normalize(mean, std)
- val:   Resize(img_size, bilinear) -> /255 -> Normalize(mean, std)

with the reference's per-dataset constants. Images stay uint8 (B, H, W, C)
until they are on the device.

Augmentation follows ``tools/image_aug.py:44-69``: independent coin flips
for {fliplr, flipud, affine (scale 0.8-1, translate x 0-10% / y +-10%, rotate
by an integer in [-10, 9] degrees), gaussian blur sigma in [0, 3]}, applied
in a per-image random order (``iaa.Sequential(random_order=True)``). The
random parameters are drawn on the host from an explicit
``torch.Generator``; they cannot equal ``jax.random``'s draws, but the ops
applied to given parameters (:func:`_apply_augs`) equal the JAX package's.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["NORMALIZE_VALUES", "augment_batch", "preprocess_batch", "resize_bilinear"]

# dataset -> (mean, std), transform_func.py:102-105
NORMALIZE_VALUES: Dict[str, Tuple[Tuple[float, ...], Tuple[float, ...]]] = {
    "MNIST": ((0.1307,), (0.3081,)),
    "CUB200": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
    "ConText": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
    "ImageNet": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
}


def resize_bilinear(images: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W, C) -> float32 (B, size, size, C), bilinear with antialiasing
    on downscale; the identity (as float32) when the size already matches."""
    b, h, w, c = images.shape
    x = images.to(torch.float32)
    if (h, w) == (size, size):
        return x
    x = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                      align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1)


def _bilinear_zero_pad(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """``map_coordinates(order=1, mode='constant', cval=0)`` per channel:
    img (n, H, W, C), sample coordinates ys, xs (n, H, W). A corner outside
    the image contributes zero; the four corners add up in JAX's order."""
    n, h, w, c = img.shape
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy1, wx1 = ys - y0, xs - x0
    wy0, wx0 = 1 - wy1, 1 - wx1
    y0, x0 = y0.long(), x0.long()
    flat = img.reshape(n, h * w, c)
    out = None
    for yi, wy in ((y0, wy0), (y0 + 1, wy1)):
        for xi, wx in ((x0, wx0), (x0 + 1, wx1)):
            valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(n, h * w, 1)
            val = torch.gather(flat, 1, idx.expand(-1, -1, c)).reshape(n, h, w, c)
            term = (wy * wx)[..., None] * torch.where(valid[..., None], val, 0.0)
            out = term if out is None else out + term
    return out


def _affine_sample(img: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """imgaug-style affine: scale about the centre, translate by a fraction,
    rotate; bilinear sampling with zero padding (imgaug's default cval=0).
    img (n, H, W, C); params (n, 6) rows (sx, sy, tx, ty, rot, sigma)."""
    n, h, w, c = img.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    sx, sy, tx, ty, rot = (params[:, i, None, None] for i in range(5))
    theta = rot * math.pi / 180.0
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    tx, ty = tx * w, ty * h
    # output (y, x) -> input coordinates: inverse of scale -> rotate -> translate
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=img.device),
                            torch.arange(w, dtype=torch.float32, device=img.device),
                            indexing="ij")
    x0 = xx - cx - tx
    y0 = yy - cy - ty
    xr = cos_t * x0 + sin_t * y0
    yr = -sin_t * x0 + cos_t * y0
    return _bilinear_zero_pad(img, yr / sy + cy, xr / sx + cx)


def _gaussian_blur(img: torch.Tensor, sigma: torch.Tensor, max_radius: int = 9) -> torch.Tensor:
    """Separable gaussian blur, one sigma per image (radius fixed at 9, about
    3 sigma_max); borders reflect (cv2 BORDER_REFLECT_101, imgaug's default).
    img (n, H, W, C); sigma (n,)."""
    n, h, w, c = img.shape
    r = max_radius
    x = torch.arange(-r, r + 1, dtype=torch.float32, device=img.device)
    k = torch.exp(-0.5 * (x / sigma.clamp_min(1e-3)[:, None]) ** 2)
    k = (k / k.sum(dim=1, keepdim=True)).repeat_interleave(c, dim=0)  # (n*C, 2r+1)
    planes = F.pad(img.permute(0, 3, 1, 2), (r, r, r, r), mode="reflect")
    planes = planes.reshape(1, n * c, h + 2 * r, w + 2 * r)
    out = F.conv2d(planes, k[:, None, :, None], groups=n * c)
    out = F.conv2d(out, k[:, None, None, :], groups=n * c)
    return out.reshape(n, c, h, w).permute(0, 2, 3, 1)


_AUGS = (
    lambda im, p: im.flip(2),           # fliplr
    lambda im, p: im.flip(1),           # flipud
    _affine_sample,                     # affine
    lambda im, p: _gaussian_blur(im, p[:, 5]),  # blur
)


def _apply_augs(images: torch.Tensor, gates: torch.Tensor, params: torch.Tensor,
                order: torch.Tensor) -> torch.Tensor:
    """Apply the four gated augmenters, image i in the order ``order[i]`` (a
    permutation of 0..3: fliplr, flipud, affine, blur).

    images (B, H, W, C) float on any device; gates (B, 4) bool, params (B, 6)
    float rows (sx, sy, tx, ty, rot, sigma) and order (B, 4) int on the host.
    Each op runs once per slot on the images that take it there."""
    images = images.clone()
    params = params.to(images.device, torch.float32)
    for slot in range(4):
        for op, fn in enumerate(_AUGS):
            idx = ((order[:, slot] == op) & gates[:, op]).nonzero()[:, 0]
            if len(idx):
                dev_idx = idx.to(images.device)
                images[dev_idx] = fn(images[dev_idx], params[dev_idx])
    return images


def draw_aug_params(batch: int, generator: torch.Generator):
    """Per-image gates (B, 4), params (B, 6) and order (B, 4) with imgaug's
    ranges (image_aug.py:14-24), drawn on the host from ``generator``."""
    g = generator
    gates = torch.rand(batch, 4, generator=g) < 0.5
    u = torch.rand(batch, 5, generator=g)
    sx = 0.8 + 0.2 * u[:, 0]
    sy = 0.8 + 0.2 * u[:, 1]
    # x-translation one-sided, y symmetric (image_aug.py:17-18)
    tx = 0.1 * u[:, 2]
    ty = -0.1 + 0.2 * u[:, 3]
    rot = torch.randint(-10, 10, (batch,), generator=g).to(torch.float32)
    sigma = 3.0 * u[:, 4]
    order = torch.rand(batch, 4, generator=g).argsort(dim=1)
    return gates, torch.stack([sx, sy, tx, ty, rot, sigma], dim=1), order


def augment_batch(images: torch.Tensor, generator: torch.Generator,
                  rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Per-image augmentation of (B, H, W, C) float [0, 255] images.
    ``rows=(start, total)``: the images are rows start..start+B of a batch
    of ``total``, and take those rows' draws."""
    start, total = rows if rows is not None else (0, images.shape[0])
    drawn = draw_aug_params(total, generator)
    return _apply_augs(images, *(t[start:start + images.shape[0]] for t in drawn))


def preprocess_batch(images_u8: torch.Tensor, *, dataset: str, img_size: int,
                     train: bool = False, aug: bool = False,
                     generator: Optional[torch.Generator] = None,
                     rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """uint8 (B, H, W, C) -> normalised float32 (B, img_size, img_size, C);
    augmented when ``train and aug`` and a ``generator`` is given (``rows``:
    see :func:`augment_batch`)."""
    x = resize_bilinear(images_u8, img_size)
    if train and aug and generator is not None:
        x = augment_batch(x, generator, rows)
    mean, std = NORMALIZE_VALUES[dataset]
    mean = torch.tensor(mean, dtype=torch.float32, device=x.device) * 255.0
    std = torch.tensor(std, dtype=torch.float32, device=x.device) * 255.0
    return (x - mean) / std
