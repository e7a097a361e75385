"""``jax.image.resize(..., "bilinear")`` on the last two axes of a tensor.

JAX's bilinear resize is a separable product with a triangle kernel that
widens by the shrink factor when it shrinks (antialiasing), the weights of
each output sample normalised over the input samples in range
(``jax/_src/image/scale.py::compute_weight_mat``). ``F.interpolate`` does not
antialias by default and treats the edges otherwise with
``antialias=True``, so the explain suite resizes through this one helper:
the weight matrices are made in float32 with numpy, as JAX makes them, and
applied as two matrix products (rows, then columns) on the tensor's device.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

__all__ = ["resize_bilinear"]


@functools.lru_cache(maxsize=None)
def _weight_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) float32 weights of ``compute_weight_mat`` with the
    triangle kernel, antialiased, no translation."""
    f32 = np.float32
    scale = f32(out_size) / f32(in_size)
    inv_scale = f32(1.0) / scale
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - x)
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    eps = np.finfo(f32).eps
    weights = np.where(np.abs(total) > 1000.0 * eps,
                       weights / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], weights, f32(0.0)).T.astype(f32))


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(..., H, W) -> (..., h, w), as ``jax.image.resize(x, (..., h, w),
    "bilinear")``. Computes in float32 (float64 for a float64 ``x``) and
    returns ``x``'s dtype; an axis whose size matches is left as it is, as
    JAX leaves it."""
    out_h, out_w = size
    in_h, in_w = x.shape[-2:]
    y = x.to(torch.promote_types(x.dtype, torch.float32))
    if out_h != in_h:
        wh = torch.from_numpy(_weight_matrix(in_h, out_h)).to(x.device, y.dtype)
        y = torch.matmul(wh, y)
    if out_w != in_w:
        ww = torch.from_numpy(_weight_matrix(in_w, out_w)).to(x.device, y.dtype)
        y = torch.matmul(y, ww.t())
    return y.to(x.dtype)
