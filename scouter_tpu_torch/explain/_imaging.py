"""Exact tensor counterparts of what Pillow and matplotlib do on the explain
path, so that the path runs where neither is installed:

- :func:`jet_lut`: matplotlib's 256-entry ``jet`` table
  (``LinearSegmentedColormap`` with N=256), built in float64 from the same
  segment data;
- :func:`resize_bilinear_u8`: Pillow's ``Image.resize(size, BILINEAR)`` of an
  8-bit image: separable passes, horizontal then vertical, fixed-point taps
  with 22 fraction bits and a uint8 image between the passes;
- :func:`alpha_composite`: Pillow's ``Image.alpha_composite``, integer
  arithmetic with 7 fraction bits;
- :func:`to_rgba`: Pillow's ``convert("RGBA")`` of an L, RGB or RGBA image.

The PNG files are written with ``core/png.py``.

The image functions take and return uint8 tensors on any device and compute
in integers, so the card and the CPU give the same bits.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

__all__ = ["alpha_composite", "jet_lut", "resize_bilinear_u8", "to_rgba"]

# matplotlib's _cm._jet_data: per channel, rows (x, y0, y1)
_JET_SEGMENTS = (
    ((0.0, 0.0, 0.0), (0.35, 0.0, 0.0), (0.66, 1.0, 1.0), (0.89, 1.0, 1.0), (1.0, 0.5, 0.5)),
    ((0.0, 0.0, 0.0), (0.125, 0.0, 0.0), (0.375, 1.0, 1.0), (0.64, 1.0, 1.0), (0.91, 0.0, 0.0),
     (1.0, 0.0, 0.0)),
    ((0.0, 0.5, 0.5), (0.11, 1.0, 1.0), (0.34, 1.0, 1.0), (0.65, 0.0, 0.0), (1.0, 0.0, 0.0)),
)


def _segment_table(segments, n: int):
    """``matplotlib.colors._create_lookup_table(n, segments)`` with gamma 1,
    in float64 operation for operation."""
    x = [s[0] * (n - 1) for s in segments]
    y0 = [s[1] for s in segments]
    y1 = [s[2] for s in segments]
    step = 1.0 / (n - 1)
    # np.linspace(0, 1, n): i * step, the last sample exactly 1
    xind = [(n - 1) * (i * step) for i in range(n - 1)] + [(n - 1) * 1.0]
    table = [y1[0]]
    for xi in xind[1:-1]:
        j = next(k for k, xk in enumerate(x) if xk >= xi)  # searchsorted, side='left'
        distance = (xi - x[j - 1]) / (x[j] - x[j - 1])
        table.append(distance * (y0[j] - y1[j - 1]) + y1[j - 1])
    table.append(y0[-1])
    return [min(max(v, 0.0), 1.0) for v in table]


@functools.lru_cache(maxsize=None)
def _jet_lut_cpu() -> torch.Tensor:
    rgb = [_segment_table(seg, 256) for seg in _JET_SEGMENTS]
    return torch.tensor([[r, g, b, 1.0] for r, g, b in zip(*rgb)], dtype=torch.float64)


def jet_lut(device="cpu") -> torch.Tensor:
    """matplotlib's ``colormaps['jet'](np.arange(256))``: float64 (256, 4)."""
    return _jet_lut_cpu().to(device, copy=True)  # the cached table stays unaliased


@functools.lru_cache(maxsize=None)
def _bilinear_taps(in_size: int, out_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pillow's ``precompute_coeffs`` with the bilinear filter and
    ``normalize_coeffs_8bpc`` (Resample.c): for each output index the input
    indices (out, k) and their fixed-point weights (out, k), int64; unused
    taps have weight 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale  # the bilinear filter's support is 1
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    index = np.zeros((out_size, ksize), np.int64)
    weight = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) * ss)) for x in range(xmax)]
        total = sum(w)
        if total != 0.0:
            w = [v / total for v in w]
        index[xx, :xmax] = np.arange(xmin, xmin + xmax)
        weight[xx, :xmax] = [int(0.5 + v * (1 << 22)) for v in w]
    return torch.from_numpy(index), torch.from_numpy(weight)


def _clip8(acc: torch.Tensor) -> torch.Tensor:
    """Pillow's rounding and clip8 of a 22-bit fixed-point sum."""
    return ((acc + (1 << 21)) >> 22).clamp(0, 255).to(torch.uint8)


def resize_bilinear_u8(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Pillow's ``Image.resize((width, height), Image.BILINEAR)`` of uint8
    (..., H, W) planes, bit for bit. A pass whose size already matches is
    skipped, as Pillow skips it."""
    if img.dtype != torch.uint8:
        raise TypeError(f"resize_bilinear_u8 takes uint8 planes, got {img.dtype}")
    in_h, in_w = img.shape[-2:]
    out = img
    if width != in_w:
        index, weight = (t.to(img.device) for t in _bilinear_taps(in_w, width))
        out = _clip8((out.long()[..., index] * weight).sum(-1))
    if height != in_h:
        index, weight = (t.to(img.device) for t in _bilinear_taps(in_h, height))
        out = _clip8((out.long()[..., index, :] * weight[:, :, None]).sum(-2))
    return out.clone() if out is img else out


def _shift_div255(a: torch.Tensor) -> torch.Tensor:
    return ((a >> 8) + a) >> 8


def alpha_composite(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Pillow's ``Image.alpha_composite(dst, src)`` of uint8 (..., 4) RGBA
    images, bit for bit (AlphaComposite.c): where src is fully transparent
    the result is dst."""
    d, s = dst.long(), src.long()
    sa, da = s[..., 3:], d[..., 3:]
    outa = sa * 255 + da * (255 - sa)
    c1 = ((sa * 255 * 255) << 7) // outa.clamp_min(1)
    c2 = (255 << 7) - c1
    rgb = _shift_div255(s[..., :3] * c1 + d[..., :3] * c2 + (0x80 << 7)) >> 7
    out = torch.cat([rgb, _shift_div255(outa + 0x80)], dim=-1)
    return torch.where(sa == 0, d, out).to(torch.uint8)


def to_rgba(img: torch.Tensor) -> torch.Tensor:
    """Pillow's ``convert("RGBA")`` of a uint8 L (H, W) or (H, W, 1), RGB
    (H, W, 3) or RGBA (H, W, 4) image: gray replicated, alpha 255."""
    if img.dim() == 2:
        img = img[..., None]
    channels = img.shape[-1]
    if channels == 4:
        return img
    if channels == 1:
        img = img.expand(*img.shape[:-1], 3)
    elif channels != 3:
        raise ValueError(f"expected 1, 3 or 4 channels, got {channels}")
    return torch.cat([img, torch.full_like(img[..., :1], 255)], dim=-1)

