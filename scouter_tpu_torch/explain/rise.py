"""RISE attribution (counterpart of ``scouter_tpu/explain/rise.py``; the
capability of ``torchray/attribution/rise.py:110-240``).

``num_masks`` random low-resolution binary grids (a cell is 1 with
probability ``p``), reflect-padded by one cell and bilinearly upsampled
(``_upsample_reflect``, rise.py:38-80), shifted at random, multiply the
input; the class scores pass through a sigmoid, and each class's saliency
is the score-weighted average of the masks.

The draw and the body are apart: :func:`draw_rise` draws the grids and the
shifts on the CPU from a ``torch.Generator`` (small: (num_masks, 7, 7) and
two index vectors), and :func:`rise_from_draws` makes the masks chunk by
chunk on the device from them, so the card and the CPU use the same masks.
JAX draws them per chunk from split keys; feeding its draws to the body
reproduces its maps. ``filter_masks`` (precomputed masks, rise.py:132-134)
is supported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ._resize import resize_bilinear

__all__ = ["draw_rise", "rise", "rise_from_draws"]


def _upsample_reflect(grid: torch.Tensor, up_h: int, up_w: int) -> torch.Tensor:
    """(num, gh, gw) low-res grid -> (num, up_h, up_w): reflect-pad one grid
    cell, bilinear-interpolate, slice one interpolation cell in
    (rise.py:30-80). The interpolation cell follows the TARGET size
    (ceil(up/g)), not the outer shift cell."""
    num, gh, gw = grid.shape
    padded = F.pad(grid[:, None], (1, 1, 1, 1), mode="reflect")[:, 0]
    in_h = -(-up_h // gh)
    in_w = -(-up_w // gw)
    up_full = resize_bilinear(padded, (in_h * (gh + 2), in_w * (gw + 2)))
    return up_full[:, in_h:in_h + up_h, in_w:in_w + up_w]


def _make_masks(grid: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
                height: int, width: int) -> torch.Tensor:
    """(num, H, W) masks from binary grids (num, g, g) and shifts (num,):
    upsample with a one-cell buffer, then crop at the shift (rise.py:38-80,
    190-212)."""
    num, cells, _ = grid.shape
    cell_h = -(-height // cells)
    cell_w = -(-width // cells)
    up = _upsample_reflect(grid, height + cell_h, width + cell_w)
    rows = sx[:, None] + torch.arange(height, device=grid.device)
    cols = sy[:, None] + torch.arange(width, device=grid.device)
    b = torch.arange(num, device=grid.device)[:, None, None]
    return up[b, rows[:, :, None], cols[:, None, :]]


def draw_rise(generator: torch.Generator, num_masks: int, height: int, width: int, *,
              num_cells: int = 7, batch_size: int = 32, p: float = 0.5
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(grid (M, g, g) float32 {0, 1}, sx (M,), sy (M,)) for M = the masks
    rounded up to whole chunks, drawn on the CPU from ``generator``."""
    total = -(-num_masks // batch_size) * batch_size
    grid = (torch.rand(total, num_cells, num_cells, generator=generator) < p).float()
    sx = torch.randint(0, -(-height // num_cells), (total,), generator=generator)
    sy = torch.randint(0, -(-width // num_cells), (total,), generator=generator)
    return grid, sx, sy


def _chunk_saliency(forward, x, masks):
    masked = x * masks[:, None]  # (bs, C, H, W)
    logits = forward(masked)
    scores = torch.sigmoid(logits.to(torch.promote_types(logits.dtype, torch.float32)))
    flat = masks.reshape(masks.shape[0], -1).to(scores.dtype)
    return (scores.t() @ flat).reshape(-1, *masks.shape[1:])  # (classes, H, W)


def rise_from_draws(forward, x: torch.Tensor, grid: torch.Tensor, sx: torch.Tensor,
                    sy: torch.Tensor, num_masks: int, batch_size: int = 32) -> torch.Tensor:
    """RISE on given draws: the masks of each chunk made on ``x``'s device,
    those past ``num_masks`` zeroed (the reference's smaller last chunk,
    rise.py:187-188). Returns (classes, H, W)."""
    h, w = x.shape[2:]
    dev = x.device
    sal = None
    with torch.no_grad():
        for start in range(0, grid.shape[0], batch_size):
            stop = start + batch_size
            masks = _make_masks(grid[start:stop].to(dev), sx[start:stop].to(dev),
                                sy[start:stop].to(dev), h, w)
            valid = (start + torch.arange(batch_size, device=dev)) < num_masks
            masks = masks * valid[:, None, None]
            part = _chunk_saliency(forward, x, masks)
            sal = part if sal is None else sal + part
    return sal / num_masks


def _filter_saliency(forward, x, filter_masks, batch_size):
    h, w = x.shape[2:]
    sal = None
    with torch.no_grad():
        for start in range(0, filter_masks.shape[0], batch_size):
            masks = filter_masks[start:start + batch_size].to(x.device, torch.float32)
            part = _chunk_saliency(forward, x, masks.reshape(-1, h, w))
            sal = part if sal is None else sal + part
    return sal / filter_masks.shape[0]


def rise(forward, x: torch.Tensor, seed: int = 0, *, num_masks: int = 8000,
         num_cells: int = 7, batch_size: int = 32, p: float = 0.5,
         filter_masks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RISE saliency for all classes.

    forward: images (B, C, H, W) -> logits (B, classes); x: (1, C, H, W).
    The masks are drawn from ``seed`` (unused with ``filter_masks``, a
    precomputed (num_masks, H, W) stack). Returns (classes, H, W)."""
    if filter_masks is not None:
        assert filter_masks.shape[0] == num_masks
        return _filter_saliency(forward, x, filter_masks, batch_size)
    h, w = x.shape[2:]
    grid, sx, sy = draw_rise(torch.Generator().manual_seed(seed), num_masks, h, w,
                             num_cells=num_cells, batch_size=batch_size, p=p)
    return rise_from_draws(forward, x, grid, sx, sy, num_masks, batch_size)
