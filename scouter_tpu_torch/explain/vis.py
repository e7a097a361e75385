"""Slot heatmap rendering and the explanation-size metric (counterpart of
``scouter_tpu/explain/vis.py``), on tensors on any device.

Reference contract:
- per-slot attention maps min-max scaled to 0..255 over the sample's whole
  map set, reshaped sqrt(N) x sqrt(N), written as grayscale ``slot_{id}.png``
  (``sloter/utils/slot_attention.py:68-83``);
- the ``jet`` overlay at alpha 0.4, composited over the RGBA original
  (``sloter/utils/vis.py:7-28``);
- attention-area ratio = sum(px) / (H*W*255) of the chosen class's map
  (``test.py:40-44``).

The JAX package renders with Pillow and matplotlib; the port computes the
same pixels with ``_imaging`` and ``core/png.py`` and needs neither.
"""

from __future__ import annotations

import os
from typing import List

import torch

from ..core.png import write_png
from ._imaging import alpha_composite, jet_lut, to_rgba

__all__ = [
    "apply_colormap_on_image",
    "attention_area_ratio",
    "attention_to_maps",
    "save_slot_pngs",
]


def attention_to_maps(attn, num_classes: int, slots_per_class: int) -> torch.Tensor:
    """(S, N) final-iteration attention of one sample -> (C, h, w) uint8
    maps on its device, min-max scaled over the whole per-sample map set
    (slot_attention.py:78-79)."""
    attn = torch.as_tensor(attn)
    if attn.dim() == 3:
        raise ValueError("pass a single sample's (S, N) attention; index the batch first")
    _, n = attn.shape
    if slots_per_class > 1:
        attn = attn.reshape(num_classes, slots_per_class, n).sum(dim=1)
    side = int(round(n ** 0.5))
    amin, amax = attn.min(), attn.max()
    scaled = (attn - amin) / (amax - amin + 1e-12) * 255.0
    return scaled.reshape(num_classes, side, side).to(torch.uint8)


def save_slot_pngs(maps, out_dir: str, prefix: str = "slot") -> List[str]:
    """Write per-class grayscale PNGs (slot_{id}.png naming, slot_attention.py:83)."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for idx, m in enumerate(maps):
        p = os.path.join(out_dir, f"{prefix}_{idx}.png")
        write_png(p, m)
        paths.append(p)
    return paths


def apply_colormap_on_image(org_im, activation, colormap_name: str = "jet"):
    """The ``jet`` overlay at alpha 0.4 (sloter/utils/vis.py:7-28 contract).

    org_im: uint8 (H, W), (H, W, 1), (H, W, 3) or (H, W, 4) image;
    activation: uint8 (H, W). Returns (heatmap, overlaid), uint8 (H, W, 4)
    tensors on the activation's device: the opaque colormap of the
    activation, and it at alpha 0.4 over the image."""
    if colormap_name != "jet":
        raise ValueError(f"only the 'jet' colormap is carried, got {colormap_name!r}")
    activation = torch.as_tensor(activation)
    image = torch.as_tensor(org_im).to(activation.device)
    heat = jet_lut(activation.device)[activation.long()]  # (H, W, 4) float64 in [0, 1]
    no_trans = (heat * 255).to(torch.uint8)
    heat[..., 3] = 0.4
    heatmap = (heat * 255).to(torch.uint8)
    rgba = to_rgba(image)
    base = alpha_composite(torch.zeros_like(rgba), rgba)
    return no_trans, alpha_composite(base, heatmap)


def attention_area_ratio(slot_map) -> float:
    """sum(px) / (H*W*255), the explanation-size metric (test.py:40-44)."""
    m = torch.as_tensor(slot_map).to(torch.float64)
    h, w = m.shape[:2]
    return float(m.sum()) / float(h * w * 255)
