"""Explanations: per-slot heatmap rendering, jet overlays and area ratios
(counterpart of ``scouter_tpu/explain``'s rendering; the XAI baseline suite
is not ported yet), and the test.py CLI in ``explain.cli``."""

from .vis import (
    apply_colormap_on_image,
    attention_area_ratio,
    attention_to_maps,
    save_slot_pngs,
)

__all__ = [
    "apply_colormap_on_image",
    "attention_area_ratio",
    "attention_to_maps",
    "save_slot_pngs",
]
