"""Inference and explanation rendering CLI, the reference's test.py
(counterpart of ``scouter_tpu/explain/cli.py``):

    python -m scouter_tpu_torch.explain.cli --device cuda <model flags ...> --output_dir <dir>

Restores the model from the config-derived checkpoint name
(``test.py:59-62``), takes image[vis_id] of the val set (``test.py:70-112``),
runs one forward, writes ``sloter_vis/slot_{id}.png`` per class and the jet
overlays ``slot_mask_{id}.png``, and with ``--cal_area_size`` prints the
attention-area ratio of the label's slot (``test.py:18-44``).

As in the JAX package, the attention maps come back as a forward output
and every class renders from one pass. Two differences: the rendering runs
on the model's device through ``explain/_imaging.py`` and is written
through ``core/png.py`` (no Pillow, no matplotlib; the pixels are the same), and the model is built with
``fused_slot=True``, so the slot head runs through the hand-written xSlot
kernel on the card, the deviation ``serve/export.py`` documents. The numbers
are the same: the kernel's forward equals the plain loop.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..core.config import check_serving_supported, config_from_args, get_args_parser
from ..data import preprocess_batch, select_dataset
from ..core.png import write_png
from ._imaging import resize_bilinear_u8
from .vis import (
    apply_colormap_on_image,
    attention_area_ratio,
    attention_to_maps,
    save_slot_pngs,
)

__all__ = ["main", "render_explanations"]


def render_explanations(cfg, state, model, image_u8, label, vis_dir: str):
    """One-image forward + full per-class heatmap rendering on the model's
    device. ``image_u8`` is a uint8 (H, W, C) array or tensor, on any device
    (a ``FolderDataset``'s images are on the dataset's). ``state`` is the
    ``TrainState`` that holds ``model``; the module itself carries the
    weights. Returns the attention ratio or None."""
    os.makedirs(vis_dir, exist_ok=True)
    dev = next(model.parameters()).device
    image = torch.as_tensor(image_u8).to(dev)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            x = preprocess_batch(image[None], dataset=cfg.dataset, img_size=cfg.img_size)
            out = model(x.permute(0, 3, 1, 2))
    finally:
        model.train(was_training)
    logits = out["logits"][0].to(torch.float32).cpu().numpy()
    pred = int(logits.argmax())
    shifted = logits - logits.max()
    log_probs = shifted - np.log(np.exp(shifted).sum())
    print(log_probs)  # test.py:24 prints the log_softmax output row
    print(pred)

    maps = attention_to_maps(out["attn"][0], cfg.num_classes, cfg.slots_per_class)
    save_slot_pngs(maps, vis_dir)

    raw = image.cpu().numpy()
    write_png(os.path.join(vis_dir, "image.png"), raw.squeeze() if raw.shape[-1] == 1 else raw)
    h, w = image.shape[:2]
    for idx in range(cfg.num_classes):
        # the in-memory map holds the pixels of slot_{idx}.png; [..., :3] is
        # raw.convert("RGB")
        slot_arr = resize_bilinear_u8(maps[idx], h, w)
        _, overlaid = apply_colormap_on_image(image[..., :3], slot_arr, "jet")
        write_png(os.path.join(vis_dir, f"slot_mask_{idx}.png"), overlaid)

    if cfg.cal_area_size and label is not None and isinstance(label, (int, np.integer)):
        # label's slot for positive, label+1 for negative (test.py:41)
        sel = int(label) if cfg.loss_status > 0 else int(label) + 1
        ratio = attention_area_ratio(maps[sel])
        print(f"attention_ratio: {ratio}")
        return ratio
    return None


def main(argv=None):
    """Returns the path of the restored checkpoint."""
    from ..train.state import restore_inference_state

    parser = argparse.ArgumentParser(
        "SCOUTER inference and explanation script (PyTorch/CUDA port)",
        parents=[get_args_parser()])
    ns = parser.parse_args(argv)
    cfg = config_from_args(ns).replace(use_pre=False)
    check_serving_supported(cfg)

    model, state, path = restore_inference_state(cfg, fused_slot=True, require=True,
                                                 device=cfg.device)
    ds_val = select_dataset(cfg, train=False)
    vis_id = cfg.vis_id
    image_u8 = ds_val.images[vis_id]
    label = int(ds_val.labels[vis_id]) if cfg.dataset != "MNIST" else None

    render_explanations(cfg, state, model, image_u8, label, vis_dir="sloter_vis")
    return path


if __name__ == "__main__":
    main()
