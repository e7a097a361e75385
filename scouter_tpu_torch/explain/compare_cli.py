"""XAI-baseline comparison driver, the reference's torchcam_vis.py and
captum_vis.py (counterpart of ``scouter_tpu/explain/compare_cli.py``):

    python -m scouter_tpu_torch.explain.compare_cli --dataset ImageNet \\
        --model resnest26d --num_classes 10 [--methods deeplift] [--fast]

The reference (``torchcam_vis.py:56-267``) loads the BACKBONE only
(``load_backbone``, never the slot module), takes one validation image and
renders the saliency maps of every attribution family side by side, one map
per class; ``captum_vis.py`` does so for DeepLift. This driver does the same
with the port's backbone on ``--device`` (the card by default), writing
``vis_compare/<method>_<class>.png`` overlays through ``explain/_imaging.py``
and ``core/png.py``: no Pillow, no matplotlib. JAX compiles each per-class
method once; here every call is eager.

Default method set: cam, gradcam, gradcampp, smooth_gradcampp, scorecam,
gradient, guided_backprop, rise, extremal, igos. Also: sscam, isscam,
deconvnet, linear_approx, iba, deeplift, excitation.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["compare_methods", "main", "render_maps"]

DEFAULT_METHODS = ("cam", "gradcam", "gradcampp", "smooth_gradcampp", "scorecam",
                   "gradient", "guided_backprop", "rise", "extremal", "igos")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def compare_methods(
    model,
    image_u8,
    class_indices: List[int],
    out_dir: str,
    *,
    dataset: str = "ImageNet",
    img_size: int = 260,
    methods: Optional[List[str]] = None,
    seed: int = 0,
    fast: bool = False,
    grad_min_level: float = 0.0,
    iba_estimate_batches=None,
    num_samples: Optional[Dict[str, int]] = None,
    timings: Optional[Dict[str, float]] = None,
) -> Dict[str, Dict[int, np.ndarray]]:
    """Run the attribution suite for the given classes on the model's device;
    returns method -> class -> (h, w) float32 map and writes the jet
    overlays (:func:`render_maps`).

    ``model``: a zoo backbone with its classifier, in eval mode.
    ``grad_min_level``: the reference's mask floor (``torchcam_vis.py:44-51``).
    ``num_samples``: per-method sample counts in place of the defaults
    (``sscam``, ``isscam``). ``timings``: filled with each method's
    seconds over all classes, the device synchronised."""
    from ..data import preprocess_batch
    from . import cam as cam_mod
    from .backprop import deconvnet, gradient_saliency, guided_backprop, linear_approx
    from .extremal import extremal_perturbation
    from .igos import gaussian_blur_baseline, integrated_mask
    from .rise import rise

    dev = next(model.parameters()).device
    image = torch.as_tensor(image_u8).to(dev)
    x = preprocess_batch(image[None], dataset=dataset, img_size=img_size).permute(0, 3, 1, 2)
    x = x.contiguous()
    forward = model
    n_masks = 400 if fast else 8000
    ep_iters = 50 if fast else 800
    igos_iters = 5 if fast else 15
    counts = num_samples or {}

    methods = list(methods or DEFAULT_METHODS)
    results: Dict[str, Dict[int, np.ndarray]] = {m: {} for m in methods}
    seconds = {m: 0.0 for m in methods}

    def timed(m, fn):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        seconds[m] += time.perf_counter() - t0
        return out

    rise_maps = None
    if "rise" in methods:
        rise_maps = timed("rise", lambda: rise(forward, x, seed, num_masks=n_masks))
    blurred = gaussian_blur_baseline(x) if "igos" in methods else None

    iba_stats = iba_head = iba_features = None
    if "iba" in methods:
        # the reference's flow: feature statistics over val images
        # (torchcam_vis.py:201-206), then a per-class analysis (:212-215);
        # with no estimation stream, noise-jittered copies of the input
        from .iba import estimate_stats

        iba_features, iba_head, _ = cam_mod.backbone_split(model)
        if iba_estimate_batches is None:
            n_est = 4 if fast else 32
            gen = torch.Generator().manual_seed(seed + 99)
            iba_estimate_batches = (
                x + 0.1 * torch.randn(x.shape, generator=gen).to(dev) for _ in range(n_est))
        iba_stats = timed("iba", lambda: estimate_stats(iba_features, iba_estimate_batches))

    per_class = {
        "cam": lambda c: cam_mod.cam(model, x, c),
        "gradcam": lambda c: cam_mod.gradcam(model, x, c),
        "gradcampp": lambda c: cam_mod.gradcampp(model, x, c),
        "smooth_gradcampp": lambda c: cam_mod.smooth_gradcampp(model, x, c, seed),
        "scorecam": lambda c: cam_mod.scorecam(model, x, c),
        "sscam": lambda c: cam_mod.sscam(model, x, c, seed,
                                         num_samples=counts.get("sscam", 35)),
        "isscam": lambda c: cam_mod.isscam(model, x, c, num_samples=counts.get("isscam", 10)),
        "gradient": lambda c: gradient_saliency(model, x, c),
        "deconvnet": lambda c: deconvnet(model, x, c),
        "guided_backprop": lambda c: guided_backprop(model, x, c),
        "linear_approx": lambda c: linear_approx(model, x, c),
        "rise": lambda c: rise_maps[c],
        "extremal": lambda c: extremal_perturbation(forward, x, c, max_iter=ep_iters)[0][0, 0],
        # 0 = important in IGOS
        "igos": lambda c: 1.0 - integrated_mask(forward, x, blurred, c, seed,
                                                max_iterations=igos_iters).upsampled,
    }

    def iba_map(c):
        from .iba import iba_analyze

        def readout_loss(z):
            return -torch.log_softmax(iba_head(z), dim=1)[:, c].mean()

        return iba_analyze(iba_features, readout_loss, x, iba_stats, seed,
                           out_shape=tuple(x.shape[2:]))

    def deeplift_map(c):
        from .deeplift import layer_deeplift

        return layer_deeplift(model, x, c).sum(dim=0)

    def excitation_map(c):
        from .excitation import excitation_backprop

        return excitation_backprop(model, x, c)

    per_class.update(iba=iba_map, deeplift=deeplift_map, excitation=excitation_map)

    for c in class_indices:
        for m in methods:
            if m not in per_class:
                raise ValueError(f"unknown method {m!r}")
            sal = timed(m, lambda: per_class[m](c).detach().float().cpu().numpy())
            # degenerate maps (all zero after the ReLU) min-max normalise to
            # nan in the reference as well; sanitised for rendering
            results[m][c] = np.nan_to_num(sal)
    if timings is not None:
        timings.update(seconds)
    render_maps(results, image, out_dir, grad_min_level)
    return results


def render_maps(results: Dict[str, Dict[int, np.ndarray]], image_u8, out_dir: str,
                grad_min_level: float = 0.0) -> List[str]:
    """Write ``<out_dir>/<method>_<class>.png``: each map through the
    reference's make_grad chain (``torchcam_vis.py:44-51``: relu, min-max,
    floor at ``grad_min_level``, min-max again) in float32 on the host, to
    uint8, Pillow's bilinear resize to the image, the jet overlay at alpha
    0.4 over the image as RGB, all on the image's device, the pixels JAX's
    Pillow and matplotlib rendering gives."""
    from ..core.png import write_png
    from ._imaging import resize_bilinear_u8
    from .vis import apply_colormap_on_image

    os.makedirs(out_dir, exist_ok=True)
    image = torch.as_tensor(image_u8)
    raw = image.expand(*image.shape[:2], 3) if image.shape[-1] == 1 else image[..., :3]
    h, w = raw.shape[:2]
    paths = []
    level = np.float32(grad_min_level)
    for m, per_class in results.items():
        for c, sal in per_class.items():
            s = np.maximum(np.asarray(sal, np.float32), np.float32(0))
            s = s - s.min()
            s = s / (s.max() if s.max() > 0 else np.float32(1.0))
            s = np.maximum(s, level)
            s = s - s.min()
            denom = s.max() if s.max() > 0 else np.float32(1.0)
            s8 = torch.from_numpy((s / denom * 255).astype(np.uint8)).to(image.device)
            _, overlaid = apply_colormap_on_image(raw, resize_bilinear_u8(s8, h, w), "jet")
            path = os.path.join(out_dir, f"{m}_{c}.png")
            write_png(path, overlaid)
            paths.append(path)
    return paths


def build_backbone(cfg):
    """The backbone alone with its classifier, like ``load_backbone`` in
    torchcam_vis (:109), on ``cfg.device`` in eval mode: a fresh init from
    seed 0, then the no-slot checkpoint of ``cfg`` where one exists (the
    slot model's ``backbone.`` nesting dropped). Returns (model, path or
    None)."""
    from ..core.checkpoint import checkpoint_path
    from ..core.device import resolve_device
    from ..models import create_model, init_weights, strip_prefix

    dev = resolve_device(cfg.device)
    mnist = cfg.dataset == "MNIST"
    model = create_model(cfg.model, num_classes=cfg.num_classes, in_chans=1 if mnist else 3,
                         mnist_stem=mnist)
    init_weights(model, torch.Generator().manual_seed(0))
    path = checkpoint_path(cfg.output_dir, cfg.replace(use_slot=False))
    if not os.path.exists(path):
        return model.eval().to(dev), None
    with torch.serialization.safe_globals([argparse.Namespace]):
        payload = torch.load(path, map_location="cpu", weights_only=True)
    sd = payload["model"]
    if any(k.startswith("backbone.") for k in sd):
        sd = strip_prefix(sd, "backbone.")
    model.load_state_dict(sd)
    return model.eval().to(dev), path


def main(argv=None, out_dir: str = "vis_compare", timings: Optional[Dict[str, float]] = None):
    """Returns the maps, method -> class -> (h, w)."""
    from ..core.config import config_from_args, get_args_parser
    from ..data import select_dataset

    parser = argparse.ArgumentParser(
        "SCOUTER attribution comparison (torchcam_vis / captum_vis, PyTorch/CUDA port)",
        parents=[get_args_parser()])
    parser.add_argument("--methods", default="", help="comma list; empty = default set")
    parser.add_argument("--fast", default=False, action="store_true")
    ns = parser.parse_args(argv)
    cfg = config_from_args(ns)

    model, _ = build_backbone(cfg)
    ds_val = select_dataset(cfg, train=False)
    image_u8 = ds_val.images[cfg.vis_id]
    methods = [m for m in ns.methods.split(",") if m] or None
    return compare_methods(model, image_u8, list(range(cfg.num_classes)), out_dir=out_dir,
                           dataset=cfg.dataset, img_size=cfg.img_size, methods=methods,
                           fast=ns.fast, grad_min_level=cfg.grad_min_level, timings=timings)


if __name__ == "__main__":
    main()
