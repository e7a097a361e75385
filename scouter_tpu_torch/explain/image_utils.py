"""Image utilities (counterpart of ``scouter_tpu/explain/image_utils.py``;
torchray/utils.py's imread/imsc/imsmooth/resample and the ~/.torchrayrc-style
JSON config reader, ``torchray/utils.py:42-80``).

``imread`` decodes with the port's own readers: PNG with ``core/png.py``
and JPEG with nvJPEG on the card (``data/_decode.py``); on the CPU a JPEG
goes through Pillow, as the port's CPU image path does.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import torch

from ..core.device import resolve_device
from ._imaging import resize_bilinear_u8
from ._resize import resize_bilinear
from .extremal import imsmooth  # noqa: F401  (re-export; torchray/utils.py:344-409)

__all__ = ["imread", "imsc", "resample", "imsmooth", "read_rc_config"]

_RC_DEFAULTS = {
    "benchmark": {
        "store": "data/benchmark.db",  # sqlite ExperimentStore (MongoDB replacement)
        "imagenet_folder": "data/imagenet",
        "voc_dir": "data/voc",
        "coco_dir": "data/coco",
    },
}


def imread(path: str, resize: Optional[Tuple[int, int]] = None, to_rgb: bool = True,
           device="cuda") -> torch.Tensor:
    """An image as float32 (H, W, C) in [0, 1] on ``device``, as Pillow's
    ``open`` [+ ``convert("RGB")``] [+ ``resize(resize, BILINEAR)``] /
    255 gives it. ``resize`` is (width, height), Pillow's order. Without
    ``to_rgb`` a PNG keeps its stored channels (a palette as RGB)."""
    from ..core.png import decode_png
    from ..data._decode import PNG_MAGIC, decode_image

    dev = resolve_device(device)
    with open(path, "rb") as f:
        data = f.read()
    if not to_rgb and data.startswith(PNG_MAGIC):
        pixels = torch.from_numpy(decode_png(data, None, name=str(path))).to(dev)
    else:
        pixels = decode_image(data, dev, "RGB")
    if resize is not None:
        w, h = resize
        planes = pixels if pixels.dim() == 2 else pixels.permute(2, 0, 1)
        planes = resize_bilinear_u8(planes, h, w)
        pixels = planes if pixels.dim() == 2 else planes.permute(1, 2, 0)
    return pixels.to(torch.float32) / 255.0


def imsc(img, lim: Optional[Tuple[float, float]] = None) -> torch.Tensor:
    """Rescale an image to [0, 1] for display (torchray imsc semantics)."""
    img = torch.as_tensor(img).to(torch.float32)
    lo, hi = (img.min(), img.max()) if lim is None else lim
    lo, hi = float(lo), float(hi)
    denom = (hi - lo) if hi > lo else 1.0
    return ((img - lo) / denom).clamp(0.0, 1.0)


def resample(img, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resample of an (H, W) or (H, W, C) image to ``size`` (h, w),
    as ``jax.image.resize`` (antialiased when it shrinks)."""
    arr = torch.as_tensor(img).to(torch.float32)
    if arr.dim() == 2:
        return resize_bilinear(arr, size)
    return resize_bilinear(arr.permute(2, 0, 1), size).permute(1, 2, 0)


def read_rc_config(path: str = "~/.scouter_tpu_rc") -> dict:
    """JSON config with defaults (torchrayrc capability; a missing file gives
    the defaults)."""
    cfg = json.loads(json.dumps(_RC_DEFAULTS))  # deep copy
    full = os.path.expanduser(path)
    if os.path.exists(full):
        with open(full) as f:
            user = json.load(f)
        for k, v in user.items():
            if isinstance(v, dict) and isinstance(cfg.get(k), dict):
                cfg[k].update(v)
            else:
                cfg[k] = v
    return cfg
