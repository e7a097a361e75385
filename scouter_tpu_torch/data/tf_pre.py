"""TF/MnasNet-style preprocessing (counterpart of ``scouter_tpu/data/tf_pre.py``,
timm's ``timm/data/tf_preprocessing.py``), on the device.

- train (``preprocess_for_train`` :135-152): an Inception-style random crop
  (``random_crop_box``: aspect uniform in [3/4, 4/3], crop height uniform
  between the bounds the area range [0.08, 1] implies, at least 10% of the
  image, 10 attempts), falling back to the padded centre crop; then a
  bicubic resize to (size, size) and a random horizontal flip;
- eval (``preprocess_for_eval`` :156-173): the centre crop of
  ``size/(size+CROP_PADDING) * min(h, w)`` pixels, resized to (size, size).

The crop arithmetic and the ``np.random.RandomState(seed)`` stream are the
JAX package's, in the same order of draws: aspect, height, top, left, then
the flip draw after the resize. Bytes decode through ``_decode.decode_image``
(nvJPEG on the card, Pillow for JPEG on the CPU, ``core/png.py`` for PNG);
the resize is Pillow's BICUBIC (``explain/_imaging.py::resize_bicubic_u8``,
integer taps), so from PNG bytes the card and the CPU give the JAX
package's pixels bit for bit. The output is uint8 (size, size, 3) on the
device, or (3, size, size) with ``chw=True``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device

__all__ = ["CROP_PADDING", "TfPreprocessTransform", "center_crop_box", "random_crop_box"]

CROP_PADDING = 32  # tf_preprocessing.py:24


def center_crop_box(height: int, width: int, image_size: int) -> Tuple[int, int, int, int]:
    """(top, left, crop_h, crop_w) of the padded center crop (:108-126)."""
    crop = int((image_size / (image_size + CROP_PADDING)) * min(height, width))
    top = ((height - crop) + 1) // 2
    left = ((width - crop) + 1) // 2
    return top, left, crop, crop


def random_crop_box(
    height: int,
    width: int,
    rng: np.random.RandomState,
    *,
    min_object_covered: float = 0.1,
    area_range: Tuple[float, float] = (0.08, 1.0),
    aspect_ratio_range: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
    max_attempts: int = 10,
) -> Optional[Tuple[int, int, int, int]]:
    """A crop with ``tf.image.sample_distorted_bounding_box`` kernel
    semantics (GenerateRandomCrop): aspect uniform, HEIGHT uniform between
    the area-range bounds, width = round(height * aspect) with the kernel's
    +-1 area adjustment, and the min_object_covered constraint against the
    whole-image bbox. Returns (top, left, crop_h, crop_w), or None after
    ``max_attempts`` failures or for the whole image: the caller then takes
    the center crop (``_at_least_x_are_equal`` :98-103)."""
    total = float(height) * float(width)
    min_area = area_range[0] * total
    max_area = area_range[1] * total
    for _ in range(max_attempts):
        aspect = rng.uniform(*aspect_ratio_range)
        min_h = int(np.ceil(np.sqrt(min_area / aspect)))
        max_h = int(np.floor(np.sqrt(max_area / aspect)))
        # the kernel clamps so the derived width/height fit the image
        if int(round(max_h * aspect)) > width:
            max_h = int((width + 0.5 - 1e-7) / aspect)
        if max_h > height:
            max_h = height
        if min_h > max_h:
            continue
        crop_h = rng.randint(min_h, max_h + 1) if min_h < max_h else min_h
        crop_w = int(round(crop_h * aspect))
        area = crop_h * crop_w
        # the kernel nudges the height by one to pull the rounded area into range
        if area < min_area:
            crop_h += 1
            crop_w = int(round(crop_h * aspect))
            area = crop_h * crop_w
        if area > max_area:
            crop_h -= 1
            crop_w = int(round(crop_h * aspect))
            area = crop_h * crop_w
        if (area < min_area or area > max_area or crop_w > width
                or crop_h > height or crop_w <= 0 or crop_h <= 0):
            continue
        if area < min_object_covered * total:
            continue
        top = rng.randint(0, height - crop_h + 1)
        left = rng.randint(0, width - crop_w + 1)
        if crop_h == height and crop_w == width:
            return None
        return top, left, crop_h, crop_w
    return None


class TfPreprocessTransform:
    """``TfPreprocessTransform`` (:199-226) on ``device``: JPEG/PNG bytes or
    a uint8 (H, W, 3) tensor in, uint8 (size, size, 3) out on ``device``
    ((3, size, size) with ``chw=True``). ``interpolation`` is "bicubic" or
    "bilinear". ``last_box`` holds the crop box of the last call."""

    def __init__(self, is_training: bool = False, size: int = 224,
                 interpolation: str = "bicubic", seed: Optional[int] = None,
                 chw: bool = False, device="cuda"):
        if interpolation not in ("bicubic", "bilinear"):
            raise ValueError(f"interpolation must be bicubic or bilinear, got {interpolation!r}")
        self.is_training = is_training
        self.size = size
        self.interpolation = interpolation
        self.chw = chw
        self.device = resolve_device(device)
        self.rng = np.random.RandomState(seed)
        self.last_box: Optional[Tuple[int, int, int, int]] = None

    def __call__(self, image) -> torch.Tensor:
        from ..explain._imaging import resize_bicubic_u8, resize_bilinear_u8
        from ._decode import decode_image

        if isinstance(image, (bytes, bytearray)):
            image = decode_image(bytes(image), self.device)
        image = image.to(self.device)
        h, w = image.shape[:2]
        size = self.size
        box = random_crop_box(h, w, self.rng) if self.is_training else None
        if box is None:
            box = center_crop_box(h, w, size)
        self.last_box = box
        top, left, ch, cw = box
        planes = image[top:top + ch, left:left + cw].permute(2, 0, 1)
        resize = resize_bicubic_u8 if self.interpolation == "bicubic" else resize_bilinear_u8
        out = resize(planes, size, size)
        if self.is_training and self.rng.rand() < 0.5:
            out = out.flip(-1)  # random_flip_left_right (:129-132)
        return out.contiguous() if self.chw else out.permute(1, 2, 0).contiguous()
