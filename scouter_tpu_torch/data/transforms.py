"""Batched preprocessing on the images' device (counterpart of
``scouter_tpu/data/transforms.py``), eval mode:

    Resize(img_size, bilinear) -> /255 -> Normalize(mean, std)

with the reference's per-dataset constants. Images stay uint8 (B, H, W, C)
until they are on the device. Training augmentation is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

__all__ = ["NORMALIZE_VALUES", "preprocess_batch", "resize_bilinear"]

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


def preprocess_batch(images_u8: torch.Tensor, *, dataset: str, img_size: int,
                     train: bool = False) -> torch.Tensor:
    """uint8 (B, H, W, C) -> normalised float32 (B, img_size, img_size, C)."""
    if train:
        raise NotImplementedError("training-mode preprocessing (augmentation) is not ported yet")
    x = resize_bilinear(images_u8, img_size)
    mean, std = NORMALIZE_VALUES[dataset]
    mean = torch.tensor(mean, dtype=torch.float32, device=x.device) * 255.0
    std = torch.tensor(std, dtype=torch.float32, device=x.device) * 255.0
    return (x - mean) / std
