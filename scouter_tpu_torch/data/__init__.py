"""Data layer: dataset readers, folder scans, device-side transforms and the
loader (counterpart of ``scouter_tpu/data``)."""

from .folders import load_image_list, scan_context, scan_cub200, scan_imagenet_subset
from .mnist import load_mnist, mnist_or_synthetic, synthetic_mnist
from .pipeline import ArrayDataset, Loader
from .streaming import FolderDataset
from .tf_pre import TfPreprocessTransform
from .transforms import NORMALIZE_VALUES, augment_batch, preprocess_batch, resize_bilinear

__all__ = [
    "ArrayDataset",
    "FolderDataset",
    "Loader",
    "NORMALIZE_VALUES",
    "TfPreprocessTransform",
    "augment_batch",
    "load_image_list",
    "load_mnist",
    "mnist_or_synthetic",
    "preprocess_batch",
    "resize_bilinear",
    "scan_context",
    "scan_cub200",
    "scan_imagenet_subset",
    "select_dataset",
    "synthetic_mnist",
]


def select_dataset(cfg, train: bool = True):
    """choose_dataset.select_dataset parity (``dataset/choose_dataset.py:7-29``).

    MNIST reads the IDX files or falls back to ``synthetic_mnist``. The
    folder datasets read the images their scan finds through a
    ``FolderDataset`` on ``cfg.device``, staged at exactly ``img_size`` (the
    staging resize is then the only resize, as the reference's single
    Resize), or fall back to a synthetic stand-in at ``img_size`` when the
    scan finds nothing."""
    if cfg.dataset == "MNIST":
        images, labels = mnist_or_synthetic(cfg.dataset_dir, train=train,
                                            num_classes=cfg.num_classes)
        return ArrayDataset(images, labels, "MNIST")
    if cfg.dataset == "ConText":
        tr, va = scan_context(cfg.dataset_dir)
    elif cfg.dataset == "ImageNet":
        tr, va = scan_imagenet_subset(cfg.dataset_dir, cfg.num_classes)
    elif cfg.dataset == "CUB200":
        tr, va = scan_cub200(cfg.dataset_dir, cfg.num_classes)
    else:
        raise ValueError(f"unknown dataset {cfg.dataset!r}")
    items = tr if train else va
    if not items:
        return _synthetic_folder(cfg.dataset, cfg.num_classes, cfg.img_size, train)
    return FolderDataset(items, cfg.img_size, cfg.dataset, device=cfg.device)


def _synthetic_folder(dataset: str, num_classes: int, size: int, train: bool) -> ArrayDataset:
    """Synthetic RGB stand-in for the folder datasets when nothing is on
    disk: a noisy class-located gaussian blob per image (the JAX package's
    numpy calls in its order, so the arrays are the same)."""
    import numpy as np

    n = 256 if train else 128
    rng = np.random.RandomState(0 if train else 1)
    labels = rng.randint(0, num_classes, size=n).astype(np.int32)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    grid = max(1, int(np.ceil(np.sqrt(num_classes))))
    step = size / (grid + 1)
    images = np.empty((n, size, size, 3), np.uint8)
    for i, k in enumerate(labels):
        cx = step * (1 + k % grid) + rng.randn() * 2
        cy = step * (1 + k // grid) + rng.randn() * 2
        blob = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * (size / 12) ** 2)))
        noise = rng.rand(size, size, 3) * 0.3
        img = np.clip(blob[..., None] * 0.7 + noise, 0, 1)
        images[i] = (img * 255).astype(np.uint8)
    return ArrayDataset(images, labels, dataset)
