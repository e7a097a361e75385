"""MNIST: IDX file parsing and a deterministic synthetic stand-in
(counterpart of ``scouter_tpu/data/mnist.py``).

There is no download: :func:`load_mnist` reads the standard IDX files from
``<root>/MNIST/raw``, ``<root>/raw`` or ``<root>`` (gz or raw), and
:func:`synthetic_mnist` makes a learnable dataset of the same shapes and types
when they are absent. The numpy calls and their order are the JAX package's,
so both packages draw the same arrays from the same seed.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

__all__ = ["load_mnist", "load_mnist_variant", "mnist_or_synthetic", "synthetic_mnist"]

_FILES = {
    True: ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
    False: ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
}

# The reference vendors Fashion/K/E/QMNIST beside MNIST (dataset/mnist.py:161-421);
# they share the IDX format and differ only in the download source and the
# subdirectory. There is no download: they are read from disk.
_VARIANT_SUBDIRS = {
    "MNIST": "MNIST",
    "FashionMNIST": "FashionMNIST",
    "KMNIST": "KMNIST",
    "EMNIST": "EMNIST",
    "QMNIST": "QMNIST",
}
# the official EMNIST/QMNIST archives prefix the IDX file names
# (emnist-<split>-train-images-idx3-ubyte, qmnist-train-images-idx3-ubyte)
_VARIANT_PREFIXES = {
    "EMNIST": ("emnist-balanced-", "emnist-byclass-", "emnist-digits-", "emnist-letters-",
               "emnist-mnist-"),
    "QMNIST": ("qmnist-",),
}


def _open_maybe_gz(path: str):
    if os.path.exists(path):
        return open(path, "rb")
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    raise FileNotFoundError(path)


def _read_idx(path: str) -> np.ndarray:
    with _open_maybe_gz(path) as f:
        magic = struct.unpack(">I", f.read(4))[0]
        dtype_code = (magic >> 8) & 0xFF
        ndim = magic & 0xFF
        if dtype_code != 0x08:
            raise ValueError(f"unsupported IDX dtype 0x{dtype_code:02x} in {path}")
        shape = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
        return data.reshape(shape)


def load_mnist(root: str, train: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (images (N,28,28,1) uint8, labels (N,) int32)."""
    img_name, lbl_name = _FILES[train]
    candidates = [os.path.join(root, "MNIST", "raw"), os.path.join(root, "raw"), root]
    last_err: Optional[Exception] = None
    for d in candidates:
        try:
            images = _read_idx(os.path.join(d, img_name))
            labels = _read_idx(os.path.join(d, lbl_name))
            return images[..., None], labels.astype(np.int32)
        except FileNotFoundError as e:
            last_err = e
    raise FileNotFoundError(
        f"MNIST IDX files not found under {root!r} (no download in this build). "
        f"Last: {last_err}")


def load_mnist_variant(root: str, variant: str = "MNIST", train: bool = True
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Fashion/K/E/QMNIST: the IDX layout under ``<root>/<variant>``, else
    under ``root`` (each as :func:`load_mnist` searches it), else the
    EMNIST/QMNIST-prefixed names under ``<root>/<variant>``, its ``raw`` and
    ``root``. Returns (images (N,28,28,1) uint8, labels (N,) int32)."""
    if variant not in _VARIANT_SUBDIRS:
        raise ValueError(f"unknown MNIST variant {variant!r}; known: {sorted(_VARIANT_SUBDIRS)}")
    sub = _VARIANT_SUBDIRS[variant]
    for candidate in (os.path.join(root, sub), root):
        try:
            return load_mnist(candidate, train)
        except FileNotFoundError:
            continue
    img_name, lbl_name = _FILES[train]
    for prefix in _VARIANT_PREFIXES.get(variant, ()):
        for candidate in (os.path.join(root, sub), os.path.join(root, sub, "raw"), root):
            try:
                images = _read_idx(os.path.join(candidate, prefix + img_name))
                labels = _read_idx(os.path.join(candidate, prefix + lbl_name))
                return images[..., None], labels.astype(np.int32)
            except FileNotFoundError:
                continue
    raise FileNotFoundError(f"{variant} IDX files not found under {root!r}")


def synthetic_mnist(num_train: int = 2048, num_test: int = 512, seed: int = 0,
                    num_classes: int = 10):
    """Deterministic learnable stand-in: each class is a noisy 2D gaussian blob
    at a class-specific location on a 28x28 canvas. ``num_classes`` caps the
    label range (at most 10 blob locations exist)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32)

    centers = [(7 + 5 * (k % 4), 7 + 5 * (k // 4)) for k in range(10)]
    n_cls = max(1, min(int(num_classes), len(centers)))

    def make(n):
        labels = rng.randint(0, n_cls, size=n).astype(np.int32)
        cx = np.array([centers[k][0] for k in labels], np.float32)
        cy = np.array([centers[k][1] for k in labels], np.float32)
        jitter = rng.randn(2, n).astype(np.float32) * 1.0
        blob = np.exp(
            -((xx[None] - (cx + jitter[0])[:, None, None]) ** 2
              + (yy[None] - (cy + jitter[1])[:, None, None]) ** 2) / 8.0
        )
        noise = rng.rand(n, 28, 28).astype(np.float32) * 0.15
        images = np.clip((blob + noise) * 255.0, 0, 255).astype(np.uint8)
        return images[..., None], labels

    return make(num_train), make(num_test)


def mnist_or_synthetic(root: str, train: bool = True, num_classes: int = 10):
    """Real MNIST if present on disk, else the synthetic stand-in
    (``num_classes`` only bounds the stand-in's labels)."""
    try:
        return load_mnist(root, train)
    except FileNotFoundError:
        tr, te = synthetic_mnist(num_classes=num_classes)
        return tr if train else te
