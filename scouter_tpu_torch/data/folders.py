"""Item lists of the folder-backed datasets: ConText, ImageNet subsets
and CUB-200 (counterpart of ``scouter_tpu/data/folders.py``).

Pure ``os`` scans whose split logic is the reference's, so the same
directories give the same train/val membership:

- ConText (``dataset/ConText.py:10-36``): flat directory scan (sorted file
  names), label = file-name prefix before '_' through the sorted category
  list, sklearn's ``train_test_split(random_state=1, train_size=0.8)``,
  re-derived here with numpy (the chip machine has no sklearn).
- ImageNet subset (``dataset/ConText.py:39-66``): the first ``num_classes``
  sorted class folders of ``train/``; walk ``train/`` and ``val/``.
- CUB-200 (``dataset/CUB200.py:8-82``): the official metadata files; keep the
  images whose class index (first 3 characters of the name) is at most
  ``num_classes``; labels shifted to 0-based.

Decoding the images needs a reader of its own (``FolderDataset``), which is
not ported yet.
"""

from __future__ import annotations

import math
import os
from typing import List, Tuple

import numpy as np

__all__ = ["scan_context", "scan_cub200", "scan_imagenet_subset"]

PathLabel = Tuple[str, int]


def _sorted_files(root: str) -> List[str]:
    for _, _, files in os.walk(root):
        return sorted(files)
    return []


def _sorted_dirs(root: str) -> List[str]:
    for _, dirs, _ in os.walk(root):
        return sorted(dirs)
    return []


def _train_test_split(items: list, random_state: int, train_size: float):
    """sklearn ``train_test_split(items, random_state=..., train_size=...)``
    for a float ``train_size``: ShuffleSplit's permutation, test first."""
    n = len(items)
    n_train = math.floor(train_size * n)
    n_test = n - n_train
    if n_train == 0:
        raise ValueError(f"With n_samples={n} and train_size={train_size}, the "
                         "resulting train set would be empty")
    perm = np.random.RandomState(random_state).permutation(n)
    train = [items[i] for i in perm[n_test:n_test + n_train]]
    test = [items[i] for i in perm[:n_test]]
    return train, test


def scan_context(root: str, ratio: float = 0.8) -> Tuple[List[PathLabel], List[PathLabel]]:
    """ConText: label from the file-name prefix, fixed-seed 80/20 split."""
    all_images = _sorted_files(root)
    categories = sorted({name[: name.find("_")] for name in all_images})
    cat_index = {c: i for i, c in enumerate(categories)}
    all_data = [(os.path.join(root, name), cat_index[name[: name.find("_")]])
                for name in all_images]
    return _train_test_split(all_data, random_state=1, train_size=ratio)


def scan_imagenet_subset(root: str, num_classes: int) -> Tuple[List[PathLabel], List[PathLabel]]:
    """ImageNet-style tree: the first N sorted class folders of train/."""
    used = _sorted_dirs(os.path.join(root, "train"))[:num_classes]

    def walk(phase: str) -> List[PathLabel]:
        out: List[PathLabel] = []
        for label, folder in enumerate(used):
            folder_root = os.path.join(root, phase, folder)
            for name in _sorted_files(folder_root):
                out.append((os.path.join(folder_root, name), label))
        return out

    return walk("train"), walk("val")


def scan_cub200(root: str, num_classes: int) -> Tuple[List[PathLabel], List[PathLabel]]:
    """CUB-200-2011 metadata parse with the reference's class filter."""

    def read_pairs(fname: str) -> List[Tuple[str, str]]:
        with open(os.path.join(root, fname)) as f:
            return [tuple(line.strip().split()) for line in f if line.strip()]

    split = dict(read_pairs("train_test_split.txt"))  # image_id -> '1'/'0'
    id_label = dict(read_pairs("image_class_labels.txt"))  # image_id -> class_id
    train: List[PathLabel] = []
    test: List[PathLabel] = []
    for image_id, image_name in read_pairs("images.txt"):
        if int(image_name[:3]) > num_classes:
            continue
        label = int(id_label[image_id]) - 1  # 0-based (CUB200.py:72)
        item = (os.path.join(root, "images", image_name), label)
        (train if split[image_id] == "1" else test).append(item)
    return train, test
