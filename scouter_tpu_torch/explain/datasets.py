"""Benchmark dataset adapters (counterpart of ``scouter_tpu/explain/datasets.py``;
the capability of ``torchray/benchmark/datasets.py``, VOC/COCO wrappers and
label-to-mask converters, without torchvision).

- :func:`voc_annotation_to_mask`: parse a Pascal-VOC XML annotation and
  rasterize the bounding boxes of a class into a {0,1} occupancy mask (the
  ground truth the pointing game tests against).
- :func:`coco_annotation_to_mask`: rasterize COCO polygon/bbox annotations for
  a category into a mask (numpy; the polygon fill is matplotlib's
  ``Path.contains_points`` crossing test, written out, since the card's
  machine has no matplotlib).
- :func:`voc_dataset` / :func:`coco_dataset`: iterate (image_path, class_id,
  mask) triples ready for ``benchmark.run_pointing_benchmark``.

The 20 VOC classes are indexed in the standard alphabetical order.
"""

from __future__ import annotations

import json
import os
import xml.etree.ElementTree as ET
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "VOC_CLASSES",
    "voc_annotation_to_mask",
    "voc_dataset",
    "coco_annotation_to_mask",
    "coco_dataset",
]

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


def voc_annotation_to_mask(xml_path_or_root, class_name: str,
                           include_difficult: bool = True) -> Optional[np.ndarray]:
    """Bounding boxes of `class_name` -> {0,1} (H, W) mask; None if absent.

    Difficult boxes are INCLUDED by default: torchray's voc_as_mask
    (torchray/benchmark/datasets.py:98-125) builds the ground-truth mask from
    every box of the class with no difficult filter, and class presence
    (voc_as_class_ids, :81-95) likewise ignores the flag — excluding them
    changes pointing-game hit/miss decisions vs the reference protocol.

    Accepts a parsed ElementTree root in place of the path (voc_dataset parses
    each annotation once and scans it for all 20 classes)."""
    if isinstance(xml_path_or_root, str):
        root = ET.parse(xml_path_or_root).getroot()
    else:
        root = xml_path_or_root
    size = root.find("size")
    h = int(size.find("height").text)
    w = int(size.find("width").text)
    mask = np.zeros((h, w), np.uint8)
    found = False
    for obj in root.findall("object"):
        if obj.find("name").text != class_name:
            continue
        difficult = obj.find("difficult")
        if not include_difficult and difficult is not None and difficult.text == "1":
            continue
        box = obj.find("bndbox")
        x0 = max(int(float(box.find("xmin").text)) - 1, 0)
        y0 = max(int(float(box.find("ymin").text)) - 1, 0)
        x1 = min(int(float(box.find("xmax").text)), w)
        y1 = min(int(float(box.find("ymax").text)), h)
        mask[y0:y1, x0:x1] = 1
        found = True
    return mask if found else None


def voc_dataset(voc_root: str, image_set: str = "test",
                classes: Sequence[str] = VOC_CLASSES
                ) -> Iterator[Tuple[str, int, np.ndarray]]:
    """Yield (image_path, class_id, mask) for every (image, present class) pair."""
    ann_dir = os.path.join(voc_root, "Annotations")
    img_dir = os.path.join(voc_root, "JPEGImages")
    split = os.path.join(voc_root, "ImageSets", "Main", image_set + ".txt")
    with open(split) as f:
        ids = [line.strip().split()[0] for line in f if line.strip()]
    for image_id in ids:
        xml_path = os.path.join(ann_dir, image_id + ".xml")
        root = ET.parse(xml_path).getroot()  # parse once, scan per class
        for class_id, name in enumerate(classes):
            mask = voc_annotation_to_mask(root, name)
            if mask is not None:
                yield os.path.join(img_dir, image_id + ".jpg"), class_id, mask


def _points_in_polygon(px: np.ndarray, py: np.ndarray, xs: np.ndarray,
                       ys: np.ndarray) -> np.ndarray:
    """matplotlib's ``point_in_path_impl`` (``_path.h``) for one closed
    subpath with radius 0, in float64: the crossing test of a +x ray, each
    edge toggling the points it crosses, the closing edge included. Points
    on an edge fall as matplotlib's comparisons put them."""
    xs = np.asarray(xs, np.float64)
    ys = np.asarray(ys, np.float64)
    inside = np.zeros(px.shape, bool)
    vtx0, vty0 = xs[0], ys[0]
    yflag0 = vty0 >= py
    for j in range(1, len(xs) + 1):
        vtx1, vty1 = (xs[j], ys[j]) if j < len(xs) else (xs[0], ys[0])
        yflag1 = vty1 >= py
        hit = ((vty1 - py) * (vtx0 - vtx1) >= (vtx1 - px) * (vty0 - vty1)) == yflag1
        inside ^= (yflag0 != yflag1) & hit
        yflag0, vtx0, vty0 = yflag1, vtx1, vty1
    return inside


def _fill_polygon(mask: np.ndarray, xs: np.ndarray, ys: np.ndarray) -> None:
    """Rasterise one polygon into mask: pixel centres inside it."""
    h, w = mask.shape
    x0 = max(int(xs.min()), 0)
    x1 = min(int(np.ceil(xs.max())) + 1, w)
    y0 = max(int(ys.min()), 0)
    y1 = min(int(np.ceil(ys.max())) + 1, h)
    if x1 <= x0 or y1 <= y0:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    inside = _points_in_polygon(xx.ravel() + 0.5, yy.ravel() + 0.5, xs, ys)
    mask[y0:y1, x0:x1] |= inside.reshape(y1 - y0, x1 - x0).astype(np.uint8)


def coco_annotation_to_mask(annotations: List[Dict], category_id: int,
                            height: int, width: int) -> Optional[np.ndarray]:
    """COCO polygon/bbox annotations of a category -> {0,1} mask; None if absent."""
    mask = np.zeros((height, width), np.uint8)
    found = False
    for ann in annotations:
        if ann.get("category_id") != category_id:
            continue
        seg = ann.get("segmentation")
        if isinstance(seg, list) and seg:
            for poly in seg:
                arr = np.asarray(poly, np.float32).reshape(-1, 2)
                _fill_polygon(mask, arr[:, 0], arr[:, 1])
            found = True
        elif "bbox" in ann:
            x, y, bw, bh = ann["bbox"]
            mask[int(y): int(y + bh) + 1, int(x): int(x + bw) + 1] = 1
            found = True
    return mask if found else None


def coco_dataset(images_dir: str, annotation_json: str
                 ) -> Iterator[Tuple[str, int, np.ndarray]]:
    """Yield (image_path, category_id, mask) from a COCO instances JSON."""
    with open(annotation_json) as f:
        coco = json.load(f)
    by_image: Dict[int, List[Dict]] = {}
    for ann in coco.get("annotations", []):
        by_image.setdefault(ann["image_id"], []).append(ann)
    categories = {c["id"] for c in coco.get("categories", [])}
    for img in coco.get("images", []):
        anns = by_image.get(img["id"], [])
        present = {a["category_id"] for a in anns} & categories
        for cat in sorted(present):
            mask = coco_annotation_to_mask(anns, cat, img["height"], img["width"])
            if mask is not None:
                yield os.path.join(images_dir, img["file_name"]), cat, mask
