"""One epoch of each image-folder recipe of the reference's README on the
PyTorch port: ConText, an ImageNet subset and CUB-200.

    python examples/torch_run_folder_recipe_smoke.py [--recipes context,imagenet,cub]
        [--compute_dtype bfloat16] [--out FILE]

Counterpart of the JAX package's ``examples/run_folder_recipe_smoke.py``.
It lays out each dataset's tree as the reference's scans read it (flat
prefix-labelled files; train|val class folders; CUB's three metadata files
and images/ by class) in a temporary directory, then drives one train and
one val epoch of the recipe's published flags (README.md:25-52, 130-156,
184-210) through ``train/loop.py::Trainer``: the folder scan, the
streaming ``FolderDataset`` decoding on the device (PNG with
``core/png.py``, JPEG with nvJPEG), the Loader, the train step with K1's
kernels, eval. The images are synthetic: PNGs of noise written by the
port's own ``core/png.py::write_png``, and the committed JPEG fixtures of
``tests/torch_fixtures`` (RGB, gray, progressive, and in the ImageNet tree
the CMYK and YCCK ones, which the card decodes through its CMYK kernel).
This checks the execution path, not accuracy. On the card nothing imports
Pillow; the script fails if a path did.

One JSON line a recipe (loss, accuracy, wall seconds, K1's launches, the
JPEGs nvJPEG decoded and the CMYK kernel's launches). ``--tiny`` shrinks
every recipe (resnet10, 32 px, 3 classes) for a CPU rehearsal. Runs on the
card unless given ``--device cpu``; results also go to ``--out`` (default
``build/torch_run_folder_recipe_smoke.jsonl``).
"""

from __future__ import annotations

import argparse
import math
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_bench_common as common  # noqa: E402

FIXTURES = os.path.join(common.ROOT, "tests", "torch_fixtures")
RGB_JPEGS = ("rgb420_500x375.jpg", "rgb444_375x500.jpg", "progressive_500x333.jpg",
             "gray_500x375.jpg")
CMYK_JPEGS = ("cmyk_400x300.jpg", "ycck_400x300.jpg")

# the reference README's recipe flags (as the JAX script's RECIPES)
RECIPES = {
    "context": dict(dataset="ConText", model="resnest26d", num_classes=30, batch_size=200,
                    channel=2048, use_slot=True, slots_per_class=3, power=2, to_k_layer=3,
                    lambda_value=1.0, loss_status=1, img_size=260),
    "imagenet": dict(dataset="ImageNet", model="resnest26d", num_classes=10, batch_size=70,
                     channel=2048, use_slot=True, slots_per_class=3, power=2, to_k_layer=3,
                     lambda_value=1.0, loss_status=1, img_size=260),
    "cub": dict(dataset="CUB200", model="resnest50d", num_classes=25, batch_size=64,
                channel=2048, use_slot=True, slots_per_class=5, power=2, to_k_layer=3,
                lambda_value=10.0, loss_status=1, img_size=260),
}
# the trees' sizes (the JAX script's) and --tiny's
TREES = {"context": dict(n_classes=30, per_class=20),
         "imagenet": dict(n_classes=10, per_class=21, per_val=7),
         "cub": dict(n_classes=25, per_class=8)}
TINY_TREES = {"context": dict(n_classes=3, per_class=4),
              "imagenet": dict(n_classes=3, per_class=3, per_val=2),
              "cub": dict(n_classes=3, per_class=4)}
TINY = dict(model="resnet10", channel=512, img_size=32, batch_size=4)


def _noise_png(path: str, rng, size: int = 96) -> None:
    from scouter_tpu_torch.core.png import write_png

    write_png(path, rng.randint(0, 255, (size, size, 3), "uint8"))


def _copy_fixture(name: str, path: str) -> None:
    shutil.copyfile(os.path.join(FIXTURES, name), path)


def make_context_tree(root: str, n_classes: int, per_class: int) -> int:
    """Flat ``class<c>_<i>.png`` files; returns the JPEGs written (none)."""
    import numpy as np

    rng = np.random.RandomState(0)
    for c in range(n_classes):
        for i in range(per_class):
            _noise_png(os.path.join(root, f"class{c:02d}_{i:03d}.png"), rng)
    return 0


def make_imagenet_tree(root: str, n_classes: int, per_class: int, per_val: int) -> int:
    """train|val/<wnid>/ folders of noise PNGs; each class's first image a
    fixture JPEG, class 0's the CMYK one in train and the YCCK one in val.
    Returns the JPEGs written."""
    import numpy as np

    rng = np.random.RandomState(1)
    jpegs = 0
    for phase, count in (("train", per_class), ("val", per_val)):
        for c in range(n_classes):
            d = os.path.join(root, phase, f"n{c:08d}")
            os.makedirs(d, exist_ok=True)
            first = (CMYK_JPEGS[phase == "val"] if c == 0
                     else RGB_JPEGS[(c + (phase == "val")) % len(RGB_JPEGS)])
            _copy_fixture(first, os.path.join(d, "img_000.jpg"))
            jpegs += 1
            for i in range(1, count):
                _noise_png(os.path.join(d, f"img_{i:03d}.png"), rng)
    return jpegs


def make_cub_tree(root: str, n_classes: int, per_class: int) -> int:
    """CUB-200-2011's layout: images/<class>/*.jpg (the fixture JPEGs in
    turn) and its metadata files, three quarters of each class in train.
    Returns the JPEGs written."""
    images, labels, splits = [], [], []
    image_id = 1
    for c in range(1, n_classes + 1):
        cls = f"{c:03d}.Synth_Bird_{c}"
        os.makedirs(os.path.join(root, "images", cls), exist_ok=True)
        for i in range(per_class):
            name = f"{cls}/bird_{i:03d}.jpg"
            _copy_fixture(RGB_JPEGS[(c + i) % len(RGB_JPEGS)],
                          os.path.join(root, "images", name))
            images.append((image_id, name))
            labels.append((image_id, c))
            splits.append((image_id, 1 if i < per_class * 3 // 4 else 0))
            image_id += 1
    for fname, rows in (("images.txt", images), ("image_class_labels.txt", labels),
                        ("train_test_split.txt", splits)):
        with open(os.path.join(root, fname), "w") as f:
            f.writelines(f"{a} {b}\n" for a, b in rows)
    with open(os.path.join(root, "classes.txt"), "w") as f:
        f.writelines(f"{c} {c:03d}.Synth_Bird_{c}\n" for c in range(1, n_classes + 1))
    return len(images)


MAKERS = {"context": make_context_tree, "imagenet": make_imagenet_tree, "cub": make_cub_tree}


def run_recipe(name: str, device, compute_dtype: str, tiny: bool, card) -> dict:
    """Lay out the recipe's tree and run one train and one val epoch."""
    from scouter_tpu_torch.core import ScouterConfig
    from scouter_tpu_torch.data import _decode
    from scouter_tpu_torch.ops.slot_kernel import xslot_iterations_fused as k1
    from scouter_tpu_torch.train import Trainer

    spec = dict(RECIPES[name], **(TINY if tiny else {}))
    tree = (TINY_TREES if tiny else TREES)[name]
    if tiny:
        spec["num_classes"] = tree["n_classes"]
    root = tempfile.mkdtemp(prefix=f"torch_recipe_{name}_")
    try:
        jpegs = MAKERS[name](root, **tree)
        cfg = ScouterConfig(**spec, dataset_dir=root, epochs=1, lr=1e-4, seed=0,
                            output_dir="", pre_trained=False, compute_dtype=compute_dtype,
                            device=str(device))
        counts = (k1.launches, _decode.decode_jpeg.decodes, _decode.cmyk_to_rgb.launches)
        t0 = time.perf_counter()
        trainer = Trainer(cfg)
        m_train = trainer.run_epoch(0, "train")
        m_val = trainer.run_epoch(0, "val")
        common.sync(device)
        wall = time.perf_counter() - t0
        ok = math.isfinite(m_train["loss"]) and math.isfinite(m_val["loss"])
        return {"recipe": name, "status": "OK" if ok else "NONFINITE", "model": cfg.model,
                "batch_size": cfg.batch_size, "img_size": cfg.img_size,
                "compute_dtype": compute_dtype, "train_images": len(trainer.loader_train.ds),
                "train_loss": m_train["loss"], "val_loss": m_val["loss"],
                "train_acc": m_train["acc"], "val_acc": m_val["acc"], "wall_s": wall,
                "k1_forward_calls": k1.launches - counts[0], "tree_jpegs": jpegs,
                "nvjpeg_decodes": _decode.decode_jpeg.decodes - counts[1],
                "cmyk_kernel_launches": _decode.cmyk_to_rgb.launches - counts[2],
                "card": card, "device": str(device)}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    common.add_device_arg(p)
    p.add_argument("--recipes", default="context,imagenet,cub")
    p.add_argument("--compute_dtype", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--tiny", action="store_true", help="resnet10, 32 px, 3 classes")
    p.add_argument("--out", default=os.path.join(common.BUILD,
                                                 "torch_run_folder_recipe_smoke.jsonl"))
    args = p.parse_args(argv)
    device, card = common.setup(args.device)
    failures = 0
    for name in args.recipes.split(","):
        record = run_recipe(name, device, args.compute_dtype, args.tiny, card)
        failures += record["status"] != "OK"
        common.emit(record, args.out)
    if device.type == "cuda" and "PIL" in sys.modules:
        print("Pillow was imported on the card's path", file=sys.stderr)
        failures += 1
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
