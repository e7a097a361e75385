"""The reference's MNIST recipe chain (README.md:84-120) through the PyTorch
port's command lines.

    python examples/torch_run_mnist_recipes.py [--epochs 3] [--num_train 2048]
        [--img_size 260] [--output_dir build/torch_mnist_recipes] [--out FILE]

Counterpart of the JAX package's ``examples/run_mnist_recipes.py``, run
through ``scouter_tpu_torch/train/cli.py`` and ``explain/cli.py`` as a user
would run them:

1. pre-train the no-slot baseline (README.md:84-88);
2. positive SCOUTER with ``--use_pre true`` (README.md:91-97), booting its
   backbone from step 1's checkpoint;
3. negative SCOUTER, ``--loss_status -1`` (README.md:99-105);
4. the test.py flow: the explain CLI restores step 2's checkpoint and writes
   ``sloter_vis/{image,slot_i,slot_mask_i}.png`` under the output directory.

No MNIST files are on either machine: the script writes the synthetic
stand-in (``data/mnist.py::synthetic_mnist``, ``--num_train`` images and a
quarter of that for val) as IDX files under the output directory, which the
CLI's reader takes for MNIST. One JSON line a step (train and val
accuracy, wall seconds), then the PNGs written. Runs on the card unless
given ``--device cpu``; results also go to ``--out`` (default
``build/torch_run_mnist_recipes.jsonl``).
"""

from __future__ import annotations

import argparse
import os
import struct
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_bench_common as common  # noqa: E402

# (step, flags beyond the shared ones): the README's recipes
STEPS = (("no_slot pretrain", ["--use_slot", "false"]),
         ("positive SCOUTER (use_pre)", ["--use_slot", "true", "--use_pre", "true",
                                         "--loss_status", "1", "--slots_per_class", "1",
                                         "--power", "1", "--to_k_layer", "1",
                                         "--lambda_value", "1.0"]),
         ("negative SCOUTER", ["--use_slot", "true", "--loss_status", "-1",
                               "--slots_per_class", "2", "--power", "2", "--to_k_layer", "1",
                               "--lambda_value", "1.5"]))


def write_idx(path: str, array) -> None:
    """An uint8 IDX file (MNIST's format) of ``array``."""
    with open(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | array.ndim))
        f.write(struct.pack(f">{array.ndim}I", *array.shape))
        f.write(array.astype("uint8").tobytes())


def write_synthetic_mnist(root: str, num_train: int) -> None:
    from scouter_tpu_torch.data import synthetic_mnist

    (tr_x, tr_y), (te_x, te_y) = synthetic_mnist(num_train, num_train // 4)
    os.makedirs(root, exist_ok=True)
    for name, arr in (("train-images-idx3-ubyte", tr_x[..., 0]),
                      ("train-labels-idx1-ubyte", tr_y), ("t10k-images-idx3-ubyte", te_x[..., 0]),
                      ("t10k-labels-idx1-ubyte", te_y)):
        write_idx(os.path.join(root, name), arr)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    common.add_device_arg(p)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--num_train", type=int, default=2048)
    p.add_argument("--img_size", type=int, default=260)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--model", default="resnet18")
    p.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--output_dir", default=os.path.join(common.BUILD, "torch_mnist_recipes"))
    p.add_argument("--out", default=os.path.join(common.BUILD,
                                                 "torch_run_mnist_recipes.jsonl"))
    args = p.parse_args(argv)
    device, card = common.setup(args.device)

    from scouter_tpu_torch.explain import cli as explain_cli
    from scouter_tpu_torch.train import cli as train_cli

    out_dir = os.path.abspath(args.output_dir)
    data_dir = os.path.join(out_dir, "data")
    write_synthetic_mnist(data_dir, args.num_train)
    shared = ["--device", str(device), "--dataset", "MNIST", "--model", args.model,
              "--num_classes", "10", "--channel", "512", "--img_size", str(args.img_size),
              "--batch_size", str(args.batch_size), "--lr", "1e-4", "--seed", "0",
              "--pre_trained", "false", "--freeze_layers", "0",
              "--compute_dtype", args.compute_dtype, "--dataset_dir", data_dir,
              "--output_dir", out_dir]
    for name, flags in STEPS:
        t0 = time.perf_counter()
        train_acc, val_acc = train_cli.main(shared + ["--epochs", str(args.epochs)] + flags)
        common.emit({"step": name, "train_acc": train_acc, "val_acc": val_acc,
                     "wall_s": time.perf_counter() - t0, "epochs": args.epochs,
                     "num_train": args.num_train, "img_size": args.img_size,
                     "data": "synthetic", "card": card, "device": str(device)}, args.out)
    # 4. the test.py flow on step 2's checkpoint, into <output_dir>/sloter_vis
    cwd = os.getcwd()
    os.chdir(out_dir)
    try:
        t0 = time.perf_counter()
        explain_cli.main(shared + STEPS[1][1])
    finally:
        os.chdir(cwd)
    vis = os.path.join(out_dir, "sloter_vis")
    pngs = sorted(f for f in os.listdir(vis) if f.endswith(".png"))
    common.emit({"step": "heatmaps (explain CLI)", "pngs": len(pngs), "dir": vis,
                 "wall_s": time.perf_counter() - t0, "card": card, "device": str(device)},
                args.out)
    return 0 if len(pngs) == 1 + 2 * 10 else 1


if __name__ == "__main__":
    sys.exit(main())
