"""The negative MNIST recipe under three precisions, on the PyTorch port.

    python examples/torch_bf16_negative_ablation.py [--epochs 4] [--num_train 2048]
        [--seeds 1] [--variants fp32,bf16+fp32head,bf16full] [--out FILE]

Counterpart of the JAX package's ``examples/bf16_negative_ablation.py``: the
negative SCOUTER recipe (loss_status -1, 2 slots a class, power 2, lambda
1.5, resnet18) trained on the same synthetic MNIST data, seed and schedule
through ``train/loop.py::Trainer`` under

  fp32           -- everything float32;
  bf16+fp32head  -- a bf16 backbone, the slot head (conv1x1, position
                    embedding, xSlot) in float32;
  bf16full       -- everything bf16 (``--slot_head_dtype compute``; K1 takes
                    bf16 inputs and computes in float32).

One JSON line a (seed, variant): train and val accuracy and wall seconds.
Runs on the card unless given ``--device cpu``; results also go to
``--out`` (default ``build/torch_bf16_negative_ablation.jsonl``).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_bench_common as common  # noqa: E402

VARIANTS = (("fp32", dict(compute_dtype="float32")),
            ("bf16+fp32head", dict(compute_dtype="bfloat16", slot_head_dtype="float32")),
            ("bf16full", dict(compute_dtype="bfloat16", slot_head_dtype="compute")))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    common.add_device_arg(p)
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--num_train", type=int, default=2048)
    p.add_argument("--img_size", type=int, default=260)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--model", default="resnet18")
    p.add_argument("--seeds", type=int, default=1)
    p.add_argument("--variants", default=",".join(name for name, _ in VARIANTS))
    p.add_argument("--out", default=os.path.join(common.BUILD,
                                                 "torch_bf16_negative_ablation.jsonl"))
    args = p.parse_args(argv)
    device, card = common.setup(args.device)

    from scouter_tpu_torch.core import ScouterConfig
    from scouter_tpu_torch.data import ArrayDataset, synthetic_mnist
    from scouter_tpu_torch.train import Trainer

    wanted = args.variants.split(",")
    unknown = sorted(set(wanted) - {name for name, _ in VARIANTS})
    if unknown:
        raise SystemExit(f"unknown variants {unknown}")
    for seed in range(args.seeds):
        tr, te = synthetic_mnist(args.num_train, args.num_train // 4)
        datasets = (ArrayDataset(*tr, "MNIST"), ArrayDataset(*te, "MNIST"))
        base = dict(model=args.model, dataset="MNIST", num_classes=10, channel=512,
                    img_size=args.img_size, batch_size=args.batch_size, epochs=args.epochs,
                    lr=1e-4, output_dir="", seed=seed, pre_trained=False, freeze_layers=0,
                    use_slot=True, loss_status=-1, slots_per_class=2, power=2, to_k_layer=1,
                    lambda_value=1.5, device=str(device))
        for name, extra in VARIANTS:
            if name not in wanted:
                continue
            t0 = time.perf_counter()
            train_acc, val_acc = Trainer(ScouterConfig(**base, **extra),
                                         datasets=datasets).fit()
            common.emit({"seed": seed, "variant": name, "epochs": args.epochs,
                         "num_train": args.num_train, "img_size": args.img_size,
                         "train_acc": train_acc, "val_acc": val_acc,
                         "wall_s": time.perf_counter() - t0, "data": "synthetic",
                         "card": card, "device": str(device)}, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
