"""Training throughput and utilisation of the PyTorch port on one GPU.

    python examples/torch_bench_train.py [--compute_dtype float32,bfloat16]
        [--batch_size 70] [--iters 30] [--end-to-end [--aug]] [--out FILE]

Counterpart of the JAX package's ``examples/bench_train.py``: the flagship
resnest26d + xSlot (224 px, seeded random weights) through the Trainer's
train step (forward, backward with K1's kernels, AdamW, metrics) on one
device-resident batch, for each compute dtype: img/s, achieved TFLOP/s (the
FLOPs of one whole step, forward and backward, counted by
``utils/profiling.py::model_cost_analysis``, x steps / s) and ``mfu``
against the card's published dense peak for the dtype, beside the card's
name and power limit. ``--end-to-end`` times ``Trainer.run_epoch`` over an
in-memory dataset through the Loader (device preprocessing, with ``--aug``
the augmentation chain) for two epochs after an untimed one, and the host's
batch assembly alone.

Runs on the card unless given ``--device cpu``; results also go to
``--out`` (default ``build/torch_bench_train.jsonl``).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_bench_common as common  # noqa: E402


def step_record(trainer, cfg, device, iters: int, card):
    """The train step on one batch: img/s, TFLOP/s and mfu."""
    import numpy as np
    import torch

    from scouter_tpu_torch.utils import model_cost_analysis

    rng = np.random.RandomState(0)
    batch = {"image": torch.from_numpy(rng.randn(cfg.batch_size, 3, cfg.img_size,
                                                 cfg.img_size).astype(np.float32)).to(device),
             "label": torch.from_numpy(rng.randint(0, cfg.num_classes,
                                                   cfg.batch_size)).long().to(device)}
    state = trainer.state
    flops = model_cost_analysis(trainer.train_step, state, batch)["flops"]
    for _ in range(3):
        state, m = trainer.train_step(state, batch)
    common.sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        state, m = trainer.train_step(state, batch)
    common.sync(device)
    seconds = time.perf_counter() - t0
    if not bool(torch.isfinite(m["loss"])):
        raise SystemExit(f"non-finite loss {m['loss']}")
    record = {"metric": f"train img/s ({cfg.model}+xSlot, {cfg.img_size}px, "
                        f"bs={cfg.batch_size}, {cfg.compute_dtype})",
              "value": cfg.batch_size * iters / seconds, "unit": "img/s",
              "ms_per_step": seconds / iters * 1e3, "flops_per_step": flops, "card": card,
              "device": str(device)}
    record.update(common.utilisation(flops, iters, seconds, common.card_kind(device),
                                     cfg.compute_dtype))
    return record


def end_to_end_record(trainer, cfg, device, card):
    """Two timed epochs of ``Trainer.run_epoch`` after an untimed one, and
    the host's batch assembly alone."""
    trainer.run_epoch(0, "train")
    common.sync(device)
    steps = trainer.loader_train.steps_per_epoch()
    t0 = time.perf_counter()
    for epoch in (1, 2):
        trainer.run_epoch(epoch, "train")
    common.sync(device)
    seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = sum(1 for _ in trainer.loader_train._host_batches(3))
    host_seconds = time.perf_counter() - t0
    return {"metric": f"end-to-end train img/s (epoch with the Loader, {cfg.model}+xSlot, "
                      f"{cfg.img_size}px, bs={cfg.batch_size}, {cfg.compute_dtype}, "
                      f"aug={cfg.aug})",
            "value": 2 * steps * cfg.batch_size / seconds, "unit": "img/s",
            "steps_per_epoch": steps,
            "host_assembly_img_s": host * cfg.batch_size / host_seconds, "card": card,
            "device": str(device)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    common.add_device_arg(p)
    p.add_argument("--compute_dtype", default="float32,bfloat16",
                   help="comma list of float32, bfloat16")
    p.add_argument("--batch_size", type=int, default=70)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--end-to-end", action="store_true", dest="end_to_end")
    p.add_argument("--aug", action="store_true", help="with --end-to-end: augmentation")
    p.add_argument("--model", default=None, help="backbone (default: the flagship's)")
    p.add_argument("--img_size", type=int, default=None)
    p.add_argument("--channel", type=int, default=None)
    p.add_argument("--out", default=os.path.join(common.BUILD, "torch_bench_train.jsonl"))
    args = p.parse_args(argv)
    device, card = common.setup(args.device)

    import numpy as np

    from scouter_tpu_torch.data import ArrayDataset
    from scouter_tpu_torch.train import Trainer

    overrides = {k: v for k, v in (("model", args.model), ("img_size", args.img_size),
                                   ("channel", args.channel)) if v is not None}
    for dtype in args.compute_dtype.split(","):
        cfg = common.flagship(batch_size=args.batch_size, compute_dtype=dtype, output_dir="",
                              aug=args.aug, device=str(device), **overrides)
        rng = np.random.RandomState(0)
        n = args.batch_size * (6 if args.end_to_end else 1)
        ds = ArrayDataset(rng.randint(0, 255, (n, cfg.img_size, cfg.img_size, 3), np.uint8),
                          rng.randint(0, cfg.num_classes, n).astype(np.int64), cfg.dataset)
        trainer = Trainer(cfg, datasets=(ds, ds))
        record = (end_to_end_record(trainer, cfg, device, card) if args.end_to_end
                  else step_record(trainer, cfg, device, args.iters, card))
        common.emit(record, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
