"""Training CLI (counterpart of ``scouter_tpu/train/cli.py``; the reference's
``train.py``): argparse schema, sweeps over comma lists, cost profiling.

    python -m scouter_tpu_torch.train.cli --model resnet18 --dataset MNIST ...

accepts the reference's flags (``core/config.py``); ``--device`` is ``cuda``
by default. A comma list in num_classes / lambda_value / power /
slots_per_class runs a grid, each cell trained ``iterated_evaluation_num``
times (``param_translation``, ``train.py:207-230``).

Under ``python -m torch.distributed.run --nproc_per_node N -m
scouter_tpu_torch.train.cli ... --mesh_shape N`` one process runs on each
device: :func:`main` first starts the process group from the launcher's
environment (``core/distributed.py::init_distributed_mode``: NCCL on the
card, gloo with ``--device cpu``), and destroys it at the end. Without the
launcher it trains in this one process.

``--thop`` (``train.py:91-137``) prints the parameter count (M) and the
GFLOPs of one forward at (1, C, 260, 260), counted by
``torch.utils.flop_counter.FlopCounterMode`` in place of the thop library,
then exits without training.
"""

from __future__ import annotations

import argparse
import pathlib
from typing import Dict, List

from ..core.config import expand_sweep, get_args_parser
from ..core.distributed import init_distributed_mode, is_dist_avail_and_initialized
from .loop import run_training

__all__ = ["main", "model_cost", "param_translation"]


def model_cost(cfg) -> List[float]:
    """[params_M, GFLOPs] of one forward at (1, C, 260, 260) on cfg.device,
    in the config's compute dtype. The slot loop runs as plain ops here so
    that the counter sees it."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ..core.config import compute_dtype
    from ..models import build_slot_model

    model = build_slot_model(cfg, device=cfg.device, compute_dtype=compute_dtype(cfg))
    chans = 1 if cfg.dataset == "MNIST" else 3
    x = torch.zeros((1, chans, 260, 260), device=next(model.parameters()).device)
    n_params = sum(p.numel() for p in model.parameters())
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model(x)
    params_m, gflops = n_params / 1e6, counter.get_total_flops() / 1e9
    print(params_m, "M", f"{gflops:.3f} GFLOPs @ (1,{chans},260,260)")
    return [params_m, gflops]


def param_translation(ns: argparse.Namespace):
    """Sweep expansion + training (train.py:207-230 semantics)."""
    singles = list(expand_sweep(ns))
    if len(singles) == 1 and singles[0][0] is None:
        cfg = singles[0][1]
        if cfg.thop:
            return model_cost(cfg)
        return run_training(cfg)

    record: Dict[str, List] = {}
    for key, cfg in singles:
        record.setdefault(key, [])
        for _turn in range(cfg.iterated_evaluation_num):
            record[key].append(run_training(cfg))
            print(record)
    return record


def main(argv=None):
    parser = argparse.ArgumentParser(
        "SCOUTER training and evaluation script (PyTorch/CUDA port)",
        parents=[get_args_parser()])
    ns = parser.parse_args(argv)
    started = not is_dist_avail_and_initialized()
    init_distributed_mode(device="cpu" if ns.device == "cpu" else None)
    started = started and is_dist_avail_and_initialized()
    try:
        if ns.output_dir:
            pathlib.Path(ns.output_dir).mkdir(parents=True, exist_ok=True)
        return param_translation(ns)
    finally:
        if started:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    main()
