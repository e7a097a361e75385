"""Where the time of the PyTorch port's train step goes, on one GPU.

    python examples/torch_profile_train.py [--config flagship|cub] [--model NAME]
        [--batch B] [--compute_dtype float32|bfloat16] [--iters 10] [--out FILE]

Builds the flagship resnest26d + xSlot (default, batch 70, f32) or the
CUB-200 recipe (resnest50d, 200 x 5 slots, 260 px; batch 16, bf16) with
seeded random weights, the configs of ``chip_smoke.py`` (``--model`` swaps
in another registered backbone), and runs
``train.make_train_step`` on one repeated batch of the synthetic stand-in.
It reports, as one JSON line:

- ``stages_ms``: device time per step of the forward (split into backbone,
  head and xSlot), the loss and backward (with the part spent in K1's
  checkpointed backward, ``xslot_bwd``) and the AdamW update, from CUDA
  events recorded by module and optimizer hooks and around the backward of
  ``ops.slot_kernel._XSlotFused``;
- ``by_kind_ms`` and ``top_kernels``: device time per step of each kernel
  under ``torch.profiler``, summed by kind; ``idle_share``: 1 - (device busy
  time / wall time) over the profiled steps;
- ``bn_route_ms``: host-clock ms per step with the port's BatchNorm (flax's
  running-variance update, ``models.layers.BatchNorm2d``) and with the stock
  ``nn.BatchNorm2d`` forward, timed in turns (port, stock, stock, port).

Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))
sys.path.insert(0, HERE)


def _event():
    import torch

    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def stage_times(step, state, batch, iters):
    """Mean device ms per train step and stage, from CUDA events."""
    import torch

    from scouter_tpu_torch.models import ResNet, SlotModel, XSlot
    from scouter_tpu_torch.ops import slot_kernel

    marks, bwd = {}, []

    def pre(module, args):
        if isinstance(module, (ResNet, XSlot, SlotModel)):
            marks[type(module).__name__ + "_in"] = _event()

    def post(module, args, out):
        if isinstance(module, (ResNet, XSlot, SlotModel)):
            marks[type(module).__name__ + "_out"] = _event()

    backward = slot_kernel._XSlotFused.backward

    def timed_backward(ctx, *grads):
        start = _event()
        out = backward(ctx, *grads)
        bwd.append((start, _event()))
        return out

    opt = state.optimizer
    hooks = [torch.nn.modules.module.register_module_forward_pre_hook(pre),
             torch.nn.modules.module.register_module_forward_hook(post),
             opt.register_step_pre_hook(lambda *a: marks.__setitem__("opt_in", _event())),
             opt.register_step_post_hook(lambda *a: marks.__setitem__("opt_out", _event()))]
    slot_kernel._XSlotFused.backward = staticmethod(timed_backward)
    order = ("SlotModel_in", "ResNet_in", "ResNet_out", "XSlot_in", "XSlot_out",
             "SlotModel_out", "opt_in", "opt_out")
    names = ("stem_to_backbone", "backbone", "head", "xslot", "xslot_to_logits",
             "loss_and_backward", "adamw")
    sums = dict.fromkeys(names + ("xslot_bwd",), 0.0)
    try:
        for _ in range(iters):
            marks.clear()
            bwd.clear()
            step(state, batch)
            torch.cuda.synchronize()
            for name, a, b in zip(names, order, order[1:]):
                sums[name] += marks[a].elapsed_time(marks[b])
            sums["xslot_bwd"] += sum(s.elapsed_time(e) for s, e in bwd)
    finally:
        slot_kernel._XSlotFused.backward = staticmethod(backward)
        for h in hooks:
            h.remove()
    return {k: v / iters for k, v in sums.items()}


def step_ms(step, state, batch, iters):
    import time

    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step(state, batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def bn_route_ms(step, state, batch, iters):
    """ms per train step with the port's BatchNorm and with the stock one."""
    from torch import nn

    from scouter_tpu_torch.models import layers

    port_forward = layers.BatchNorm2d.forward
    times = {"port": [], "stock": []}
    try:
        for route in ("port", "stock", "stock", "port"):
            layers.BatchNorm2d.forward = (port_forward if route == "port"
                                          else nn.BatchNorm2d.forward)
            times[route].append(step_ms(step, state, batch, iters))
    finally:
        layers.BatchNorm2d.forward = port_forward
    return times


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", choices=("flagship", "cub"), default="flagship")
    p.add_argument("--model", default=None, help="backbone (default: the config's)")
    p.add_argument("--batch", type=int, default=None, help="default: the config's")
    p.add_argument("--compute_dtype", choices=("float32", "bfloat16"), default=None,
                   help="default: the config's")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from chip_smoke import CUB, FLAGSHIP
    from scouter_tpu_torch.core import ScouterConfig
    from scouter_tpu_torch.core.config import compute_dtype
    from scouter_tpu_torch.data import _synthetic_folder, preprocess_batch
    from scouter_tpu_torch.models import build_slot_model
    from scouter_tpu_torch.ops import slot_kernel
    from scouter_tpu_torch.train import create_train_state, make_train_step
    from torch_profile_serve import profile_kernels

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cfg = ScouterConfig(**(CUB if args.config == "cub" else FLAGSHIP))
    cfg = cfg.replace(model=args.model or cfg.model, batch_size=args.batch or cfg.batch_size,
                      compute_dtype=args.compute_dtype or cfg.compute_dtype)
    args.batch = cfg.batch_size
    ds = _synthetic_folder(cfg.dataset, cfg.num_classes, cfg.img_size, train=True)
    images = preprocess_batch(torch.from_numpy(ds.images[:args.batch]).cuda(),
                              dataset=cfg.dataset, img_size=cfg.img_size)
    batch = {"image": images.permute(0, 3, 1, 2).contiguous(),
             "label": torch.from_numpy(ds.labels[:args.batch]).long().cuda()}
    state = create_train_state(build_slot_model(cfg, fused_slot=True, device="cuda",
                                                compute_dtype=compute_dtype(cfg)), cfg.lr)
    step = make_train_step(cfg.lambda_value)
    for _ in range(3):
        step(state, batch)
    torch.cuda.synchronize()
    fused = slot_kernel.xslot_iterations_fused
    fused.launches = fused.hist_launches = 0
    record = {"card": card, "config": args.config, "model": cfg.model, "batch": args.batch,
              "dtype": cfg.compute_dtype,
              "stages_ms": stage_times(step, state, batch, args.iters)}
    record.update(profile_kernels(lambda b: step(state, b), batch, args.iters))
    record["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    record["xslot_fwd_hist_launches_per_step"] = fused.hist_launches / (2 * args.iters)
    record["bn_route_ms"] = bn_route_ms(step, state, batch, args.iters)
    line = json.dumps(record)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
