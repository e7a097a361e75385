"""Where the time of the PyTorch port's flagship serving call goes, on one GPU.

    python examples/torch_profile_serve.py [--model NAME] [--batch 70] [--iters 20]
        [--out FILE]

Builds the flagship resnest26d + xSlot (seeded random weights, the config of
``chip_smoke.py``; ``--model`` swaps in another registered backbone) and runs
``make_serving_fn`` at one batch with an f32 and a bf16 backbone. For each
it reports, as one JSON line:

- ``stages_ms``: device time per call of preprocess, backbone, head
  (conv1x1 + ReLU + position embedding), xSlot (to_k, the xSlot kernel and
  the pooling) and the rest (logits cast and slot-map render), from CUDA
  events recorded at the module boundaries by global forward hooks;
- ``by_kind_ms`` and ``top_kernels``: device time per call of each kernel
  under ``torch.profiler``, summed by kind;
- ``idle_share``: 1 - (device busy time / wall time) over the profiled calls.

Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

KINDS = (  # first match wins; names are lower-cased kernel names
    ("xslot kernel", ("xslot",)),
    ("conv/gemm", ("conv", "cudnn", "xmma", "gemm", "cutlass", "implicit")),
    ("batch norm", ("batch_norm", "bn_")),
    ("pool", ("pool",)),
    ("reduce/softmax", ("reduce", "softmax")),
    ("copy", ("memcpy", "memset", "copy")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def stage_times(fn, images, iters):
    """Mean device ms per stage, from CUDA events at the module boundaries."""
    import torch

    from scouter_tpu_torch.models import ResNet, XSlot

    marks = {}

    def pre(module, args):
        if isinstance(module, (ResNet, XSlot)):
            marks[type(module).__name__ + "_in"] = _event()

    def post(module, args, out):
        if isinstance(module, (ResNet, XSlot)):
            marks[type(module).__name__ + "_out"] = _event()

    hooks = [torch.nn.modules.module.register_module_forward_pre_hook(pre),
             torch.nn.modules.module.register_module_forward_hook(post)]
    order = ("start", "ResNet_in", "ResNet_out", "XSlot_in", "XSlot_out", "end")
    names = ("preprocess", "backbone", "head", "xslot", "render")
    sums = dict.fromkeys(names, 0.0)
    try:
        for _ in range(iters):
            marks.clear()
            marks["start"] = _event()
            fn(images)
            marks["end"] = _event()
            torch.cuda.synchronize()
            for name, a, b in zip(names, order, order[1:]):
                sums[name] += marks[a].elapsed_time(marks[b])
    finally:
        for h in hooks:
            h.remove()
    return {k: v / iters for k, v in sums.items()}


def _event():
    import torch

    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def profile_kernels(fn, images, iters):
    """Per-kernel device ms per call under torch.profiler, and the idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(images)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        kernels.append((ev.key, us / 1e3 / iters, ev.count // iters))
    kernels.sort(key=lambda k: -k[1])
    busy = sum(k[1] for k in kernels) * iters
    by_kind = {}
    for name, ms, _ in kernels:
        by_kind[kind_of(name)] = by_kind.get(kind_of(name), 0.0) + ms
    return {
        "device_events": len(kernels),
        "wall_ms_per_call": wall_ms / iters,
        "device_busy_ms_per_call": busy / iters,
        "idle_share": (1.0 - busy / wall_ms) if kernels else None,
        "by_kind_ms": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": n[:120], "ms": ms, "launches_per_call": c}
                        for n, ms, c in kernels[:15]],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default=None, help="backbone (default: the flagship's)")
    p.add_argument("--batch", type=int, default=70)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--out", default=None, help="also write the JSON lines to this file")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from chip_smoke import FLAGSHIP
    from scouter_tpu_torch.core import ScouterConfig
    from scouter_tpu_torch.models import build_slot_model
    from scouter_tpu_torch.serve import make_serving_fn

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cfg = ScouterConfig(**FLAGSHIP)
    cfg = cfg.replace(model=args.model or cfg.model)
    state_dict = build_slot_model(cfg, device="cpu").state_dict()
    images = torch.from_numpy(np.random.RandomState(3).randint(
        0, 256, (args.batch, cfg.img_size, cfg.img_size, 3), np.uint8)).cuda()
    lines = []
    for name, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        fn = make_serving_fn(cfg, state_dict, compute_dtype=dtype, device="cuda")
        for _ in range(3):
            fn(images)
        torch.cuda.synchronize()
        record = {"card": card, "model": cfg.model, "batch": args.batch,
                  "backbone_dtype": name,
                  "stages_ms": stage_times(fn, images, args.iters)}
        record.update(profile_kernels(fn, images, args.iters))
        lines.append(json.dumps(record))
        print(lines[-1], flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
