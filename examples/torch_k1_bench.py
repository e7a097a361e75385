"""Time K1 (the fused xSlot loop) of a checkout of the port on one GPU, by
iteration, so two trees can be compared in one run on one card.

    python examples/torch_k1_bench.py [--root DIR] [--out FILE]

``--root`` is the directory holding the ``scouter_tpu_torch`` package to
time (default: this checkout). For B = 1, 4, 16 and 70 at the flagship's
N=49, S=30, d=64 it times the forward (``xslot_iterations_fused`` under
no_grad) at iters = 1, 2 and 3 as the device time of one launch replayed
in a CUDA graph, and at B=70 ``torch.autograd.grad`` through the op
(forward kept; host-bound, so five runs of 50 calls after 300 warm-up
calls, all five and their median). Timers and inputs are chip_smoke.py's.
With ``--tiled`` it times instead the backward's tiled route at the CUB
recipe's (16, 81, 1000) and (64, 81, 1000) and at 448 px's (70, 196, 30)
in a CUDA graph, and splits one call's device time by kernel under
``torch.profiler``, whose events also count the call's launches and give
each launch's device time in order. Prints one JSON line with the card's name and power
limit; ``--out`` also appends it to a file.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(HERE))
    parser.add_argument("--out", default=None)
    parser.add_argument("--tiled", action="store_true")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(HERE))
    from chip_smoke import cuda_ms, graph_ms, xslot_inputs

    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from scouter_tpu_torch.ops import cuda_build, slot_kernel

    cuda_build.build_all()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    if args.tiled:
        record = {"root": args.root, "card": card, **tiled_backward(slot_kernel)}
        return emit(record, args.out)
    fused = slot_kernel.xslot_iterations_fused
    n, s, d = 49, 30, 64
    record = {"root": args.root, "card": card, "forward_device_ms": {}}
    for b in (1, 4, 16, 70):
        x = xslot_inputs(b, n, s, d, "cuda")
        for iters in (1, 2, 3):
            with torch.no_grad():
                record["forward_device_ms"][f"B={b} iters={iters}"] = graph_ms(
                    lambda: fused(*x, iters), reps=50)
    leaves = [a.detach().requires_grad_() for a in xslot_inputs(70, n, s, d, "cuda")]
    upd, attn = fused(*leaves)
    cot = (2 * upd.detach(), torch.ones_like(attn))
    runs = [cuda_ms(lambda: torch.autograd.grad((upd, attn), leaves, cot, retain_graph=True),
                    50, warmup) for warmup in (300, 5, 5, 5, 5)]
    record.update(autograd_bwd_ms=statistics.median(runs), autograd_bwd_ms_runs=runs)
    return emit(record, args.out)


def emit(record, out) -> int:
    line = json.dumps(record)
    print(line, flush=True)
    if out:
        with open(out, "a") as fh:
            fh.write(line + "\n")
    return 0


def tiled_backward(slot_kernel):
    """The backward's tiled route: device ms per call in a CUDA graph at
    each shape, and one call's device time by kernel name (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import graph_ms, xslot_inputs

    out = {"tiled_bwd_device_ms": {}, "tiled_bwd_kernels_ms": {}, "tiled_bwd_launches": {}}
    for b, n, s in ((16, 81, 1000), (64, 81, 1000), (70, 196, 30)):
        args = xslot_inputs(b, n, s, 64, "cuda")
        with torch.no_grad():
            upd, attn, hist = slot_kernel._launch(*args, 3, emit_hist=True)
            res = (args[0], args[1], args[3], args[4], args[5], args[6], hist)
            cot = (2 * upd, torch.ones_like(attn))
            key = f"B={b} N={n} S={s}"
            out["tiled_bwd_device_ms"][key] = graph_ms(
                lambda: slot_kernel._launch_bwd(*res, *cot), reps=10, iters=10)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                slot_kernel._launch_bwd(*res, *cot)
                torch.cuda.synchronize()
        out.setdefault("tiled_bwd_launch_us", {})[key] = [
            [ev.name[:48], round(ev.time_range.elapsed_us(), 2)]
            for ev in sorted(prof.events(), key=lambda e: e.time_range.start)
            if ev.device_type == torch.autograd.DeviceType.CUDA]
        kernels = {}
        for ev in prof.key_averages():
            ms = getattr(ev, "device_time_total", getattr(ev, "cuda_time_total", 0)) / 1e3
            if ms > 0:
                kernels[ev.key[:60]] = [ev.count, ms]
        out["tiled_bwd_kernels_ms"][key] = dict(
            sorted(kernels.items(), key=lambda kv: -kv[1][1]))
        out["tiled_bwd_launches"][key] = sum(count for count, _ in kernels.values())
    return out


if __name__ == "__main__":
    sys.exit(main())
