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
Prints one JSON line with the card's name and power limit; ``--out`` also
appends it to a file.
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
    line = json.dumps(record)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
