"""Readings for the limits of the comparison that decides ``correct``, at the
cell's own size, in one process:

- ``program``: the timed path's numbers on each of ``--seeds`` (training:
  the first three steps of the train step and its Loader; serving: a
  ``--seconds`` window at the cell's load);
- ``control``: the reference put in the program's place one precision step
  below the configuration's (TF32 for f32 with TF32 off, fp8 for bf16;
  ``reference/precision.py``), on each of ``--control-seeds``;
- training only, ``half_batch``: the reference with half of each batch
  left out and the mean taken over the rest, on the same seeds. A state
  left unchanged reads 1 on ``change_median_gap`` and needs no run.

Prints one JSON line per reading. The benchmark's own runs never run this.

    python3 gpubench/control.py --workload flagship.train --seeds 1,2,3 \\
        --control-seeds 1,2,3
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                 "..")))

from gpubench import harness  # noqa: E402
from gpubench.compare import serve_numbers, train_numbers  # noqa: E402
from gpubench.reference.precision import by_name  # noqa: E402

# the precision one step below each configuration dtype
CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def readings(ctx, kind: str) -> dict:
    """The numbers of one reading of ``kind`` on ``ctx``'s seed."""
    import importlib

    loop = ctx.params["loop"]
    if loop == "train":
        from gpubench.loops import train as T

        if kind == "program":
            prog = T.TrainRun(ctx)
            got = prog.first_steps()
            prog.close()
            return train_numbers(got, T.reference_readings(ctx))
        exact = T.reference_readings(ctx)
        if kind == "control":
            low = T.reference_readings(ctx, by_name(CONTROL[ctx.config["compute_dtype"]]))
        else:
            low = T.reference_readings(ctx, half_batch=True)
        return train_numbers(low, exact)
    if kind == "program":
        return importlib.import_module(f"gpubench.loops.{loop}").run(ctx).numbers
    from gpubench.loops.serving import reference_answers

    images = harness.seeded_images(ctx, int(ctx.params["sample"]), stream=4)
    low = reference_answers(ctx, images, by_name(CONTROL[ctx.config["compute_dtype"]]))
    return serve_numbers(low, reference_answers(ctx, images))


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    plan = [("program", s) for s in args.seeds.split(",") if s]
    for s in (s for s in args.control_seeds.split(",") if s):
        plan.append(("control", s))
    ctx0 = harness.load_ctx(bench, args.workload, 0, args.seconds, False,
                            torch.device(args.device), time.perf_counter())
    if ctx0.params["loop"] == "train":
        plan += [("half_batch", s) for k, s in list(plan) if k == "control"]
    for kind, seed in plan:
        ctx = harness.load_ctx(bench, args.workload, int(seed), args.seconds, False,
                               torch.device(args.device), time.perf_counter())
        t0 = time.perf_counter()
        numbers = readings(ctx, kind)
        print(json.dumps({"workload": args.workload, "kind": kind, "seed": int(seed),
                          "numbers": numbers, "s": time.perf_counter() - t0}), flush=True)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
