"""Find the highest rate the program sustains in an open loop: one engine,
one seeded schedule per rate, each for ``--seconds``; prints, per rate, the
answers that came within the window over the requests due in it, the p50
and p95 latency and the batch fill, as JSON lines.

    python3 gpubench/sweep.py --workload flagship.serve_open --seed 1 --seconds 6 \\
        --rates 600,900,1200

The knee is the highest rate whose answers keep up (no growing backlog: the
answers in the window about equal the requests due, and the p95 stays near
the lower rates'). The cell's ``rate_img_s`` is set, as a number, to four
fifths of it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                 "..")))

from gpubench import harness  # noqa: E402
from gpubench.loops.serve_open import window  # noqa: E402
from gpubench.loops.serving import ServeRun  # noqa: E402


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    ctx = harness.load_ctx(bench, args.workload, args.seed, args.seconds, False,
                           torch.device("cuda", 0), time.perf_counter())
    srv = ServeRun(ctx)
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            ctx.params["rate_img_s"] = rate
            w = window(srv, ctx, args.seconds)
            lat = w["lat"] * 1e3
            print(json.dumps({"rate_img_s": rate, "due": w["n"], "answered_in_window":
                              w["in_time"], "kept_up": w["in_time"] / max(w["n"], 1),
                              "p50_ms": float(np.percentile(lat, 50)),
                              "p95_ms": float(np.percentile(lat, 95)),
                              "batch_fill": w["fill"], "failed": w["failed"]}), flush=True)
    finally:
        srv.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
