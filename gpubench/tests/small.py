"""Small configurations and a driver for the CPU tests: the harness end to
end at a size the CPU holds, with the program's plain kernel versions."""

import contextlib
import io
import json
import os
import time
import types

import torch

from gpubench import harness

TRAIN = {"model": "resnest14d", "dataset": "ImageNet", "num_classes": 3, "slots_per_class": 2,
         "hidden_dim": 64, "channel": 2048, "img_size": 96, "batch_size": 8,
         "lambda_value": 1.0, "power": 2, "loss_status": 1, "to_k_layer": 3, "iters": 3,
         "lr": 1e-4, "compute_dtype": "float32", "reduced": []}
# SCOUTER's CUB-200 model (ResNeSt-50d + xSlot, 200 classes x 5 slots, 260 px),
# for the reference's spec and operation counts at a second depth
CUB200 = dict(TRAIN, model="resnest50d", dataset="CUB200", num_classes=200, slots_per_class=5,
              img_size=260, batch_size=64, lambda_value=10.0)
SMALL = {"dataset_batches": 3, "warm_steps": 1, "rate_img_s": 20, "lead_s": 0.3, "pool": 16,
         "sample": 8, "grace_s": 30}


def bench_with(tmp_path, config=None, dtype="float32"):
    """BENCHMARK.json with a ``small`` configuration and one cell of each
    traffic mix on it."""
    cfg = dict(config or TRAIN, compute_dtype=dtype)
    path = os.path.join(str(tmp_path), "small.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    bench["configs"].append({"name": "small", "source": "-", "file": path, "reduced": [],
                             "why": "-"})
    like = {"train_loop": "flagship.train", "serve_open": "flagship.serve_open"}
    for t, cell in like.items():
        bench["workloads"].append({"name": f"small.{t}", "config": "small", "traffic": t,
                                   "chips": 1, "why": "-"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if cell in m.get("workloads", ()):
                m["workloads"].append(f"small.{t}")
    return bench


def run_small(bench, traffic, limits, seed=3, trace=0, seconds=1.0):
    """Run ``small.<traffic>`` on the CPU through the harness; the result's
    JSON line."""
    from gpubench import run as R

    cell = next(w for w in bench["workloads"] if w["name"] == f"small.{traffic}")
    args = types.SimpleNamespace(workload=cell["name"], seed=seed, seconds=seconds, trace=trace)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = R.run_cell(bench, cell, args, torch.device("cpu"), time.perf_counter(),
                        params=dict(SMALL, limits=limits))
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1])
