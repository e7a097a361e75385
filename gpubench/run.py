"""Run one cell of the benchmark once.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The run makes its inputs and weights from the
seed, builds the program (``scouter_tpu_torch``) on the card, warms the
cell's shapes, measures for ``--seconds`` (with ``--trace 1`` a traced
window of at most the traffic's ``trace_seconds``), checks what the timed
path produced against the plain reference (``gpubench/reference/``), and
prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer metrics, read by ``gpubench/metrics/<name>.py``),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
compared number beside its limit, which also end standard error.

It exits non-zero and prints no result where torch sees no card or fewer
cards than the cell asks for, and where JAX or the JAX package was loaded
into the process. Build and kernel caches stay under ``build/`` in the
checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import functools  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
BUILD = os.path.join(ROOT, "build")
# fixed cache directories inside the checkout, so only a checkout's first run
# builds; no library the port uses may load JAX
os.environ["TRITON_CACHE_DIR"] = os.path.join(BUILD, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(BUILD, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(BUILD, "cuda_cache")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "scouter_tpu")


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that are JAX's or the JAX
    package's, compared whole (``scouter_tpu_torch`` is not ``scouter_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _reader(name: str):
    path = os.path.join(ROOT, "gpubench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"gpubench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def _card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"gpubench: no workload {args.workload!r}", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"gpubench: {args.workload} needs {cell['chips']} CUDA device(s); torch sees "
              f"{have}", file=sys.stderr)
        return 2
    return run_cell(bench, cell, args, torch.device("cuda", 0))


def run_cell(bench: dict, cell: dict, args, device, t_start: float = T_START,
             params: dict = None) -> int:
    """Run the cell on ``device`` and print its result; the exit code.
    ``params`` override the cell's traffic parameters (the CPU tests' small
    runs)."""
    import torch

    from gpubench import harness
    from gpubench.compare import held
    from gpubench.layers import Reading
    from gpubench.work.model_flops import step_flops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = harness.load_ctx(bench, cell["name"], args.seed, args.seconds, bool(args.trace), device,
                           t_start)
    ctx.params.update(params or {})
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    ctx.peaks = harness.load_json(ROOT, "gpubench", "peaks.json").get(kind)
    if device.type == "cuda":
        print(f"gpubench: card {_card_line()}", file=sys.stderr)
    loop = importlib.import_module(f"gpubench.loops.{ctx.params['loop']}")
    out = loop.run(ctx)

    found = forbidden_modules()
    if found:
        print(f"gpubench: the process loaded {found}: the benchmark runs the PyTorch port "
              "alone", file=sys.stderr)
        return 3

    e2e_names = {m["name"] for m in bench["end_to_end"]
                 if "workloads" not in m or cell["name"] in m["workloads"]}
    metrics = {}
    if not args.trace:
        for m in bench["end_to_end"]:
            if m["name"] in e2e_names:
                metrics[m["name"]] = {"value": out.e2e[m["name"]], "unit": m["unit"]}
    else:
        flops = functools.lru_cache(maxsize=None)(
            lambda batch, train: step_flops(ctx.config, batch, train))
        reading = Reading(ctx, out, ctx.peaks, flops)
        for m in bench["per_layer"]:
            if _applies(m, cell["name"], e2e_names):
                value = _reader(m["name"])(reading)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = held(out.numbers, ctx.params.get("limits", {}))
    if out.answers_missing:
        checks["answers_missing"] = {"value": out.answers_missing, "limit": 0, "ok": False}
    correct = all(c["ok"] for c in checks.values())
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
                   "count": int(cell["chips"]), "memory_peak_bytes": out.memory_peak_bytes}
    line = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": device_info}
    if args.trace and out.trace is not None:
        device_info["busy_s"] = out.trace.busy_s()
        device_info["window_s"] = out.trace.window_s
        line["breakdown"] = out.trace.breakdown()
    line["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r} {'ok' if c['ok'] else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
