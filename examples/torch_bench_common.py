"""What the port's measuring and recipe scripts (``examples/torch_*.py``)
share: the device they run on, the card's name and power limit, the
published peaks that utilisation is stated against, percentiles, the
engine's bucket fill, and where results go.

Imports nothing of JAX. Every script runs on the card unless given
``--device cpu``, and fails without a card otherwise. A CPU run reports no
device metric: its achieved TFLOP/s and ``mfu`` are null.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import Dict, Iterable, Optional

ROOT = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
BUILD = os.path.join(ROOT, "build")  # git-ignored: the scripts' default outputs

# Published dense peaks of an H100 SXM (NVIDIA's data sheet), by
# compute dtype: f32 outside the tensor
# cores (TF32 stays off), bf16 and int8 in them. They assume the 700 W limit.
H100_SXM = "NVIDIA H100 80GB HBM3"
PEAK_FLOPS = {H100_SXM: {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}}


def add_device_arg(parser) -> None:
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda (default: fails without a card) or cpu")


def setup(device: str):
    """The torch device to run on, TF32 off. Prints the card's name and power
    limit first (nvidia-smi's line); exits non-zero where ``cuda`` is asked
    for and torch sees no card. Returns (device, card line or None)."""
    import torch

    if device == "cpu":
        print("device: cpu (no device metric is measured)", flush=True)
        return torch.device("cpu"), None
    if not torch.cuda.is_available():
        print("torch sees no CUDA device; pass --device cpu for a CPU run", file=sys.stderr)
        raise SystemExit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    return torch.device("cuda"), card


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def card_kind(device) -> Optional[str]:
    import torch

    return torch.cuda.get_device_name(0) if torch.device(device).type == "cuda" else None


def utilisation(flops_per_call: float, calls: int, seconds: float, kind: Optional[str],
                dtype: str) -> Dict[str, object]:
    """Achieved TFLOP/s (the FLOPs of one call x calls / seconds) and ``mfu``
    against the published dense peak of ``kind`` for ``dtype``. On the CPU
    (``kind`` None) both are null; for a card whose peaks are not known,
    ``mfu`` is null and ``mfu_basis`` says why."""
    if kind is None:
        return {"achieved_tflops": None, "mfu": None,
                "mfu_basis": "not measured: a CPU run has no device metric"}
    achieved = flops_per_call * calls / seconds
    peak = PEAK_FLOPS.get(kind, {}).get(dtype)
    if peak is None:
        return {"achieved_tflops": achieved / 1e12, "mfu": None,
                "mfu_basis": f"no published {dtype} peak known for {kind!r}"}
    return {"achieved_tflops": achieved / 1e12, "mfu": achieved / peak,
            "mfu_basis": f"{dtype} dense peak {peak / 1e12:g} TFLOP/s of {kind} at 700 W"}


def percentiles(values: Iterable[float], qs=(50, 90, 99)) -> Dict[str, float]:
    """{"p50": ..., ...} by linear interpolation (numpy's default); empty
    for no values."""
    import numpy as np

    vals = np.asarray(list(values), np.float64)
    if not vals.size:
        return {}
    return {f"p{q}": float(np.percentile(vals, q)) for q in qs}


def fill_delta(pre: Dict[str, int], post: Dict[str, int]) -> Dict[str, int]:
    """The engine's ``stats()["bucket_fill"]`` counts added between two
    reads ("b/n": a device batch of bucket b carrying n live requests), in
    order of b then n, zero counts dropped."""
    keys = sorted(post, key=lambda k: [int(x) for x in k.split("/")])
    delta = {k: post[k] - pre.get(k, 0) for k in keys}
    return {k: v for k, v in delta.items() if v}


def emit(record: Dict, out: Optional[str]) -> None:
    """Print ``record`` as one JSON line and append it to ``out``."""
    line = json.dumps(record)
    print(line, flush=True)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "a") as f:
            f.write(line + "\n")


def flagship(**overrides):
    """The flagship config of ``chip_smoke.py`` (resnest26d + xSlot, 10 x 3
    slots, 224 px, batch 70) with ``overrides``."""
    from chip_smoke import FLAGSHIP
    from scouter_tpu_torch.core import ScouterConfig

    return ScouterConfig(**FLAGSHIP).replace(**overrides)
