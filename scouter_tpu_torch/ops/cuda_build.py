"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds). Libraries go
to ``build/kernels/`` beside the package, a git-ignored directory, under a name
that carries the hash of the source, of the ``csrc/*.cuh`` headers it
includes and of the flags: an edited source or header is rebuilt at its next
use, an unchanged one is loaded as it is.

Nothing here runs at import time. ``load(name)`` builds on first use;
``build_all()`` starts one nvcc per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

__all__ = ["SOURCES", "build_all", "load"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("xslot_fwd", "xslot_bwd", "render_heatmaps")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build the port's CUDA kernels")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = sorted(set(re.findall(rb'#include "([\w.]+\.cuh)"', src)))
    content = src + b"".join((CSRC / h.decode()).read_bytes() for h in headers)
    digest = hashlib.sha256(content + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Sequence[str] = SOURCES) -> None:
    """Compile every listed source that is not built yet, all nvcc at once."""
    with _lock:
        started = []
        for name in names:
            out = _lib_path(name)
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            started.append((name, proc, tmp, out))
        for name, proc, tmp, out in started:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            os.replace(tmp, out)  # atomic: concurrent builds of one source agree


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``'s library, built if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(_lib_path(name)))
        return _loaded[name]
