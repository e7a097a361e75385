"""ctypes bindings for the port's host staging library, ``csrc/stager.cpp``
(counterpart of ``scouter_tpu/data/native_stager.py``).

The library is built with g++ at first use into the git-ignored
``build/kernels/``, under a name that carries the hash of the source and of
the flags, as ``ops/cuda_build.py`` names the CUDA libraries. The flags are
the JAX package's (``-O3 -march=native``): the compiler's fused multiply-adds
are part of the resize's arithmetic, so the same flags give the same bits.
Where no compiler is found, the first call raises: there is no numpy
fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Tuple

import numpy as np

from ..ops.cuda_build import BUILD_DIR, CSRC

__all__ = ["gather_items", "png_unfilter", "resize_batch"]

GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None


def _threads(nthreads: int) -> int:
    return nthreads or min(os.cpu_count() or 1, 16)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        src = CSRC / "stager.cpp"
        digest = hashlib.sha256(src.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()
        out = BUILD_DIR / f"libstager-{digest[:16]}.so"
        if not out.exists():
            gxx = os.environ.get("CXX") or shutil.which("g++")
            if gxx is None:
                raise RuntimeError("g++ not found: set CXX or put g++ on PATH to build the "
                                   "port's host stager (csrc/stager.cpp)")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(src), "-lpthread"],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed for stager.cpp (exit {proc.returncode}):\n"
                                   f"{proc.stderr}")
            os.replace(tmp, out)  # atomic: concurrent builds of one source agree
        lib = ctypes.CDLL(str(out))
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.resize_batch_u8.argtypes = [p, i, i, i, i, p, i, i, i]
        lib.resize_batch_u8.restype = None
        lib.gather_items_u8.argtypes = [p, p, i, i64, p, i]
        lib.gather_items_u8.restype = None
        lib.png_unfilter.argtypes = [p, i, i64, i, p]
        lib.png_unfilter.restype = i
        _lib = lib
        return lib


def resize_batch(images: np.ndarray, size: Tuple[int, int], nthreads: int = 0) -> np.ndarray:
    """Batched bilinear uint8 resize (half-pixel centers) of (N, H, W, C)
    images to ``size`` = (height, width). Raises on non-uint8 input: a uint8
    cast would truncate normalised float images to black."""
    images = np.asarray(images)
    if images.dtype != np.uint8:
        raise TypeError(f"resize_batch expects uint8 pixels, got {images.dtype}")
    images = np.ascontiguousarray(images)
    n, h, w, c = images.shape
    oh, ow = size
    if (h, w) == (oh, ow):
        return images
    out = np.empty((n, oh, ow, c), np.uint8)
    _load().resize_batch_u8(images.ctypes.data, n, h, w, c, out.ctypes.data, oh, ow,
                            _threads(nthreads))
    return out


def gather_items(items: np.ndarray, indices, nthreads: int = 0) -> np.ndarray:
    """``items[indices]`` for a uint8 store, copied by host threads (the
    Loader's batch assembly). Indices are checked before the copy, which
    would otherwise read out of bounds."""
    items = np.ascontiguousarray(items)
    if items.dtype != np.uint8:
        raise TypeError(f"gather_items expects a uint8 store, got {items.dtype}")
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    if len(indices) and (indices.min() < 0 or indices.max() >= len(items)):
        raise IndexError(f"gather_items: indices out of range [0, {len(items)}): "
                         f"min={indices.min()}, max={indices.max()}")
    out = np.empty((len(indices),) + items.shape[1:], np.uint8)
    item_bytes = int(np.prod(items.shape[1:], dtype=np.int64))
    if len(indices) and item_bytes:
        _load().gather_items_u8(items.ctypes.data, indices.ctypes.data, len(indices),
                                item_bytes, out.ctypes.data, _threads(nthreads))
    return out


def png_unfilter(raw: np.ndarray, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    """Undo PNG's per-row filters: ``raw`` holds ``height`` rows of a filter
    byte and ``rowbytes`` filtered bytes; ``bpp`` is the bytes of one whole
    pixel (1 for depths under 8). Returns (height, rowbytes) uint8; raises
    ``ValueError`` for a filter type other than 0-4."""
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    if raw.size != height * (rowbytes + 1):
        raise ValueError(f"PNG image data holds {raw.size} bytes, expected "
                         f"{height * (rowbytes + 1)} for {height} rows of {rowbytes}")
    out = np.empty((height, rowbytes), np.uint8)
    bad = _load().png_unfilter(raw.ctypes.data, height, rowbytes, bpp, out.ctypes.data)
    if bad:
        raise ValueError(f"PNG row {bad - 1} has filter type {raw[(bad - 1) * (rowbytes + 1)]}, "
                         "not one of 0-4")
    return out
