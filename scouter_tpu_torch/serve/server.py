"""Minimal HTTP inference server over the micro-batching engine
(counterpart of ``scouter_tpu/serve/server.py``).

Standard library only (ThreadingHTTPServer): concurrent requests land in the
InferenceEngine's queue and coalesce into bucketed batches.

Endpoints:
- ``POST /predict``: body = a raw ``.npy`` uint8 (H, W, C) array, or PNG or
  JPEG bytes, decoded on the engine's device (``data/_decode.py``: PNG by
  ``core/png.py``, JPEG by nvJPEG on the card and by Pillow on the CPU) and
  resized there with Pillow's bilinear, bit for bit.
  Response JSON: ``{"pred": int, "logits": [...]}``; add ``?maps=1`` for the
  per-class slot maps (base64 grayscale PNG each).
- ``GET /healthz``: engine stats (requests, batches, padding).

CLI: ``python -m scouter_tpu_torch.serve.server --device cuda --port 8000
<model flags ...>`` serves ``{output_dir}/{checkpoint_name}.pth`` when it
exists, fresh-init weights otherwise.
"""

from __future__ import annotations

import base64
import io
import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Tuple

import numpy as np

from ..core.png import encode_png

__all__ = ["main", "make_server"]


def _decode_image(body: bytes, img_size: int, channels: int, device="cpu") -> np.ndarray:
    """The request's (img_size, img_size, channels) uint8 pixels: a ``.npy``
    body as it is, a PNG or JPEG body as Pillow's ``convert("L" or "RGB")``
    then ``resize((img_size, img_size), BILINEAR)``, computed on ``device``."""
    if body[:6] == b"\x93NUMPY":  # .npy magic
        arr = np.load(io.BytesIO(body), allow_pickle=False)
        if arr.dtype != np.uint8:
            raise ValueError(f"npy payload must be uint8, got {arr.dtype}")
    else:
        from ..data._decode import decode_image, stage

        pixels = stage(decode_image(body, device, "L" if channels == 1 else "RGB"), img_size)
        arr = pixels.cpu().numpy()
        if channels == 1:
            arr = arr[..., None]
    if arr.shape != (img_size, img_size, channels):
        raise ValueError(f"expected ({img_size},{img_size},{channels}), got {arr.shape}")
    return arr


def make_server(engine, img_size: int, channels: int,
                address: Tuple[str, int] = ("127.0.0.1", 8000)) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server bound to ``address``; port 0 picks a
    free port (``server.server_address`` reports the real one). Image bodies
    are decoded on the engine's device."""

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            blob = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def do_GET(self):
            if self.path.startswith("/healthz"):
                self._send(200, {"status": "ok", "stats": engine.stats()})
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if not self.path.startswith("/predict"):
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                body = self.rfile.read(int(self.headers.get("Content-Length", "0")))
                image = _decode_image(body, img_size, channels, engine.device)
                out = engine.submit(image).result(timeout=60)
                logits = np.asarray(out["logits"], np.float32)
                payload = {"pred": int(logits.argmax()), "logits": [float(v) for v in logits]}
                if "maps=1" in self.path and "slot_maps" in out:
                    payload["slot_maps_png"] = [
                        base64.b64encode(encode_png(np.asarray(m, np.uint8), 1)).decode("ascii")
                        for m in out["slot_maps"]]
            except Exception as exc:  # per-request isolation
                self._send(400, {"error": f"{type(exc).__name__}: {exc}"})
                return
            self._send(200, payload)

        def log_message(self, *args):  # quiet access log
            pass

    return ThreadingHTTPServer(address, Handler)


def load_state_dict(cfg):
    """The weights ``main`` serves, on the CPU: ``{output_dir}/{checkpoint_name}.pth``
    (the port's or the reference's format; the bypassed ``slot.to_q.*`` is
    dropped) when it exists, else a fresh init from ``cfg.seed``, restored
    through ``train.state.restore_inference_state`` as the explain CLI
    restores. Returns (state_dict, source path or None)."""
    from ..train.state import restore_inference_state

    model, _, path = restore_inference_state(cfg, device="cpu")
    return model.state_dict(), path


def main(argv=None):
    import argparse

    import torch

    from ..core.config import check_serving_supported, config_from_args, get_args_parser
    from .engine import InferenceEngine

    parser = argparse.ArgumentParser(
        "SCOUTER inference server (PyTorch/CUDA)", parents=[get_args_parser()])
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--buckets", default="1,4,16")
    parser.add_argument("--max_wait_ms", type=float, default=2.0)
    parser.add_argument("--max_inflight", type=int, default=8,
                        help="batches dispatched and not yet fetched before the "
                             "dispatcher blocks (pipelining depth)")
    parser.add_argument("--resolvers", type=int, default=4,
                        help="threads doing the device->host fetch")
    ns = parser.parse_args(argv)
    cfg = config_from_args(ns).replace(use_pre=False)
    check_serving_supported(cfg)

    state_dict, source = load_state_dict(cfg)
    print(f"restored {source}" if source else "serving fresh-init weights", flush=True)
    channels = 1 if cfg.dataset == "MNIST" else 3
    buckets = [int(b) for b in ns.buckets.split(",")]
    dtype = {"float32": None, "bfloat16": torch.bfloat16}[cfg.compute_dtype]
    engine = InferenceEngine(cfg, state_dict, buckets=buckets, max_wait_ms=ns.max_wait_ms,
                             compute_dtype=dtype, max_inflight=ns.max_inflight,
                             resolvers=ns.resolvers, device=cfg.device)
    # run every bucket once before accepting traffic (kernel build, cuDNN
    # algorithm selection)
    for b in sorted(buckets):
        t0 = time.monotonic()
        engine.infer_batch(np.zeros((b, cfg.img_size, cfg.img_size, channels), np.uint8))
        print(f"warmed bucket {b} ({time.monotonic() - t0:.2f} s)", flush=True)
    server = make_server(engine, cfg.img_size, channels, (ns.host, ns.port))
    host, port = server.server_address[:2]
    print(f"serving on http://{host}:{port} (POST /predict, GET /healthz)", flush=True)
    try:
        server.serve_forever()
    finally:
        engine.close()


if __name__ == "__main__":
    main()
