"""Serving export CLI (counterpart of ``scouter_tpu/serve/cli.py``).

``python -m scouter_tpu_torch.serve.cli --dataset MNIST --model resnet18 ... \\
      --export_path model.pt2 [--serve_batch dynamic|N] [--platforms cuda|cpu|cuda,cpu] \\
      [--serve_dtype float32|bfloat16]``

Restores the config-derived checkpoint (as the explain CLI and the server
do), exports the whole serving function (uint8 image -> logits + slot maps)
as a ``torch.export`` artifact for the device kinds ``--platforms`` names
(else ``--device``'s; ``cuda,cpu`` writes one program for each), writes it,
loads each program back on its kind and checks it: the loaded artifact's
logits on a probe batch must match the live serving function's (rtol/atol
2e-5 in f32, 3e-2 in bf16, as scouter_tpu/serve/cli.py:75-82) before the CLI
reports success.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..core.config import config_from_args, get_args_parser
from .export import (_platforms, artifact_platforms, export_serving, load_artifact,
                     make_serving_fn, save_artifact)

__all__ = ["main"]


def main(argv=None):
    import torch

    parser = argparse.ArgumentParser(
        "SCOUTER serving export (PyTorch/CUDA)", parents=[get_args_parser()])
    parser.add_argument("--export_path", default="saved_model/serving.pt2")
    parser.add_argument("--serve_batch", default="dynamic",
                        help="'dynamic' (a batch dimension of any size) or an int")
    parser.add_argument("--platforms", default=None,
                        help="the device kinds of the artifact, cuda, cpu or cuda,cpu "
                             "(one program each); default: --device")
    parser.add_argument("--serve_dtype", default=None, choices=[None, "float32", "bfloat16"],
                        help="compute dtype baked into the artifact")
    ns = parser.parse_args(argv)
    cfg = config_from_args(ns).replace(use_pre=False)
    kinds = _platforms(ns.platforms.split(",") if ns.platforms else None, cfg.device)
    device = kinds[0]

    from ..train.state import restore_inference_state

    channels = 1 if cfg.dataset == "MNIST" else 3
    model, _, restored = restore_inference_state(cfg, device=device)
    if restored:
        print(f"restored {restored}")
    else:
        print("no checkpoint found for this config; exporting fresh-init weights")
    state_dict = model.state_dict()
    del model

    batch = None if ns.serve_batch == "dynamic" else int(ns.serve_batch)
    dtype = {None: None, "float32": None, "bfloat16": torch.bfloat16}[ns.serve_dtype]
    exported = export_serving(cfg, state_dict, batch=batch, platforms=kinds, compute_dtype=dtype,
                              device=device)
    os.makedirs(os.path.dirname(os.path.abspath(ns.export_path)), exist_ok=True)
    size = save_artifact(exported, ns.export_path)
    print(f"wrote {ns.export_path} ({size / 1e6:.1f} MB, "
          f"platforms={list(artifact_platforms(ns.export_path))}, batch="
          f"{'dynamic' if batch is None else batch})")

    # round trip: the loaded artifact's logits against the live function's;
    # bf16 programs round their intermediates differently between builds
    probe_n = 2 if batch is None else batch
    rng = np.random.RandomState(0)
    probe = rng.randint(0, 256, (probe_n, cfg.img_size, cfg.img_size, channels),
                        dtype=np.uint8)
    tol = dict(rtol=3e-2, atol=3e-2) if dtype == torch.bfloat16 else dict(rtol=2e-5, atol=2e-5)
    deltas = []
    for kind in kinds:
        live = make_serving_fn(cfg, state_dict, compute_dtype=dtype, device=kind)
        want = live(probe)["logits"].cpu().numpy()
        got = load_artifact(ns.export_path, device=kind)(probe)["logits"].cpu().numpy()
        np.testing.assert_allclose(got, want, **tol)
        deltas.append(f"{kind} {np.abs(got - want).max():.2e}")
    print(f"round-trip verified: artifact logits match live model "
          f"(max |delta| {', '.join(deltas)})")


if __name__ == "__main__":
    main()
