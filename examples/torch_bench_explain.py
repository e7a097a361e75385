"""XAI-suite seconds per method of the PyTorch/CUDA port on one card, at the
configurations of ``examples/bench_explain.py``: resnest26d, 260 px, 10
classes, seeded random weights; RISE at 8000 masks for all classes,
extremal perturbation at 800 iterations, Score-CAM, SS-CAM at 35 samples,
IS-CAM at 10, IGOS at 15 x 20, the IBA estimate over 5,000 samples and its
analysis for all classes, the CAM and backprop families and excitation
backprop.

    python examples/torch_bench_explain.py [--compute_dtype bfloat16] [--out FILE]

Each method runs once to warm up (cuDNN's algorithm choice, the allocator),
then once timed on the host clock between two ``torch.cuda.synchronize()``.
Prints the card's name and power limit, then one JSON line per method (also
appended to ``--out``). Every call is eager: the iterative methods launch
their kernels from a Python loop.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--img_size", type=int, default=260)
    ap.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--out", default=None, help="append the JSON lines to this file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("torch sees no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    from scouter_tpu_torch.explain import backprop, cam, excitation
    from scouter_tpu_torch.explain.extremal import extremal_perturbation
    from scouter_tpu_torch.explain.iba import estimate_stats, iba_analyze
    from scouter_tpu_torch.explain.igos import gaussian_blur_baseline, integrated_mask
    from scouter_tpu_torch.explain.rise import rise
    from scouter_tpu_torch.models import create_model, init_weights

    size = args.img_size
    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else None
    model = create_model("resnest26d", num_classes=10, compute_dtype=dtype)
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.eval().cuda()
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 3, size, size)
                         .astype(np.float32)).cuda()

    def emit(name, seconds, detail):
        line = json.dumps({"metric": f"xai/{name}", "value": seconds, "unit": "s",
                           "compute_dtype": args.compute_dtype, "img": size, "card": card,
                           **detail})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    def timed(name, fn, detail, warm=True):
        if warm:
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        emit(name, time.perf_counter() - t0, detail)
        return out

    timed("rise", lambda: rise(model, x, 1), {"masks": 8000, "classes": 10})
    timed("extremal_perturbation", lambda: extremal_perturbation(model, x, 0),
          {"iters": 800, "areas": 1}, warm=False)
    for name, fn in (("cam", cam.cam), ("grad_cam", cam.gradcam),
                     ("grad_cam_pp", cam.gradcampp)):
        timed(name, lambda f=fn: f(model, x, 0), {})
    timed("smooth_grad_cam_pp", lambda: cam.smooth_gradcampp(model, x, 0, 2), {"samples": 4})
    timed("score_cam", lambda: cam.scorecam(model, x, 0),
          {"note": "one masked forward per channel, 32 a batch"})
    timed("ss_cam", lambda: cam.sscam(model, x, 0, 2), {"samples": 35}, warm=False)
    timed("is_cam", lambda: cam.isscam(model, x, 0), {"steps": 10}, warm=False)
    for name, fn in (("gradient", backprop.gradient_saliency),
                     ("deconvnet", backprop.deconvnet),
                     ("guided_backprop", backprop.guided_backprop),
                     ("linear_approx", backprop.linear_approx),
                     ("excitation_backprop", excitation.excitation_backprop),
                     ("contrastive_eb", excitation.contrastive_excitation_backprop)):
        timed(name, lambda f=fn: f(model, x, 0), {})
    blurred = gaussian_blur_baseline(x)
    timed("igos", lambda: integrated_mask(model, x, blurred, 0, 3),
          {"outer_iters": 15, "integ_iter": 20}, warm=False)

    # IBA: the reference's estimate over 5,000 images (torchcam_vis.py:194-204)
    # from one batch of 50 reused, then the analysis of every class
    features, head, _ = cam.backbone_split(model)
    batch = torch.from_numpy(np.random.RandomState(7).randn(50, 3, size, size)
                             .astype(np.float32)).cuda()
    features(batch)
    stats = timed("iba_estimate", lambda: estimate_stats(features, (batch for _ in range(100))),
                  {"samples": 5000, "batch": 50}, warm=False)

    def analyze_all():
        for c in range(10):
            iba_analyze(features,
                        lambda z, c=c: -torch.log_softmax(head(z).float(), dim=1)[:, c].mean(),
                        x, stats, 4)

    timed("iba_analyze_all_classes", analyze_all,
          {"classes": 10, "opt_steps": 10, "noise_batch": 10})


if __name__ == "__main__":
    main()
