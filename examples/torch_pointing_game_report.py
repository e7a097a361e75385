"""The pointing game end to end on the PyTorch port: a synthetic VOC-like
task, a briefly trained caffe model, saliency methods, the benchmark and
its store.

    python examples/torch_pointing_game_report.py [--arch resnet50]
        [--train_steps 300] [--n_eval 50] [--rise_masks 2000] [--methods a,b]
        [--out FILE] [--store FILE]

Counterpart of the JAX package's ``examples/pointing_game_report.py``.
Twenty classes; each image is noise plus one coloured blob at a random
place, its colour the class and its disc the ground-truth mask, so a
trained model has to localise the evidence. The caffe-structure model of
``explain/benchmark_models.py`` (random init from a seed) trains with Adam
on 512 such images, then each saliency method (torchray's grid: the
centre baseline, gradient, deconvnet, guided backprop, Grad-CAM,
excitation backprop at layer3, contrastive EBP, RISE, extremal
perturbation) goes through ``explain/benchmark.py::run_pointing_benchmark``
with tolerance 15 into the sqlite ``ExperimentStore``. One JSON line a
method (pointing accuracy, hits, items, wall seconds) after one for the
training. No real VOC or published caffe weights exist on either machine:
only the images are synthetic.

Runs on the card unless given ``--device cpu``; results also go to
``--out`` (default ``build/torch_pointing_game_report.jsonl``) and the store
to ``--store`` (default ``build/torch_pointing_game.sqlite``).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_bench_common as common  # noqa: E402

NUM_CLASSES = 20
METHODS = ("center", "gradient", "deconvnet", "guided_backprop", "grad_cam",
           "excitation_backprop", "contrastive_excitation_backprop", "rise",
           "extremal_perturbation")


def make_synthetic_voc(n: int, seed: int, size: int = 224, blob_r: int = 30):
    """(images float32 in [0, 1] (N, H, W, 3), labels (N,), masks bool
    (N, H, W)): the JAX script's task, numpy call for numpy call."""
    import numpy as np

    rng = np.random.RandomState(seed)
    palette = np.stack([
        0.5 + 0.5 * np.cos(2 * np.pi * (np.arange(NUM_CLASSES) / NUM_CLASSES + sh))
        for sh in (0.0, 1 / 3, 2 / 3)], axis=1).astype(np.float32)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    images = rng.rand(n, size, size, 3).astype(np.float32) * 0.35
    labels = rng.randint(0, NUM_CLASSES, n)
    masks = np.zeros((n, size, size), bool)
    for i in range(n):
        cy, cx = rng.randint(blob_r, size - blob_r, 2)
        d2 = (yy - cy) ** 2 + (xx - cx) ** 2
        images[i] += np.exp(-d2 / (2 * (blob_r / 2.0) ** 2))[..., None] * palette[labels[i]]
        masks[i] = d2 <= blob_r ** 2
    return np.clip(images, 0, 1), labels.astype(np.int64), masks


def saliency_methods(model, device, size: int, rise_masks: int, extremal_iters: int):
    """name -> fn(image (H, W, 3), class) -> (h, w) map."""
    import torch

    from scouter_tpu_torch.explain import backprop, cam, excitation
    from scouter_tpu_torch.explain.extremal import extremal_perturbation
    from scouter_tpu_torch.explain.rise import rise

    def batch(image):
        return torch.as_tensor(image, dtype=torch.float32, device=device).permute(
            2, 0, 1)[None].contiguous()

    def on_model(fn, **kw):
        return lambda image, c: fn(model, batch(image), int(c), **kw)

    center = torch.zeros((size, size))
    center[size // 2, size // 2] = 1.0

    def rise_map(image, c):
        return rise(model, batch(image), seed=5, num_masks=rise_masks)[c]

    def extremal_map(image, c):
        masks, _ = extremal_perturbation(model, batch(image), int(c), areas=(0.05,),
                                         max_iter=extremal_iters)
        return masks[0, 0]

    return {"center": lambda image, c: center,
            "gradient": on_model(backprop.gradient_saliency),
            "deconvnet": on_model(backprop.deconvnet),
            "guided_backprop": on_model(backprop.guided_backprop),
            "grad_cam": on_model(cam.gradcam),
            "excitation_backprop": on_model(excitation.excitation_backprop,
                                            saliency_layer="layer3"),
            "contrastive_excitation_backprop": on_model(
                excitation.contrastive_excitation_backprop),
            "rise": rise_map, "extremal_perturbation": extremal_map}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    common.add_device_arg(p)
    p.add_argument("--arch", default="resnet50", choices=["vgg16", "resnet50"])
    p.add_argument("--train_steps", type=int, default=300)
    p.add_argument("--n_train", type=int, default=512)
    p.add_argument("--n_eval", type=int, default=50)
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--rise_masks", type=int, default=2000)
    p.add_argument("--extremal_iters", type=int, default=400)
    p.add_argument("--methods", default=",".join(METHODS))
    p.add_argument("--out", default=os.path.join(common.BUILD,
                                                 "torch_pointing_game_report.jsonl"))
    p.add_argument("--store", default=os.path.join(common.BUILD, "torch_pointing_game.sqlite"))
    args = p.parse_args(argv)
    device, card = common.setup(args.device)

    import numpy as np
    import torch

    from scouter_tpu_torch.explain.benchmark import ExperimentStore, run_pointing_benchmark
    from scouter_tpu_torch.explain.benchmark_models import get_model

    wanted = args.methods.split(",")
    unknown = sorted(set(wanted) - set(METHODS))
    if unknown:
        raise SystemExit(f"unknown methods {unknown} (have {list(METHODS)})")
    model, _ = get_model(args.arch, "voc", device=str(device), seed=0)
    tr_x, tr_y, _ = make_synthetic_voc(args.n_train, seed=0, size=args.size)
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    rng = np.random.RandomState(1)
    model.train()
    t0 = time.perf_counter()
    for _ in range(args.train_steps):
        sel = rng.randint(0, len(tr_x), 16)
        x = torch.from_numpy(tr_x[sel]).to(device).permute(0, 3, 1, 2)
        loss = torch.nn.functional.cross_entropy(model(x), torch.from_numpy(tr_y[sel]).to(device))
        opt.zero_grad()
        loss.backward()
        opt.step()
    common.sync(device)
    train_wall = time.perf_counter() - t0
    model.eval().requires_grad_(False)
    te_x, te_y, te_m = make_synthetic_voc(args.n_eval, seed=9, size=args.size)
    with torch.no_grad():
        logits = model(torch.from_numpy(te_x[:32]).to(device).permute(0, 3, 1, 2))
    test_acc = float((logits.argmax(1).cpu().numpy() == te_y[:32]).mean())
    common.emit({"arch": args.arch, "train_steps": args.train_steps, "train_wall_s": train_wall,
                 "test_acc": test_acc, "card": card, "device": str(device)}, args.out)

    methods = saliency_methods(model, device, args.size, args.rise_masks,
                               args.extremal_iters)
    os.makedirs(os.path.dirname(os.path.abspath(args.store)), exist_ok=True)
    if os.path.exists(args.store):
        os.unlink(args.store)
    store = ExperimentStore(args.store)
    try:
        for name in wanted:
            dataset = ((te_x[i], int(te_y[i]), te_m[i]) for i in range(args.n_eval))
            t0 = time.perf_counter()
            game = run_pointing_benchmark(methods[name], dataset, NUM_CLASSES, tolerance=15,
                                          store=store, series=f"{args.arch}_synthetic_voc",
                                          experiment=name)
            common.sync(device)
            common.emit({"method": name, "pointing_acc": float(game.accuracy),
                         "hits": int(game.hits.sum()),
                         "n": int(game.hits.sum() + game.misses.sum()),
                         "wall_s": time.perf_counter() - t0, "arch": args.arch,
                         "card": card, "device": str(device)}, args.out)
    finally:
        store.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
