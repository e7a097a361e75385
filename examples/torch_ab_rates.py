"""Serving and training img/s of one checkout of the port, for comparing two
checkouts on one card in alternate processes:

    git archive HEAD | tar -x -C build/parent    # the parent, in an ignored dir
    for r in build/parent . . build/parent; do
        python examples/torch_ab_rates.py $r <tag> <out.jsonl> [models] [serve]
    done

Runs ``chip_smoke.phase_throughput`` (``make_serving_fn`` at batch 70, f32
and bf16) and, unless ``serve`` is given, ``phase_train_throughput`` (f32
train steps at batch 70) of the checkout at ``root``, for the flagship's
config on each of ``models`` (comma list; default resnest26d,resnet50),
and appends one JSON line to ``out.jsonl`` with the card's name and power
limit. The checkout's own kernels are built first.
"""

import json
import subprocess
import sys
from pathlib import Path


def main():
    root, tag, out = sys.argv[1:4]
    models = sys.argv[4].split(",") if len(sys.argv) > 4 else ["resnest26d", "resnet50"]
    serve_only = len(sys.argv) > 5 and sys.argv[5] == "serve"
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke
    from scouter_tpu_torch.core import ScouterConfig
    from scouter_tpu_torch.models import build_slot_model
    from scouter_tpu_torch.ops import cuda_build

    if chip_smoke.ROOT.resolve() != Path(root).resolve():
        sys.exit(f"imported {chip_smoke.ROOT}, not {root}")
    cuda_build.build_all(["xslot_fwd", "xslot_bwd"])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    row = {"tag": tag, "card": card}
    for model in models:
        cfg = ScouterConfig(**chip_smoke.FLAGSHIP).replace(model=model)
        state_dict = build_slot_model(cfg, device="cpu").state_dict()
        row[f"{model}_serve"] = chip_smoke.phase_throughput(cfg, state_dict, card)
        if not serve_only:
            row[f"{model}_train"] = chip_smoke.phase_train_throughput(cfg, card)
    with open(out, "a") as f:
        f.write(json.dumps(row) + "\n")
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
