"""The port stands alone and runs on the card by default:

- importing every ``scouter_tpu_torch`` module, ``chip_smoke`` and
  ``examples/torch_profile_serve`` loads neither JAX, flax nor the JAX
  package (checked in a fresh interpreter,
  since this test process has JAX loaded already);
- the entry points, with their default arguments, raise on a host without
  CUDA instead of running on the CPU;
- the xSlot kernel's wrapper refuses inputs that require grad under grad mode.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
import scouter_tpu_torch
names = [m.name for m in pkgutil.walk_packages(scouter_tpu_torch.__path__, "scouter_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
sys.path.insert(0, "examples")
import torch_profile_serve
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "scouter_tpu"))
print(len(names), bad)
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.split(" ", 1)
    assert int(n_modules) >= 15
    assert bad.strip() == "[]", bad


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for hosts without one")


def tiny_cfg():
    from scouter_tpu_torch.core import ScouterConfig

    return ScouterConfig(model="resnet10", dataset="MNIST", num_classes=2, img_size=32,
                         slots_per_class=1, pre_trained=False)


def test_defaults_target_cuda():
    from scouter_tpu_torch.core import ScouterConfig, get_args_parser

    assert ScouterConfig().device == "cuda"
    assert get_args_parser().parse_args([]).device == "cuda"


def test_entry_points_raise_without_cuda(no_cuda):
    from scouter_tpu_torch.core import resolve_device
    from scouter_tpu_torch.models import build_slot_model
    from scouter_tpu_torch.serve import InferenceEngine, make_serving_fn

    cfg = tiny_cfg()
    state_dict = build_slot_model(cfg, device="cpu").state_dict()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_slot_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_serving_fn(cfg, state_dict)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(cfg, state_dict)


def test_server_cli_raises_without_cuda(no_cuda, tmp_path):
    from scouter_tpu_torch.serve.server import main

    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--model", "resnet10", "--num_classes", "2", "--img_size", "32",
              "--slots_per_class", "1", "--output_dir", str(tmp_path), "--port", "0"])


def test_chip_smoke_fails_without_cuda(no_cuda):
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_xslot_kernel_wrapper_refuses_grad():
    from scouter_tpu_torch.ops.slot_kernel import xslot_iterations_fused

    rng = np.random.RandomState(0)
    d = 8
    args = [torch.tensor(rng.randn(*s), dtype=torch.float32)
            for s in ((2, 5, d), (2, 5, d), (3, d), (3 * d, d), (3 * d, d), (1, 3 * d),
                      (1, 3 * d))]
    args[3].requires_grad_(True)
    with pytest.raises(NotImplementedError):
        xslot_iterations_fused(*args)
    with torch.no_grad():
        upd, attn = xslot_iterations_fused(*args)
    assert upd.shape == (2, 3, d) and attn.shape == (2, 3, 5)
