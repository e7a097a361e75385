"""The port stands alone and runs on the card by default:

- importing every ``scouter_tpu_torch`` module, ``chip_smoke`` and
  ``examples/torch_profile_{serve,train}`` loads neither JAX, flax nor the JAX
  package (checked in a fresh interpreter,
  since this test process has JAX loaded already);
- the entry points, with their default arguments, raise on a host without
  CUDA instead of running on the CPU;
- under grad the xSlot kernel's wrapper goes through its checkpointed
  gradient, on the CPU through the plain version;
- the explain path runs with neither Pillow nor matplotlib importable, as
  on the card's machine, and the heatmap kernel's wrapper launches nothing
  for CPU tensors.
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
import torch_profile_train
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


def test_entry_points_raise_without_cuda(no_cuda, tmp_path):
    from scouter_tpu_torch.core import resolve_device
    from scouter_tpu_torch.models import build_slot_model
    from scouter_tpu_torch.serve import InferenceEngine, make_serving_fn
    from scouter_tpu_torch.train import Trainer, run_training
    from scouter_tpu_torch.train.cli import main as train_main

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
    cfg = cfg.replace(output_dir=str(tmp_path), dataset_dir=str(tmp_path / "none"))
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_training(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_main(["--model", "resnet10", "--num_classes", "2", "--img_size", "32",
                    "--slots_per_class", "1", "--epochs", "1", "--pre_trained", "false",
                    "--dataset_dir", str(tmp_path / "none"), "--output_dir", str(tmp_path)])


def test_server_cli_raises_without_cuda(no_cuda, tmp_path):
    from scouter_tpu_torch.serve.server import main

    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--model", "resnet10", "--num_classes", "2", "--img_size", "32",
              "--slots_per_class", "1", "--output_dir", str(tmp_path), "--port", "0"])


def test_explain_cli_raises_without_cuda(no_cuda, tmp_path):
    from scouter_tpu_torch.explain.cli import main

    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--model", "resnet10", "--num_classes", "2", "--img_size", "32",
              "--slots_per_class", "1", "--pre_trained", "false",
              "--dataset_dir", str(tmp_path / "none"), "--output_dir", str(tmp_path)])


_NO_PIL_PROBE = r"""
import sys
sys.modules["PIL"] = None
sys.modules["matplotlib"] = None
import numpy as np
from scouter_tpu_torch.core import ScouterConfig
from scouter_tpu_torch.core.png import read_png
from scouter_tpu_torch.explain.cli import render_explanations
from scouter_tpu_torch.models import build_slot_model
from scouter_tpu_torch.train import create_train_state

cfg = ScouterConfig(model="resnet10", dataset="MNIST", num_classes=2, img_size=32,
                    slots_per_class=1, pre_trained=False, cal_area_size=True, device="cpu")
model = build_slot_model(cfg, fused_slot=True, device="cpu")
image = np.random.RandomState(0).randint(0, 256, (28, 28, 1)).astype(np.uint8)
ratio = render_explanations(cfg, create_train_state(model, cfg.lr), model, image, 1, sys.argv[1])
mask = read_png(sys.argv[1] + "/slot_mask_1.png")
print(ratio, mask.shape, sorted(m for m in sys.modules if m.split(".")[0] in ("PIL", "matplotlib")
                               and sys.modules[m] is not None))
"""


def test_explain_path_needs_neither_pil_nor_matplotlib(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _NO_PIL_PROBE, str(tmp_path)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    ratio, rest = out.stdout.strip().splitlines()[-1].split(" ", 1)
    assert 0.0 <= float(ratio) <= 1.0
    assert rest == "(28, 28, 4) []"


def test_render_kernel_wrapper_on_cpu_tensors_launches_nothing():
    from scouter_tpu_torch.ops.render_kernel import render_heatmaps_fused, render_heatmaps_ref

    attn = torch.from_numpy(np.random.RandomState(0).rand(5, 9).astype(np.float32))
    launches = render_heatmaps_fused.launches
    torch.testing.assert_close(render_heatmaps_fused(attn), render_heatmaps_ref(attn),
                               rtol=0, atol=0)
    assert render_heatmaps_fused(attn[:0]).shape == (0, 9, 4)
    assert render_heatmaps_fused.launches == launches


def test_chip_smoke_fails_without_cuda(no_cuda):
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_xslot_kernel_wrapper_refuses_grad():
    # the refusal is gone: under grad the wrapper takes the checkpointed
    # gradient (on CPU tensors through the plain version, launching nothing)
    from scouter_tpu_torch.ops.slot_kernel import _XSlotFused, xslot_iterations_fused

    rng = np.random.RandomState(0)
    d = 8
    args = [torch.tensor(rng.randn(*s), dtype=torch.float32)
            for s in ((2, 5, d), (2, 5, d), (3, d), (3 * d, d), (3 * d, d), (1, 3 * d),
                      (1, 3 * d))]
    args[3].requires_grad_(True)
    launches = (xslot_iterations_fused.launches, xslot_iterations_fused.hist_launches)
    upd, attn = xslot_iterations_fused(*args)
    assert type(upd.grad_fn) is _XSlotFused._backward_cls
    assert type(attn.grad_fn) is _XSlotFused._backward_cls
    upd.sum().backward()
    assert args[3].grad is not None and args[3].grad.shape == (3 * d, d)
    with torch.no_grad():
        upd, attn = xslot_iterations_fused(*args)
    assert upd.grad_fn is None
    assert upd.shape == (2, 3, d) and attn.shape == (2, 3, 5)
    assert (xslot_iterations_fused.launches, xslot_iterations_fused.hist_launches) == launches


_NEW_MODULES = ("scouter_tpu_torch.core.png", "scouter_tpu_torch.core.checkpoint",
                "scouter_tpu_torch.data._decode", "scouter_tpu_torch.data.native_stager",
                "scouter_tpu_torch.data.streaming", "scouter_tpu_torch.data.folders",
                "scouter_tpu_torch.train.preempt", "scouter_tpu_torch.train.loop",
                "scouter_tpu_torch.serve.server")


@pytest.mark.parametrize("module", _NEW_MODULES)
def test_image_and_resilience_modules_import_no_jax_nor_pil(module):
    """Each module of the image reading and preemption path, alone in a fresh
    interpreter, loads neither JAX, the JAX package nor Pillow."""
    probe = (f"import importlib, sys; importlib.import_module({module!r}); "
             "print(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'flax', 'scouter_tpu', 'PIL')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


_NO_CUDA_DECODE_PROBE = r"""
import sys
sys.modules["PIL"] = None
import numpy as np
from scouter_tpu_torch.data import FolderDataset, native_stager
from scouter_tpu_torch.data._decode import decode_jpeg, decode_file
from scouter_tpu_torch.serve.server import _decode_image

fixtures = sys.argv[1]
jpeg = open(fixtures + "/rgb420_500x375.jpg", "rb").read()
refused = []
for what, call in (
        ("dataset", lambda: FolderDataset([(fixtures + "/rgb420_500x375.jpg", 0)], 16, "CUB200")),
        ("decode_jpeg", lambda: decode_jpeg(jpeg, "cuda")),
        ("decode_file", lambda: decode_file(fixtures + "/rgba_220x160.png", 16, "cuda")),
        ("server", lambda: _decode_image(jpeg, 16, 3, "cuda"))):
    try:
        call()
    except RuntimeError as exc:
        if "CUDA" in str(exc):
            refused.append(what)
staged = native_stager.resize_batch(np.zeros((1, 8, 8, 3), np.uint8), (4, 4))
print(refused, decode_jpeg.decodes, staged.shape,
      sorted(m for m in sys.modules if m.split(".")[0] == "PIL" and sys.modules[m] is not None))
"""


def test_image_path_refuses_cuda_without_a_card(no_cuda):
    """Where no CUDA device exists, ``FolderDataset(device="cuda")``, the
    JPEG decoder, a PNG decode and the server's decode raise, decode nothing
    and import no Pillow; the host stager runs without Pillow."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _NO_CUDA_DECODE_PROBE,
                          str(ROOT / "tests" / "torch_fixtures")], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ("['dataset', 'decode_jpeg', 'decode_file', 'server'] 0 "
                                  "(1, 4, 4, 3) []")


def test_stager_raises_without_a_compiler(tmp_path, monkeypatch):
    from scouter_tpu_torch.data import native_stager

    monkeypatch.setattr(native_stager, "_lib", None)
    monkeypatch.setattr(native_stager, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native_stager.shutil, "which", lambda name: None)
    monkeypatch.delenv("CXX", raising=False)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native_stager.resize_batch(np.zeros((1, 4, 4, 3), np.uint8), (2, 2))
    assert not list(tmp_path.iterdir())
