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


_PRUNED_PROBE = r"""
import sys
opened = []
sys.addaudithook(lambda event, args: opened.append(str(args[0]))
                 if event == "open" and isinstance(args[0], str) else None)
import torch
from scouter_tpu_torch.models import create_model
with torch.device("meta"):
    for name in ("ecaresnet50d_pruned", "ecaresnet101d_pruned"):
        create_model(name)
tables = sorted({p.split("/")[-1] for p in opened if p.endswith("_pruned.json")})
print(tables, sorted(p for p in opened if "/scouter_tpu/" in p))
"""


def test_pruned_models_read_the_ports_own_tables():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _PRUNED_PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == (
        "['ecaresnet101d_pruned.json', 'ecaresnet50d_pruned.json'] []"), out.stdout
    for name in ("ecaresnet50d_pruned", "ecaresnet101d_pruned"):
        ours = ROOT / "scouter_tpu_torch" / "models" / "pruned_data" / f"{name}.json"
        assert ours.read_bytes() == (ROOT / "scouter_tpu" / "models" / "pruned_data" /
                                     f"{name}.json").read_bytes()


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


# Each module's import probe runs alone in a child forked from one fresh
# interpreter that has loaded only torch and numpy, and itself none of the
# banned packages: the child's modules are those of a fresh interpreter that
# imported the module, and the interpreter starts once for every probe.
_FORKED_PROBES = r"""
import importlib, json, os, sys
import numpy, torch
modules = json.loads(sys.argv[1])
banned = ("jax", "jaxlib", "flax", "optax", "scouter_tpu", "PIL", "matplotlib")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in banned)
assert not loaded, loaded
for module in modules:
    sys.stdout.flush()
    pid = os.fork()
    if pid == 0:
        importlib.import_module(module)
        print(json.dumps([module, sorted(m for m in sys.modules if m.split(".")[0] in banned)]))
        sys.stdout.flush()
        os._exit(0)
    _, status = os.waitpid(pid, 0)
    if status:
        print(json.dumps([module, "exit status %d" % status]))
"""


@pytest.fixture(scope="module")
def import_probes():
    """{module: the banned packages its import loaded} for every module the
    per-module tests below name."""
    import json

    modules = list(_NEW_MODULES) + [f"scouter_tpu_torch.{m}" for m in
                                    _XAI_MODULES + _FACTORY_MODULES + _DIST_MODULES]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _FORKED_PROBES, json.dumps(modules)], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    found = dict(json.loads(line) for line in out.stdout.splitlines())
    assert sorted(found) == sorted(modules), out.stderr
    return found


@pytest.mark.parametrize("module", _NEW_MODULES)
def test_image_and_resilience_modules_import_no_jax_nor_pil(module, import_probes):
    """Each module of the image reading and preemption path, alone in a fresh
    interpreter (``_FORKED_PROBES``), loads neither JAX, the JAX package nor
    Pillow."""
    loaded = import_probes[module]
    assert isinstance(loaded, list), loaded
    assert [m for m in loaded if m.split(".")[0] in
            ("jax", "jaxlib", "flax", "scouter_tpu", "PIL")] == []


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


# the factories, augmentation and utils slice: none loads JAX, optax, flax,
# the JAX package or Pillow
_FACTORY_MODULES = ("train.optim_factory", "train.scheduler_factory", "ops.extra_losses",
                    "utils", "utils.ema", "utils.metrics", "utils.profiling", "utils.saver",
                    "utils.summary", "data.mnist", "data.extra_augment", "data.auto_augment",
                    "data.tf_pre")


@pytest.mark.parametrize("module", _FACTORY_MODULES)
def test_factory_and_augment_modules_import_no_jax_nor_pil(module, import_probes):
    """Each module of the factories, augmentation and utils slice, alone in a
    fresh interpreter (``_FORKED_PROBES``), loads neither JAX, flax, optax,
    the JAX package nor Pillow."""
    loaded = import_probes[f"scouter_tpu_torch.{module}"]
    assert isinstance(loaded, list), loaded
    assert [m for m in loaded if m.split(".")[0] in
            ("jax", "jaxlib", "flax", "optax", "scouter_tpu", "PIL")] == []


_AUGMENT_NO_PIL_PROBE = r"""
import sys
sys.modules["PIL"] = None
import numpy as np, torch
from scouter_tpu_torch.core.png import encode_png
from scouter_tpu_torch.data import TfPreprocessTransform
from scouter_tpu_torch.data.auto_augment import AutoAugment, RandAugment
from scouter_tpu_torch.data.extra_augment import mixup, random_erasing
from scouter_tpu_torch.utils import model_cost_analysis

img = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (4, 3, 40, 30)).astype(np.uint8))
a = AutoAugment("original", seed=0)(img)
r = RandAugment(2, 9, seed=0)(img[0])
png = encode_png(img[0].permute(1, 2, 0).numpy())
t = TfPreprocessTransform(is_training=True, size=16, seed=0, device="cpu")(png)
x, y = mixup(img.float(), torch.arange(4), 4, torch.Generator().manual_seed(0))
e = random_erasing(img.float(), torch.Generator().manual_seed(0))
cost = model_cost_analysis(lambda m: m @ m, torch.ones(3, 3))
print(tuple(a.shape), tuple(r.shape), tuple(t.shape), tuple(y.shape), tuple(e.shape),
      cost["flops"], sorted(m for m in sys.modules if m.split(".")[0] == "PIL"
                            and sys.modules[m] is not None))
"""


def test_augmentations_run_without_pil():
    """AutoAugment, RandAugment, TF preprocessing from PNG bytes, mixup,
    erasing and the cost analysis run with Pillow blocked, as on the card's
    machine."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _AUGMENT_NO_PIL_PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == (
        "(4, 3, 40, 30) (3, 40, 30) (16, 16, 3) (4, 4) (4, 3, 40, 30) 54.0 []")


def test_factory_entry_points_raise_without_cuda(no_cuda):
    from scouter_tpu_torch.data import TfPreprocessTransform
    from scouter_tpu_torch.utils import ModelEma, Timer

    for make in (lambda: TfPreprocessTransform(), lambda: ModelEma({"w": torch.zeros(2)}),
                 lambda: Timer()):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


_XAI_MODULES = ("models.act", "explain.cam", "explain.backprop", "explain.rise",
                "explain.igos", "explain.extremal", "explain.iba", "explain.deeplift",
                "explain.excitation", "explain.image_utils", "explain.compare_cli",
                "explain.pointing_game", "explain.benchmark", "explain.datasets",
                "explain.benchmark_models", "explain.iba_readout", "explain.parity")
# the modules of the paths the card runs: no Pillow, no matplotlib either
_XAI_NO_IMAGING = ("explain.compare_cli", "explain.benchmark", "explain.datasets",
                   "explain.benchmark_models")


@pytest.mark.parametrize("module", _XAI_MODULES)
def test_xai_modules_import_no_jax_optax_nor_jax_package(module, import_probes):
    """Each module of the XAI suite, alone in a fresh interpreter
    (``_FORKED_PROBES``), loads neither JAX, flax, optax nor the JAX
    package; the comparison CLI and the pointing-game stack load neither
    Pillow nor matplotlib."""
    banned = ["jax", "jaxlib", "flax", "optax", "scouter_tpu"]
    if module in _XAI_NO_IMAGING:
        banned += ["PIL", "matplotlib"]
    loaded = import_probes[f"scouter_tpu_torch.{module}"]
    assert isinstance(loaded, list), loaded
    assert [m for m in loaded if m.split(".")[0] in banned] == []


_XAI_NO_PIL_PROBE = r"""
import os, sys
sys.modules["PIL"] = None
sys.modules["matplotlib"] = None
import numpy as np, torch
from scouter_tpu_torch.core.png import read_png, write_png
from scouter_tpu_torch.explain.benchmark import ExperimentStore, run_pointing_benchmark
from scouter_tpu_torch.explain.benchmark_models import get_model, get_transform
from scouter_tpu_torch.explain.compare_cli import compare_methods
from scouter_tpu_torch.explain.datasets import voc_dataset
from scouter_tpu_torch.explain.excitation import excitation_backprop
from scouter_tpu_torch.explain.image_utils import imread
from scouter_tpu_torch.models import create_model, init_weights

out = sys.argv[1]
model = create_model("resnet10", num_classes=3)
init_weights(model, torch.Generator().manual_seed(0))
image = np.random.RandomState(0).randint(0, 256, (40, 40, 3)).astype(np.uint8)
maps = compare_methods(model.eval(), image, [1], out, img_size=32,
                       methods=["gradcam", "gradient", "rise", "deeplift"], fast=True)
root = os.path.join(out, "voc")
for d in ("Annotations", "JPEGImages", "ImageSets/Main"):
    os.makedirs(os.path.join(root, d))
with open(os.path.join(root, "ImageSets/Main/test.txt"), "w") as f:
    f.write("000001\n")
with open(os.path.join(root, "Annotations/000001.xml"), "w") as f:
    f.write("<annotation><size><width>40</width><height>40</height></size><object>"
            "<name>cat</name><bndbox><xmin>5</xmin><ymin>6</ymin><xmax>20</xmax>"
            "<ymax>30</ymax></bndbox></object></annotation>")
# a PNG under the .jpg name the VOC layout uses: imread reads by content
write_png(os.path.join(root, "JPEGImages/000001.jpg"), image)
net, _ = get_model("resnet50", "voc", device="cpu")
transform = get_transform("voc", size=64)

def saliency(path, c):
    x = transform(imread(path, device="cpu")).permute(2, 0, 1)[None]
    return excitation_backprop(net, x, c)

game = run_pointing_benchmark(saliency, voc_dataset(root), 20,
                              store=ExperimentStore(os.path.join(out, "s.db")))
print(read_png(os.path.join(out, "gradcam_1.png")).shape, sorted(maps), int(game.hits.sum() +
      game.misses.sum()), sorted(m for m in sys.modules if m.split(".")[0] in
                                 ("PIL", "matplotlib") and sys.modules[m] is not None))
"""


def test_xai_paths_need_neither_pil_nor_matplotlib(tmp_path):
    """The comparison driver, the PNG reader and the pointing-game stack
    (VOC tree, caffe ResNet50, EBP, sqlite store) run with Pillow and
    matplotlib blocked, as on the card's machine."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _XAI_NO_PIL_PROBE, str(tmp_path)], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == (
        "(40, 40, 4) ['deeplift', 'gradcam', 'gradient', 'rise'] 1 []")


def test_xai_entry_points_raise_without_cuda(no_cuda, tmp_path):
    from scouter_tpu_torch.explain.benchmark_models import get_model
    from scouter_tpu_torch.explain.compare_cli import main
    from scouter_tpu_torch.explain.image_utils import imread

    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--model", "resnet10", "--num_classes", "2", "--img_size", "32",
              "--dataset_dir", str(tmp_path / "none"), "--output_dir", str(tmp_path)],
             out_dir=str(tmp_path / "vis"))
    with pytest.raises(RuntimeError, match="CUDA"):
        get_model("resnet50", "voc")
    with pytest.raises(RuntimeError, match="CUDA"):
        imread(str(tmp_path / "missing.png"))


# the distributed slice: none loads JAX, flax or the JAX package
_DIST_MODULES = ("core.distributed", "parallel", "parallel.mesh", "parallel.tp")


@pytest.mark.parametrize("module", _DIST_MODULES)
def test_distributed_modules_import_no_jax(module, import_probes):
    """Each module of the distributed slice, alone in a fresh interpreter
    (``_FORKED_PROBES``), loads neither JAX, flax nor the JAX package."""
    loaded = import_probes[f"scouter_tpu_torch.{module}"]
    assert isinstance(loaded, list), loaded
    assert [m for m in loaded if m.split(".")[0] in ("jax", "jaxlib", "flax", "scouter_tpu")] == []


_NO_FALLBACK_PROBE = r"""
import json, os, socket, sys, time
import torch.distributed as dist
from scouter_tpu_torch.core.distributed import init_distributed_mode

def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return str(s.getsockname()[1])

out = {}
init_distributed_mode(backend="nccl")  # no launcher environment: nothing happens
out["no_env"] = dist.is_initialized()
for case, world, kw in (("nccl", "1", dict(backend="nccl")),
                        ("nccl_cpu", "1", dict(backend="nccl", device="cpu")),
                        ("world2", "2", dict(device="cpu", timeout=2.0))):
    os.environ.update(RANK="0", WORLD_SIZE=world, LOCAL_RANK="0", MASTER_ADDR="localhost",
                      MASTER_PORT=free_port())
    t0 = time.monotonic()
    try:
        init_distributed_mode(**kw)
        out[case] = "started"
    except Exception as exc:
        out[case] = [type(exc).__name__, str(exc)[:200], dist.is_initialized(),
                     round(time.monotonic() - t0, 1)]
print(json.dumps(out))
"""


def test_no_fallback_when_the_group_cannot_start(no_cuda):
    """``init_distributed_mode`` does nothing without the launcher's
    environment; with it, NCCL without a card raises, NCCL on the CPU
    raises, and a world of 2 whose other rank never comes raises at its
    timeout: nothing carries on at world 1 or on gloo unasked."""
    import json

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    out = subprocess.run([sys.executable, "-c", _NO_FALLBACK_PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["no_env"] is False
    assert got["nccl"][0] == "RuntimeError" and "CUDA" in got["nccl"][1]
    assert got["nccl_cpu"][0] == "ValueError" and "nccl" in got["nccl_cpu"][1]
    assert got["world2"] != "started" and got["world2"][2] is False
    assert got["world2"][3] < 60
