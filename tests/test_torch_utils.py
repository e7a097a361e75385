"""The port's utils package and MNIST variants against the JAX package on
the CPU: ``ModelEma`` (a decay that changes between updates), top-1/top-5,
the top-k checkpoint saver's ranking, files and recovery, the summary CSV
byte for byte, ``model_cost_analysis``'s FLOPs against XLA's cost analysis,
``Timer`` and ``trace``, and ``load_mnist_variant`` over IDX trees laid out
as each variant ships."""

import gzip
import json
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scouter_tpu.data.mnist import load_mnist_variant as jax_load_mnist_variant
from scouter_tpu.utils import CheckpointSaver as JaxSaver
from scouter_tpu.utils import ModelEma as JaxEma
from scouter_tpu.utils import evaluate_top1 as jax_top1
from scouter_tpu.utils import evaluate_top5 as jax_top5
from scouter_tpu.utils import model_cost_analysis as jax_cost
from scouter_tpu.utils import update_summary as jax_update_summary
from scouter_tpu_torch.data.mnist import _VARIANT_SUBDIRS, load_mnist_variant
from scouter_tpu_torch.utils import (CheckpointSaver, ModelEma, Timer, evaluate_top1,
                                     evaluate_top5, model_cost_analysis, trace,
                                     update_summary)


def test_public_names_equal_jax():
    import scouter_tpu.utils as jax_utils
    import scouter_tpu_torch.utils as utils

    assert sorted(utils.__all__) == sorted(jax_utils.__all__)
    assert sorted(_VARIANT_SUBDIRS) == ["EMNIST", "FashionMNIST", "KMNIST", "MNIST", "QMNIST"]


def test_model_ema_matches_jax_with_a_changing_decay():
    rng = np.random.RandomState(0)
    shapes = {"w": (8, 3, 3, 3), "b": (8,), "fc": (5, 8)}
    params0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    steps = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()} for _ in range(6)]
    want = JaxEma({k: jnp.asarray(v) for k, v in params0.items()}, decay=0.9)
    got = ModelEma({k: torch.from_numpy(v) for k, v in params0.items()}, decay=0.9,
                   device="cpu")
    for i, p in enumerate(steps):
        want.decay = got.decay = 0.9 + 0.01 * i  # a warmup that moves the decay
        want.update({k: jnp.asarray(v) for k, v in p.items()})
        got.update({k: torch.from_numpy(v) for k, v in p.items()})
    for k in shapes:
        assert got.params[k].dtype == torch.float32
        np.testing.assert_allclose(got.params[k].numpy(), np.asarray(want.params[k]),
                                   rtol=1e-7, atol=0)


def test_model_ema_copies_its_parameters():
    p = {"w": torch.zeros(3)}
    ema = ModelEma(p, decay=0.9, device="cpu")
    ema.update({"w": torch.ones(3)})
    assert torch.equal(p["w"], torch.zeros(3))
    np.testing.assert_allclose(ema.params["w"].numpy(), 0.1, rtol=1e-6)


@pytest.mark.parametrize("classes", [3, 10])
def test_top1_top5_equal_jax(classes):
    rng = np.random.RandomState(classes)
    logits = rng.randn(32, classes).astype(np.float32)
    logits[:4] = logits[4:8].round(0)  # ties
    labels = rng.randint(0, classes, 32)
    t, l = torch.from_numpy(logits), torch.from_numpy(labels)
    for fn, jfn in ((evaluate_top1, jax_top1), (evaluate_top5, jax_top5)):
        got = fn(t, l)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert got.item() == float(jfn(jnp.asarray(logits), jnp.asarray(labels)))


@pytest.mark.parametrize("decreasing", [False, True])
def test_checkpoint_saver_ranks_as_jax(tmp_path, decreasing):
    metrics = [0.5, 0.7, 0.6, 0.65, 0.9, 0.1, 0.8]
    want = JaxSaver(str(tmp_path / "jax"), max_history=3, decreasing=decreasing)
    got = CheckpointSaver(str(tmp_path / "port"), max_history=3, decreasing=decreasing)
    for epoch, m in enumerate(metrics):
        best_w = want.save_checkpoint(b"x", epoch, m)
        best_g = got.save_checkpoint({"epoch": epoch, "metric": m}, epoch, m)
        assert best_g == best_w and got.best_epoch == want.best_epoch
        assert [(os.path.basename(p).replace(".pth", ""), v) for p, v in got.checkpoint_files] \
            == [(os.path.basename(p).replace(".msgpack", ""), v)
                for p, v in want.checkpoint_files]
    files = sorted(os.listdir(tmp_path / "port"))
    kept = sorted(os.path.basename(p) for p, _ in got.checkpoint_files)
    assert files == sorted(kept + ["model_best.pth"])
    best = torch.load(tmp_path / "port" / "model_best.pth", weights_only=True)
    assert best == {"epoch": got.best_epoch, "metric": got.best_metric}


def test_recovery_is_written_then_cleaned(tmp_path):
    saver = CheckpointSaver(str(tmp_path))
    saver.save_recovery({"a": 1}, 1, 10)
    path = saver.save_recovery({"a": 2}, 1, 20)
    assert saver.find_recovery() == path
    assert [f for f in os.listdir(tmp_path) if f.startswith("recovery")] == [
        "recovery-1-20.pth"]
    assert torch.load(path, weights_only=True) == {"a": 2}


def test_summary_csv_bytes_equal_jax(tmp_path):
    rows = [(0, {"loss": 1.0, "acc": 0.25}, {"acc": 0.5, "loss": 1.5}),
            (1, {"loss": 0.5, "acc": 0.75}, {"acc": 0.625, "loss": 0.875}),
            (2, {"loss": 0.25, "acc": 1.0}, {"acc": 0.75, "loss": 0.5})]
    for fn, name in ((jax_update_summary, "jax.csv"), (update_summary, "port.csv")):
        for epoch, tr, ev in rows:
            fn(epoch, tr, ev, str(tmp_path / name), write_header=epoch == 2)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


def test_cost_analysis_flops_equal_xla():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 16, 16, 3).astype(np.float32)
    w = rng.randn(3, 3, 3, 8).astype(np.float32)
    a, b = rng.randn(4, 6).astype(np.float32), rng.randn(6, 5).astype(np.float32)
    want_conv = jax_cost(lambda x: jax.lax.conv_general_dilated(
        x, jnp.asarray(w), (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC")),
        jnp.asarray(x))
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    got_conv = model_cost_analysis(lambda t: torch.nn.functional.conv2d(t, wt),
                                   torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert got_conv["flops"] == want_conv["flops"]
    # operand and result bytes: input, weight and output once each
    assert got_conv["bytes accessed"] == 4 * (x.size + w.size + 2 * 8 * 14 * 14)
    want_mm = jax_cost(lambda a, b: a @ b, jnp.asarray(a), jnp.asarray(b))
    got_mm = model_cost_analysis(lambda a, b: a @ b, torch.from_numpy(a), torch.from_numpy(b))
    assert got_mm["flops"] == want_mm["flops"] == 2 * 4 * 6 * 5
    assert got_mm["bytes accessed"] == 4 * (a.size + b.size + 4 * 5)


def test_timer_and_trace_on_the_cpu(tmp_path):
    timer = Timer(device="cpu")
    for _ in range(2):
        with timer.measure(lambda: torch.ones(3)):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert len(timer.times) == 2 and timer.mean > 0
    with trace(str(tmp_path / "tr")):
        torch.ones(32, 32) @ torch.ones(32, 32)
    (name,) = os.listdir(tmp_path / "tr")
    assert name.endswith(".pt.trace.json")
    events = json.loads((tmp_path / "tr" / name).read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def write_idx(path, arr, gz=False):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    header = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(f">{arr.ndim}I", *arr.shape)
    opener = gzip.open if gz else open
    with opener(path + (".gz" if gz else ""), "wb") as f:
        f.write(header + arr.astype(np.uint8).tobytes())


LAYOUTS = {  # variant -> (directory under root, file-name prefix, gzip)
    "FashionMNIST": ("FashionMNIST/raw", "", False),
    "KMNIST": ("KMNIST", "", True),
    "MNIST": ("", "", False),
    "QMNIST": ("QMNIST/raw", "qmnist-", False),
    "EMNIST": ("", "emnist-letters-", True),
}


@pytest.mark.parametrize("variant", sorted(LAYOUTS))
def test_load_mnist_variant_equals_jax(tmp_path, variant):
    sub, prefix, gz = LAYOUTS[variant]
    rng = np.random.RandomState(len(variant))
    arrays = {}
    for train, stem in ((True, "train"), (False, "t10k")):
        n = 7 if train else 3
        images = rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
        labels = rng.randint(0, 10, n).astype(np.uint8)
        d = os.path.join(tmp_path, sub)
        write_idx(os.path.join(d, f"{prefix}{stem}-images-idx3-ubyte"), images, gz)
        write_idx(os.path.join(d, f"{prefix}{stem}-labels-idx1-ubyte"), labels, gz)
        arrays[train] = (images, labels)
    for train in (True, False):
        x, y = load_mnist_variant(str(tmp_path), variant, train)
        jx, jy = jax_load_mnist_variant(str(tmp_path), variant, train)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
        np.testing.assert_array_equal(x[..., 0], arrays[train][0])
        assert x.dtype == np.uint8 and y.dtype == np.int32


def test_load_mnist_variant_errors_as_jax(tmp_path):
    for fn in (load_mnist_variant, jax_load_mnist_variant):
        with pytest.raises(ValueError, match="unknown MNIST variant"):
            fn(str(tmp_path), "CIFAR")
        with pytest.raises(FileNotFoundError, match="QMNIST IDX files not found"):
            fn(str(tmp_path), "QMNIST")
