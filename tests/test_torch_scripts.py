"""The port's measuring and recipe scripts (``examples/torch_*.py``) on the
CPU: their pure parts (utilisation arithmetic, percentiles, bucket fill,
the trees and data they write) against the JAX scripts' where those compute
the same thing, a ``--device cpu`` run of each at a tiny size, and the
default device: without a card every script fails instead of running on
the CPU."""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))

import bench_serve_load as jax_serve_load  # noqa: E402
import pointing_game_report as jax_pointing  # noqa: E402
import run_folder_recipe_smoke as jax_recipes  # noqa: E402
import torch_bench  # noqa: E402
import torch_bench_common as common  # noqa: E402
import torch_bench_serve  # noqa: E402
import torch_bench_serve_load  # noqa: E402
import torch_bench_train  # noqa: E402
import torch_bf16_negative_ablation  # noqa: E402
import torch_pointing_game_report  # noqa: E402
import torch_run_folder_recipe_smoke as recipes  # noqa: E402
import torch_run_mnist_recipes  # noqa: E402

from scouter_tpu.data import folders as jax_folders  # noqa: E402
from scouter_tpu_torch.data import folders, load_mnist, synthetic_mnist  # noqa: E402

SCRIPTS = (torch_bench, torch_bench_train, torch_bench_serve, torch_bench_serve_load, recipes,
           torch_run_mnist_recipes, torch_bf16_negative_ablation, torch_pointing_game_report)
TINY = ["--device", "cpu", "--model", "resnet10", "--channel", "512", "--img_size", "32"]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite's workers share the host's cores
    yield
    torch.set_num_threads(threads)


def records(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


# ------------------------------------------------------------- pure parts

def test_utilisation_against_the_published_peaks():
    # 7.36 GFLOP a call, 100 calls in 0.5 s: 1.472 TFLOP/s
    got = common.utilisation(7.36e9, 100, 0.5, common.H100_SXM, "bfloat16")
    assert got["achieved_tflops"] == pytest.approx(1.472)
    assert got["mfu"] == pytest.approx(1.472 / 989)
    assert common.utilisation(67e12, 1, 1.0, common.H100_SXM, "float32")["mfu"] == 1.0
    assert common.utilisation(1979e12, 2, 1.0, common.H100_SXM, "int8")["mfu"] == 2.0
    other = common.utilisation(1e12, 1, 1.0, "NVIDIA A100-SXM4-80GB", "bfloat16")
    assert other["mfu"] is None and "no published" in other["mfu_basis"]
    cpu = common.utilisation(1e12, 1, 1.0, None, "float32")
    assert cpu["achieved_tflops"] is None and cpu["mfu"] is None


def test_percentiles_equal_the_jax_scripts():
    vals = np.random.RandomState(0).exponential(0.05, 97).tolist()
    want = jax_serve_load._percentiles(vals)
    assert common.percentiles(vals) == {f"p{q}": v for q, v in want.items()}
    assert common.percentiles([]) == {}


def test_bucket_fill_delta():
    pre = {"4/3": 2, "1/1": 5}
    post = {"16/9": 1, "4/3": 2, "1/1": 7, "4/4": 3, "16/12": 2}
    assert list(common.fill_delta(pre, post).items()) == [("1/1", 2), ("4/4", 3), ("16/9", 1),
                                                          ("16/12", 2)]


def test_recipe_trees_scan_as_the_jax_package_scans_them(tmp_path):
    """Each tree the script lays out gives the same (path, label) items to
    the port's scans as to JAX's, with the ImageNet tree's four-component
    JPEGs in it, and the published flags are the JAX script's."""
    for name, tree in recipes.TINY_TREES.items():
        root = tmp_path / name
        root.mkdir()
        recipes.MAKERS[name](str(root), **tree)
        n = tree["n_classes"]
        scan, jax_scan = {
            "context": (folders.scan_context, jax_folders.scan_context),
            "imagenet": (lambda r: folders.scan_imagenet_subset(r, n),
                         lambda r: jax_folders.scan_imagenet_subset(r, n)),
            "cub": (lambda r: folders.scan_cub200(r, n),
                    lambda r: jax_folders.scan_cub200(r, n))}[name]
        ours, theirs = scan(str(root)), jax_scan(str(root))
        assert ours == theirs and ours[0] and ours[1], name
    train, val = folders.scan_imagenet_subset(str(tmp_path / "imagenet"), 3)
    firsts = [Path(p).read_bytes() for p, _ in train + val if p.endswith("img_000.jpg")]
    for fixture in recipes.CMYK_JPEGS:
        assert (ROOT / "tests" / "torch_fixtures" / fixture).read_bytes() in firsts
    assert recipes.RECIPES == jax_recipes.RECIPES


def test_synthetic_voc_equals_the_jax_scripts():
    ours = torch_pointing_game_report.make_synthetic_voc(3, seed=9, size=64, blob_r=10)
    theirs = jax_pointing.make_synthetic_voc(3, seed=9, size=64, blob_r=10)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


def test_idx_files_read_back_as_the_synthetic_set(tmp_path):
    torch_run_mnist_recipes.write_synthetic_mnist(str(tmp_path), 16)
    (tr_x, tr_y), (te_x, te_y) = synthetic_mnist(16, 4)
    for train, (x, y) in ((True, (tr_x, tr_y)), (False, (te_x, te_y))):
        got_x, got_y = load_mnist(str(tmp_path), train)
        np.testing.assert_array_equal(got_x, x)
        np.testing.assert_array_equal(got_y, y)


# -------------------------------------------------------- runs on the CPU

@pytest.mark.parametrize("script", SCRIPTS, ids=lambda m: m.__name__)
def test_scripts_fail_without_a_card_by_default(script, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for hosts without one")
    with pytest.raises(SystemExit) as exc:
        script.main([])
    assert exc.value.code == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_bench_serving_and_slot_kernel_on_the_cpu(tmp_path):
    out = tmp_path / "bench.jsonl"
    assert torch_bench.main(TINY + ["--batch", "2", "--iters", "1", "--out", str(out)]) == 0
    rows = records(out)
    assert [r["metric"].split(", ")[-1] for r in rows] == ["float32)", "bfloat16)"]
    assert all(r["flops_per_call"] > 0 and r["mfu"] is None and r["value"] > 0 for r in rows)
    assert torch_bench.main(["--device", "cpu", "--slot-kernel", "--out", str(out)]) == 0
    assert records(out)[-1]["ok"] is True


def test_bench_train_counts_the_whole_step(tmp_path):
    out = tmp_path / "train.jsonl"
    args = TINY + ["--batch_size", "2", "--iters", "1", "--compute_dtype", "float32"]
    assert torch_bench_train.main(args + ["--out", str(out)]) == 0
    (row,) = records(out)
    # forward and backward: more than twice the forward's FLOPs
    fwd = common.flagship(model="resnet10", channel=512, img_size=32, batch_size=2)
    from scouter_tpu_torch.models import build_slot_model
    from scouter_tpu_torch.utils import model_cost_analysis

    model = build_slot_model(fwd, device="cpu")
    forward = model_cost_analysis(model, torch.zeros(2, 3, 32, 32))["flops"]
    assert row["flops_per_step"] > 2 * forward and row["mfu"] is None


def test_engine_answers_as_the_sequential_loop(tmp_path):
    out = tmp_path / "serve.jsonl"
    assert torch_bench_serve.main(TINY + ["--requests", "6", "--buckets", "1,4",
                                          "--compute_dtype", "float32",
                                          "--out", str(out)]) == 0
    (row,) = records(out)
    assert row["max_abs_logit_diff_vs_sequential"] < 1e-4
    assert sum(int(k.split("/")[1]) * v for k, v in row["bucket_fill"].items()) == 6


def test_load_through_the_http_server(tmp_path):
    out = tmp_path / "load.jsonl"
    assert torch_bench_serve_load.main(TINY + ["--clients", "2", "--requests", "2",
                                               "--buckets", "1,4", "--payload", "png",
                                               "--maps_frac", "0.5",
                                               "--compute_dtype", "float32",
                                               "--out", str(out)]) == 0
    (row,) = records(out)
    assert row["errors"] == 0 and sum(row["n"].values()) == 4
    assert row["engine"]["requests"] == 4 and set(row["latency_ms"]["plain"]) <= {
        "p50", "p90", "p99"}


def test_folder_recipe_with_cmyk_jpegs(tmp_path):
    out = tmp_path / "recipes.jsonl"
    assert recipes.main(["--device", "cpu", "--tiny", "--recipes", "imagenet",
                         "--compute_dtype", "float32", "--out", str(out)]) == 0
    (row,) = records(out)
    assert row["status"] == "OK" and row["tree_jpegs"] == 6


def test_mnist_chain_through_the_clis(tmp_path):
    out = tmp_path / "mnist.jsonl"
    assert torch_run_mnist_recipes.main(
        ["--device", "cpu", "--epochs", "1", "--num_train", "32", "--img_size", "32",
         "--model", "resnet10", "--batch_size", "16", "--output_dir", str(tmp_path / "m"),
         "--out", str(out)]) == 0
    rows = records(out)
    assert [r["step"] for r in rows[:3]] == [name for name, _ in torch_run_mnist_recipes.STEPS]
    assert rows[-1]["pngs"] == 21


def test_ablation_and_pointing_game(tmp_path):
    out = tmp_path / "ablation.jsonl"
    assert torch_bf16_negative_ablation.main(
        ["--device", "cpu", "--epochs", "1", "--num_train", "16", "--img_size", "32",
         "--model", "resnet10", "--batch_size", "16", "--out", str(out)]) == 0
    assert [r["variant"] for r in records(out)] == ["fp32", "bf16+fp32head", "bf16full"]
    out = tmp_path / "pointing.jsonl"
    assert torch_pointing_game_report.main(
        ["--device", "cpu", "--train_steps", "1", "--n_train", "4", "--n_eval", "2",
         "--size", "64", "--rise_masks", "8", "--extremal_iters", "1",
         "--methods", "center,gradient,rise,extremal_perturbation", "--out", str(out),
         "--store", str(tmp_path / "pg.sqlite")]) == 0
    rows = records(out)
    assert [r.get("method") for r in rows[1:]] == ["center", "gradient", "rise",
                                                   "extremal_perturbation"]
    assert all(r["n"] == 2 for r in rows[1:])
    assert os.path.exists(tmp_path / "pg.sqlite")
