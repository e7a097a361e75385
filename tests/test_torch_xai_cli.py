"""The port's comparison CLI (``explain/compare_cli.py``, the torchcam_vis /
captum_vis driver) against the JAX package's on the CPU: every method of the
suite through ``compare_methods`` on 2 classes of resnet10 at 48 px (the
deterministic ones map for map, the random ones on their own draws), the
PNGs against JAX's Pillow/matplotlib rendering of the same maps pixel for
pixel, ``main`` restoring a no-slot checkpoint, and the suite in bf16."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from scouter_tpu.explain.compare_cli import compare_methods as jax_compare_methods
from scouter_tpu.models import create_model as jax_create_model
from scouter_tpu_torch.core import ScouterConfig
from scouter_tpu_torch.core.checkpoint import save_checkpoint
from scouter_tpu_torch.explain import cam, compare_cli
from scouter_tpu_torch.explain.iba import estimate_stats, iba_analyze
from scouter_tpu_torch.models import (build_slot_model, create_model, init_weights,
                                      variables_to_state_dict)
from scouter_tpu_torch.train import create_train_state
from test_torch_models import perturb

SIZE = 48
ALL_METHODS = ["cam", "gradcam", "gradcampp", "smooth_gradcampp", "scorecam", "sscam",
               "isscam", "gradient", "deconvnet", "guided_backprop", "linear_approx", "rise",
               "extremal", "igos", "iba", "deeplift", "excitation"]
# their draws differ between the packages (JAX's keys, the port's generator)
RANDOM_METHODS = {"smooth_gradcampp", "sscam", "rise", "igos", "iba"}
# JAX's run leaves out SS-CAM (random) and IS-CAM, 73 s of its CPU time at
# this size, and the port's runs them at 2 samples; test_torch_xai_cam.py
# holds both to JAX's
JAX_METHODS = [m for m in ALL_METHODS if m not in ("sscam", "isscam")]
CLASSES = [0, 2]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's tests: the suite runs six
    workers on the host's cores, and oversubscribed threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jmodel = jax_create_model("resnet10", num_classes=3)
    image = (np.random.RandomState(0).rand(SIZE, SIZE, 3) * 255).astype(np.uint8)
    variables = perturb(jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3))), 1)
    model = create_model("resnet10", num_classes=3).eval()
    model.load_state_dict(variables_to_state_dict(variables, model.state_dict()))
    jdir = str(tmp_path_factory.mktemp("jax"))
    tdir = str(tmp_path_factory.mktemp("port"))
    want = jax_compare_methods(jmodel, variables, image, CLASSES, jdir, dataset="ImageNet",
                               img_size=SIZE, methods=JAX_METHODS, fast=True)
    timings = {}
    got = compare_cli.compare_methods(model, image, CLASSES, tdir, dataset="ImageNet",
                                      img_size=SIZE, methods=ALL_METHODS, fast=True,
                                      num_samples={"sscam": 2, "isscam": 2}, timings=timings)
    return dict(want=want, got=got, jdir=jdir, tdir=tdir, image=image, model=model,
                timings=timings)


@pytest.mark.parametrize("method", sorted(set(JAX_METHODS) - RANDOM_METHODS))
def test_compare_methods_deterministic_maps_match_jax(runs, method):
    for c in CLASSES:
        got, want = runs["got"][method][c], np.asarray(runs["want"][method][c], np.float32)
        assert got.dtype == np.float32 and got.shape == want.shape
        # the iterative extremal mask at 1e-3, the single-shot maps at 1e-4
        rel = 1e-3 if method == "extremal" else 1e-4
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale, err_msg=f"{method} {c}")


def test_compare_methods_writes_every_map(runs):
    assert set(runs["got"]) == set(ALL_METHODS) == set(runs["timings"])
    for m, per_class in runs["got"].items():
        assert set(per_class) == set(CLASSES)
        for c, sal in per_class.items():
            want = runs["want"].get(m, runs["want"]["cam"])[c]
            assert sal.shape == want.shape and np.isfinite(sal).all(), (m, c)
            assert os.path.exists(os.path.join(runs["tdir"], f"{m}_{c}.png"))


@pytest.mark.parametrize("level", [0.0, 0.3])
def test_rendering_matches_jax_pixel_for_pixel(runs, tmp_path, level):
    """JAX's maps rendered by the port (make_grad chain, Pillow's resize,
    the jet overlay) give JAX's PNGs' pixels."""
    want_maps = {m: {c: np.nan_to_num(np.asarray(s, np.float32)) for c, s in per.items()}
                 for m, per in runs["want"].items()}
    jdir = runs["jdir"]
    if level:
        jdir = str(tmp_path / "jax_level")
        # the JAX driver renders at the end of compare_methods; a gradient
        # run renders its map at this level
        jmodel = jax_create_model("resnet10", num_classes=3)
        variables = perturb(jmodel.init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, SIZE, SIZE, 3))), 1)
        want_maps = {"gradient": {
            c: np.asarray(s, np.float32) for c, s in jax_compare_methods(
                jmodel, variables, runs["image"], CLASSES, jdir, img_size=SIZE,
                methods=["gradient"], grad_min_level=level)["gradient"].items()}}
    out = str(tmp_path / "port")
    paths = compare_cli.render_maps(want_maps, runs["image"], out, grad_min_level=level)
    assert len(paths) == sum(len(v) for v in want_maps.values())
    for path in paths:
        name = os.path.basename(path)
        np.testing.assert_array_equal(np.asarray(Image.open(path)),
                                      np.asarray(Image.open(os.path.join(jdir, name))),
                                      err_msg=name)


def test_rendering_of_a_gray_image(tmp_path):
    image = (np.random.RandomState(3).rand(20, 20, 1) * 255).astype(np.uint8)
    sal = {"gradient": {0: np.random.RandomState(4).rand(5, 5).astype(np.float32)}}
    (path,) = compare_cli.render_maps(sal, image, str(tmp_path))
    assert np.asarray(Image.open(path)).shape == (20, 20, 4)


def test_main_restores_the_no_slot_checkpoint(tmp_path, monkeypatch):
    """``main`` builds the backbone alone and restores the no-slot
    checkpoint of the config, dropping the slot model's nesting."""
    flags = ["--device", "cpu", "--dataset", "ImageNet", "--model", "resnet10",
             "--num_classes", "2", "--img_size", "32", "--pre_trained", "false",
             "--dataset_dir", str(tmp_path / "none"), "--output_dir", str(tmp_path)]
    cfg = ScouterConfig(model="resnet10", dataset="ImageNet", num_classes=2, img_size=32,
                        use_slot=False, pre_trained=False, device="cpu",
                        output_dir=str(tmp_path), seed=3)
    slot_model = build_slot_model(cfg, device="cpu")
    save_checkpoint(str(tmp_path), cfg, create_train_state(slot_model, cfg.lr), epoch=0)
    model, path = compare_cli.build_backbone(cfg.replace(use_slot=True))
    assert path is not None
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, slot_model.state_dict()["backbone." + k], rtol=0, atol=0)
    monkeypatch.chdir(tmp_path)
    got = compare_cli.main(flags + ["--methods", "gradcam,deeplift"])
    assert set(got) == {"gradcam", "deeplift"} and set(got["gradcam"]) == {0, 1}
    assert sorted(os.listdir(tmp_path / "vis_compare")) == [
        "deeplift_0.png", "deeplift_1.png", "gradcam_0.png", "gradcam_1.png"]
    from scouter_tpu_torch.data import select_dataset

    image = select_dataset(cfg, train=False).images[0]
    want = compare_cli.compare_methods(model, image, [1], str(tmp_path / "again"),
                                       img_size=32, methods=["deeplift"])
    np.testing.assert_array_equal(got["deeplift"][1], want["deeplift"][1])


# ------------------------------------------------------------ bf16 (tests/test_bf16_xai.py)

def _corr(a, b):
    a = np.asarray(a, np.float32).ravel() - np.mean(a)
    b = np.asarray(b, np.float32).ravel() - np.mean(b)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9))


@pytest.fixture(scope="module")
def bf16_pair():
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 3, SIZE, SIZE).astype(np.float32))
    m32 = create_model("resnet10", num_classes=3)
    init_weights(m32, torch.Generator().manual_seed(0))
    m16 = create_model("resnet10", num_classes=3, compute_dtype=torch.bfloat16)
    m16.load_state_dict(m32.state_dict())
    return x, m32.eval(), m16.eval()


@pytest.mark.parametrize("method", ["scorecam", "gradcam"])
def test_bf16_maps_track_f32(bf16_pair, method):
    x, m32, m16 = bf16_pair
    # before the min-max, and of a class whose Grad-CAM the ReLU leaves
    # nonzero at this init: a zeroed map is 0/0 after it
    s32 = getattr(cam, method)(m32, x, 2, normalized=False).float().numpy()
    s16 = getattr(cam, method)(m16, x, 2, normalized=False).float().numpy()
    assert np.isfinite(s16).all()
    assert _corr(s32, s16) > 0.95


def test_bf16_iba_is_finite(bf16_pair):
    x, _, m16 = bf16_pair
    features, head, _ = cam.backbone_split(m16)
    batch = torch.from_numpy(np.random.RandomState(1).randn(8, 3, SIZE, SIZE).astype(np.float32))
    stats = estimate_stats(features, [batch, batch])
    assert torch.isfinite(stats.mean).all()
    sal = iba_analyze(features, lambda z: -torch.log_softmax(head(z).float(), dim=1)[:, 0].mean(),
                      x, stats, 4)
    assert torch.isfinite(sal).all()
