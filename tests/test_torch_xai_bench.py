"""The port's pointing-game benchmark stack against the JAX package on the
CPU: the bilinear resize helper against ``jax.image.resize``, the caffe
VGG16/ResNet50 (``explain/benchmark_models.py``) from one checkpoint fed to
both packages' converters, ``get_transform``, the VOC/COCO adapters and the
polygon fill against matplotlib's, the pointing game and its sqlite store
(``run_pointing_benchmark``: hits and stored rows equal), the image
utilities and the IoU helpers."""

import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from scouter_tpu.explain import benchmark as jax_benchmark
from scouter_tpu.explain import benchmark_models as jax_bm
from scouter_tpu.explain import datasets as jax_datasets
from scouter_tpu.explain import image_utils as jax_image_utils
from scouter_tpu.explain import parity as jax_parity
from scouter_tpu.explain import pointing_game as jax_pg
from scouter_tpu_torch.explain import benchmark, benchmark_models, datasets, image_utils
from scouter_tpu_torch.explain import parity, pointing_game
from scouter_tpu_torch.explain._resize import resize_bilinear
from test_torch_xai_cam import assert_map_close


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's tests: the suite runs six
    workers on the host's cores, and oversubscribed threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ the resize helper

RESIZES = [((7, 9), (260, 255)), ((9, 9), (387, 387)), ((260, 260), (9, 9)),
           ((13, 5), (6, 11)), ((2, 2), (48, 48)), ((64, 48), (31, 97)), ((1, 5), (3, 5)),
           ((225, 300), (224, 298))]


@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_matches_jax_image_resize(src, dst):
    x = np.random.RandomState(0).randn(2, *src).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, *dst), "bilinear")
    assert_map_close(resize_bilinear(torch.from_numpy(x), dst), want, rel=1e-5)


# ------------------------------------------------------------ caffe models

def caffe_checkpoint(module, arch):
    """The port module's weights in the caffe dump's layout: VGG classifier
    indices around the dropouts, BN and downsample entries with an extra
    index, the first conv BGR (tests/test_benchmark_models.py's layout)."""
    import re

    ckpt = {}
    for k, v in module.state_dict().items():
        if "num_batches_tracked" in k:
            continue
        if arch == "vgg16":
            k = k.replace("classifier.3.", "classifier.2.").replace("classifier.6.",
                                                                    "classifier.4.")
        else:
            m = re.match(r"(.*(?:bn\d|downsample\.\d))\.(weight|bias|running_mean|running_var)$", k)
            if m:
                idx = "0" if m.group(2) in ("weight", "bias") else "1"
                k = f"{m.group(1)}.{idx}.{m.group(2)}"
        ckpt[k] = v.clone()
    first = "features.0.weight" if arch == "vgg16" else "conv1.weight"
    ckpt[first] = ckpt[first][:, [2, 1, 0]]
    return ckpt


def randomise_bn(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.5, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.weight.normal_(0.5, 1.0, generator=g)  # mixed signs for the fold
                m.bias.normal_(0, 0.1, generator=g)


@pytest.fixture(scope="module")
def vgg(tmp_path_factory):
    src, _ = benchmark_models.get_model("vgg16", "voc", device="cpu", seed=1)
    path = tmp_path_factory.mktemp("vgg") / "vgg16_voc.pth.tar"
    torch.save(caffe_checkpoint(src, "vgg16"), str(path))
    return str(path)


def test_caffe_vgg16_matches_jax(vgg):
    model, sd = benchmark_models.get_model("vgg16", "voc_2007", weights_path=vgg, device="cpu")
    assert sd is not None and model.num_classes == 20
    variables = jax_bm.convert_caffe_checkpoint("vgg16", torch.load(vgg, weights_only=False))
    x = np.random.RandomState(1).randn(1, 224, 224, 3).astype(np.float32)
    want = np.asarray(jax_bm.CaffeVGG16(num_classes=20).apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    assert_map_close(got, want)
    fc_model, _ = benchmark_models.get_model("vgg16", "voc", weights_path=vgg, device="cpu",
                                             convert_to_fully_convolutional=True)
    with torch.no_grad():
        fc = fc_model(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    assert fc.shape == (1, 1, 1, 20)
    assert_map_close(fc.reshape(1, 20), want)
    with torch.no_grad():
        spatial = fc_model(torch.zeros(1, 3, 288, 288))
    assert spatial.shape[-1] == 20 and spatial.shape[1] > 1


@pytest.fixture(scope="module")
def resnet_ckpt():
    src = benchmark_models.CaffeResNet50(num_classes=20)
    from scouter_tpu_torch.models import init_weights

    init_weights(src, torch.Generator().manual_seed(2))
    randomise_bn(src, 3)
    return caffe_checkpoint(src, "resnet50")


@pytest.mark.parametrize("fold", [False, True])
def test_caffe_resnet50_matches_jax(resnet_ckpt, fold):
    sd = benchmark_models.convert_caffe_checkpoint("resnet50", resnet_ckpt, make_bn_positive=fold)
    model = benchmark_models.CaffeResNet50(num_classes=20).eval()
    model.load_state_dict(sd)
    if fold:
        assert all((m.weight >= 0).all() for m in model.modules()
                   if isinstance(m, torch.nn.BatchNorm2d))
    variables = jax_bm.convert_caffe_checkpoint("resnet50", resnet_ckpt, make_bn_positive=fold)
    # an odd size exercises the ceil-mode stem pool without padding
    x = np.random.RandomState(3).randn(1, 225, 225, 3).astype(np.float32)
    jmodel = jax_bm.CaffeResNet50(num_classes=20)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2))
    with torch.no_grad():
        assert_map_close(model(xt), want)
        mid = model(xt, stop_after="layer3")
        assert_map_close(model(mid, start_from="layer3"), want, rel=1e-5)
    fc = benchmark_models.CaffeResNet50(num_classes=20, fully_conv=True).eval()
    fc.load_state_dict(sd)
    with torch.no_grad():
        assert_map_close(fc(xt).reshape(1, 20), want)


def test_get_model_refuses_other_datasets_and_archs():
    model, sd = benchmark_models.get_model("resnet50", "coco_2014", device="cpu")
    assert model.num_classes == 80 and sd is None
    with pytest.raises(ValueError):
        benchmark_models.get_model("vgg16", "cifar", device="cpu")
    with pytest.raises(ValueError):
        benchmark_models.get_model("alexnet", "voc", device="cpu")


@pytest.mark.parametrize("dataset,size,shape", [("voc", 8, (8, 8, 3)), ("voc", 24, (13, 20, 3)),
                                                ("imagenet", 16, (40, 64, 3)),
                                                ("coco", (10, 12), (31, 17, 3))])
def test_get_transform_matches_jax(dataset, size, shape):
    img = np.random.RandomState(4).rand(*shape).astype(np.float32)
    want = jax_bm.get_transform(dataset, size=size)(img)
    got = benchmark_models.get_transform(dataset, size=size)(img)
    assert_map_close(got, want, rel=1e-5)


# ------------------------------------------------------------ datasets

def write_voc(root, images):
    """A VOC-like tree: Annotations/*.xml, JPEGImages, ImageSets/Main/test.txt."""
    for d in ("Annotations", "JPEGImages", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    with open(os.path.join(root, "ImageSets", "Main", "test.txt"), "w") as f:
        f.write("\n".join(images) + "\n")
    rng = np.random.RandomState(5)
    for n, name in enumerate(images):
        objs = []
        for k in range(1 + n % 3):
            x0, y0 = rng.randint(1, 30, 2)
            objs.append(f"<object><name>{datasets.VOC_CLASSES[(n + 7 * k) % 20]}</name>"
                        f"<difficult>{k % 2}</difficult><bndbox><xmin>{x0}</xmin>"
                        f"<ymin>{y0}</ymin><xmax>{x0 + 12}</xmax><ymax>{y0 + 9}</ymax>"
                        "</bndbox></object>")
        with open(os.path.join(root, "Annotations", name + ".xml"), "w") as f:
            f.write(f"<annotation><size><width>40</width><height>36</height></size>"
                    f"{''.join(objs)}</annotation>")


def test_voc_dataset_matches_jax(tmp_path):
    write_voc(str(tmp_path), [f"{i:06d}" for i in range(5)])
    want = list(jax_datasets.voc_dataset(str(tmp_path)))
    got = list(datasets.voc_dataset(str(tmp_path)))
    assert len(got) == len(want) > 5
    for (p1, c1, m1), (p2, c2, m2) in zip(got, want):
        assert (p1, c1) == (p2, c2)
        np.testing.assert_array_equal(m1, m2)
    xml = os.path.join(str(tmp_path), "Annotations", "000001.xml")
    for name in datasets.VOC_CLASSES:
        a = datasets.voc_annotation_to_mask(xml, name, include_difficult=False)
        b = jax_datasets.voc_annotation_to_mask(xml, name, include_difficult=False)
        assert (a is None) == (b is None) and (a is None or np.array_equal(a, b))


POLYGONS = {
    "convex": [(2, 2), (10, 2), (10, 10), (2, 10)],
    "triangle": [(0, 0), (15, 3), (4, 14)],
    "concave": [(1, 1), (14, 1), (14, 14), (8, 5), (1, 14)],
    "edge-on-centres": [(0.5, 0.5), (8.5, 0.5), (8.5, 8.5), (0.5, 8.5)],
    "diagonal-through-centres": [(0.5, 0.5), (10.5, 10.5), (0.5, 10.5)],
    "self-touching": [(0, 0), (8, 0), (4, 4), (8, 8), (0, 8), (4, 4)],
    "bow-tie": [(0, 0), (10, 10), (10, 0), (0, 10)],
    "off-image": [(-5, -3), (30, 2), (12, 40)],
    "float": [(1.3, 2.7), (12.9, 3.1), (7.5, 13.5), (3.2, 9.9)],
}


@pytest.mark.parametrize("name", sorted(POLYGONS))
def test_polygon_fill_matches_matplotlib(name):
    pts = np.asarray(POLYGONS[name], np.float32)
    want = np.zeros((16, 16), np.uint8)
    got = want.copy()
    jax_datasets._fill_polygon(want, pts[:, 0], pts[:, 1])
    datasets._fill_polygon(got, pts[:, 0], pts[:, 1])
    np.testing.assert_array_equal(got, want)


def test_coco_dataset_matches_jax(tmp_path):
    import json

    rng = np.random.RandomState(6)
    anns = []
    for i in range(12):
        poly = (rng.rand(rng.randint(3, 8), 2) * 30).round(rng.randint(0, 2)).ravel().tolist()
        ann = {"image_id": i % 4, "category_id": 1 + i % 3}
        ann.update({"segmentation": [poly]} if i % 4 else {"bbox": [3, 4, 10, 6]})
        anns.append(ann)
    coco = {"images": [{"id": i, "file_name": f"{i}.jpg", "height": 32, "width": 30}
                       for i in range(4)],
            "annotations": anns, "categories": [{"id": c} for c in (1, 2, 3)]}
    path = str(tmp_path / "instances.json")
    with open(path, "w") as f:
        json.dump(coco, f)
    want = list(jax_datasets.coco_dataset(str(tmp_path), path))
    got = list(datasets.coco_dataset(str(tmp_path), path))
    assert len(got) == len(want) > 4
    for (p1, c1, m1), (p2, c2, m2) in zip(got, want):
        assert (p1, c1) == (p2, c2)
        np.testing.assert_array_equal(m1, m2)


# ------------------------------------------------------------ the pointing game

def test_pointing_game_and_store_match_jax(tmp_path):
    rng = np.random.RandomState(7)
    items = []
    for i in range(6):
        mask = np.zeros((20, 24), np.uint8)
        y0, x0 = rng.randint(0, 14, 2)
        mask[y0:y0 + 5, x0:x0 + 6] = 1
        items.append((None, int(rng.randint(0, 4)), mask))
    maps = [rng.rand(10, 12).astype(np.float32) for _ in items]
    seq = iter(range(len(items)))

    def saliency(image, c, maps=maps):
        return maps[next(seq)]

    store = benchmark.ExperimentStore(str(tmp_path / "port.db"))
    got = benchmark.run_pointing_benchmark(
        lambda im, c: torch.from_numpy(saliency(im, c)), items, 4, store=store, series="s")
    seq = iter(range(len(items)))
    jstore = jax_benchmark.ExperimentStore(str(tmp_path / "jax.db"))
    want = jax_benchmark.run_pointing_benchmark(saliency, items, 4, store=jstore, series="s")
    np.testing.assert_array_equal(got.hits, want.hits)
    np.testing.assert_array_equal(got.misses, want.misses)
    assert str(got) == str(want)
    keys = store.keys("s", "pointing")
    assert keys == jstore.keys("s", "pointing") and len(keys) == len(items)
    for k in keys:
        assert store.load("s", "pointing", k) == jstore.load("s", "pointing", k)
    with pytest.raises(ValueError):
        benchmark.run_pointing_benchmark(lambda im, c: np.zeros((2, 3, 4)), items, 4)


def test_pointing_game_benchmark_gating(tmp_path):
    path = str(tmp_path / "flags.txt")
    with open(path, "w") as f:
        f.write("a\t1\t0\nb\t0\t1\n")
    flags = pointing_game.load_difficult_flags(path)
    assert flags == jax_pg.load_difficult_flags(path)
    mask = np.zeros((9, 9), np.uint8)
    mask[4, 4] = 1
    game = pointing_game.PointingGameBenchmark(2, tolerance=2, difficult_flags=flags)
    jgame = jax_pg.PointingGameBenchmark(2, tolerance=2, difficult_flags=flags)
    for args in (("a", 1, mask, (4, 4)), ("a", 0, mask, (4, 4)), ("b", 1, mask, (0, 0)),
                 ("c", 0, None, (4, 4)), ("c", 1, mask, (5, 5), True)):
        assert game.evaluate_item(*args) == jgame.evaluate_item(*args)
    assert pointing_game.saliency_point(np.eye(3)[::-1]) == jax_pg.saliency_point(np.eye(3)[::-1])


# ------------------------------------------------------------ image utilities

def test_imread_resample_imsc_and_rc(tmp_path):
    from scouter_tpu_torch.core.png import write_png

    rng = np.random.RandomState(8)
    rgb = rng.randint(0, 256, (17, 23, 3)).astype(np.uint8)
    path = str(tmp_path / "a.png")
    write_png(path, rgb)
    for resize in (None, (11, 9)):
        want = jax_image_utils.imread(path, resize=resize)
        got = image_utils.imread(path, resize=resize, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG", quality=90)
    jpg = str(tmp_path / "a.jpg")
    with open(jpg, "wb") as f:
        f.write(buf.getvalue())
    np.testing.assert_array_equal(image_utils.imread(jpg, device="cpu").numpy(),
                                  jax_image_utils.imread(jpg))
    img = rng.rand(13, 9, 3).astype(np.float32)
    assert_map_close(image_utils.resample(img, (5, 20)), jax_image_utils.resample(img, (5, 20)),
                     rel=1e-5)
    assert_map_close(image_utils.resample(img[..., 0], (26, 4)),
                     jax_image_utils.resample(img[..., 0], (26, 4)), rel=1e-5)
    for lim in (None, (0.2, 0.6)):
        np.testing.assert_allclose(image_utils.imsc(img * 3 - 1, lim).numpy(),
                                   jax_image_utils.imsc(img * 3 - 1, lim), rtol=1e-6, atol=1e-6)
    rc = str(tmp_path / "rc.json")
    with open(rc, "w") as f:
        f.write('{"benchmark": {"voc_dir": "/x"}, "extra": 1}')
    assert image_utils.read_rc_config(rc) == jax_image_utils.read_rc_config(rc)


def test_parity_helpers_match_jax():
    rng = np.random.RandomState(9)
    m = rng.randint(0, 256, (9, 9)).astype(np.uint8)
    np.testing.assert_array_equal(parity.resize_map_bilinear(m, (31, 20)),
                                  jax_parity.resize_map_bilinear(m, (31, 20)))
    ref = [rng.randint(0, 256, (7, 7)).astype(np.uint8) for _ in range(3)]
    ours = [rng.randint(0, 256, (7, 7)).astype(np.uint8) for _ in range(3)]
    table = parity.iou_table(ref, ours)
    assert table == jax_parity.iou_table(ref, ours)
    assert parity.format_iou_table(table) == jax_parity.format_iou_table(table)
