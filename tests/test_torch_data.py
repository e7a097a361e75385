"""The port's data layer against the JAX package on the CPU: the synthetic
stand-ins, the IDX reader, the folder scans, ``select_dataset``, the
loader's host batches and device batches over two epochs, and the
augmentation ops applied to given parameters."""

import gzip
import struct

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from scouter_tpu.core import ScouterConfig as JaxConfig
from scouter_tpu.data import ArrayDataset as JaxArrayDataset
from scouter_tpu.data import Loader as JaxLoader
from scouter_tpu.data import folders as jax_folders
from scouter_tpu.data import mnist as jax_mnist
from scouter_tpu.data import select_dataset as jax_select_dataset
from scouter_tpu.data import _synthetic_folder as jax_synthetic_folder
from scouter_tpu.data import transforms as jax_transforms
from scouter_tpu_torch.core import ScouterConfig
from scouter_tpu_torch.data import (ArrayDataset, Loader, _synthetic_folder, folders, mnist,
                                    select_dataset, transforms)


def assert_same_dataset(got, want):
    assert got.dataset_name == want.dataset_name
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.images.dtype == want.images.dtype and got.labels.dtype == want.labels.dtype


# ------------------------------------------------------------------- sources

@pytest.mark.parametrize("num_classes,seed", [(10, 0), (4, 3)])
def test_synthetic_mnist_equals_jax(num_classes, seed):
    got = mnist.synthetic_mnist(num_train=64, num_test=16, seed=seed, num_classes=num_classes)
    want = jax_mnist.synthetic_mnist(num_train=64, num_test=16, seed=seed,
                                     num_classes=num_classes)
    for (gi, gl), (wi, wl) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
    assert got[0][0].shape == (64, 28, 28, 1) and got[0][0].dtype == np.uint8


@pytest.mark.parametrize("train", [True, False])
def test_synthetic_folder_equals_jax(train):
    assert_same_dataset(_synthetic_folder("ImageNet", 5, 24, train),
                        jax_synthetic_folder("ImageNet", 5, 24, train))


def write_idx(path, arr, gz):
    header = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(f">{arr.ndim}I", *arr.shape)
    opener = gzip.open if gz else open
    with opener(str(path) + (".gz" if gz else ""), "wb") as f:
        f.write(header + arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("gz", [False, True])
def test_idx_reader_equals_jax(tmp_path, gz):
    raw = tmp_path / "MNIST" / "raw"
    raw.mkdir(parents=True)
    rng = np.random.RandomState(0)
    write_idx(raw / "t10k-images-idx3-ubyte", rng.randint(0, 256, (7, 28, 28)), gz)
    write_idx(raw / "t10k-labels-idx1-ubyte", rng.randint(0, 10, (7,)), gz)
    got, want = mnist.load_mnist(str(tmp_path), train=False), jax_mnist.load_mnist(
        str(tmp_path), train=False)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    assert got[0].shape == (7, 28, 28, 1)
    with pytest.raises(FileNotFoundError):
        mnist.load_mnist(str(tmp_path), train=True)
    # the loader falls back to the stand-in for the missing split only
    np.testing.assert_array_equal(mnist.mnist_or_synthetic(str(tmp_path), train=False)[0],
                                  got[0])


@pytest.mark.parametrize("dataset,img_size", [("MNIST", 28), ("ImageNet", 16),
                                              ("ConText", 16)])
@pytest.mark.parametrize("train", [True, False])
def test_select_dataset_equals_jax_without_files(tmp_path, dataset, img_size, train):
    root = tmp_path / "data"
    if dataset == "ConText":
        # the ConText scan splits what it finds; with nothing on disk both
        # packages refuse the empty split
        root.mkdir()
        with pytest.raises(ValueError):
            select_dataset(ScouterConfig(dataset=dataset, dataset_dir=str(root)), train)
        with pytest.raises(ValueError):
            jax_select_dataset(JaxConfig(dataset=dataset, dataset_dir=str(root)), train)
        return
    kw = dict(dataset=dataset, num_classes=3, img_size=img_size, dataset_dir=str(root))
    assert_same_dataset(select_dataset(ScouterConfig(**kw), train),
                        jax_select_dataset(JaxConfig(**kw), train))


def make_imagenet_tree(root, classes=4, per_class=3):
    for phase in ("train", "val"):
        for c in range(classes):
            d = root / phase / f"n{c:08d}"
            d.mkdir(parents=True)
            for i in range(per_class if phase == "train" else 1):
                (d / f"img_{i}.JPEG").write_bytes(b"")


def test_folder_scans_equal_jax(tmp_path):
    make_imagenet_tree(tmp_path / "imagenet")
    assert folders.scan_imagenet_subset(str(tmp_path / "imagenet"), 3) == \
        jax_folders.scan_imagenet_subset(str(tmp_path / "imagenet"), 3)

    ctx = tmp_path / "context"
    ctx.mkdir()
    rng = np.random.RandomState(0)
    for i in range(37):
        (ctx / f"{['bakery', 'cafe', 'pizzeria'][rng.randint(3)]}_{i:03d}.jpg").write_bytes(b"")
    got, want = folders.scan_context(str(ctx)), jax_folders.scan_context(str(ctx))
    assert [list(map(tuple, part)) for part in got] == [list(map(tuple, p)) for p in want]

    cub = tmp_path / "cub"
    cub.mkdir()
    names = [f"{c:03d}.Bird_{c}/Bird_{c}_{i}.jpg" for c in (1, 2, 3, 5) for i in range(3)]
    (cub / "images.txt").write_text("".join(f"{i + 1} {n}\n" for i, n in enumerate(names)))
    (cub / "image_class_labels.txt").write_text(
        "".join(f"{i + 1} {int(n[:3])}\n" for i, n in enumerate(names)))
    (cub / "train_test_split.txt").write_text(
        "".join(f"{i + 1} {i % 2}\n" for i in range(len(names))))
    for num_classes in (2, 4):
        assert folders.scan_cub200(str(cub), num_classes) == \
            jax_folders.scan_cub200(str(cub), num_classes)


def test_select_dataset_refuses_images_on_disk(tmp_path):
    # images on disk are read now, through a FolderDataset on cfg.device:
    # the card by default, which a host without CUDA refuses
    from scouter_tpu_torch.data import FolderDataset

    make_imagenet_tree(tmp_path)
    cfg = ScouterConfig(dataset="ImageNet", num_classes=3, img_size=16,
                        dataset_dir=str(tmp_path))
    ds = select_dataset(cfg.replace(device="cpu"), train=True)
    assert isinstance(ds, FolderDataset) and len(ds) == 9
    assert ds.items == jax_select_dataset(JaxConfig(dataset="ImageNet", num_classes=3,
                                                    img_size=16, dataset_dir=str(tmp_path)),
                                          train=True).items
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            select_dataset(cfg, train=True)


# -------------------------------------------------------------------- loader

def small_dataset(n=23, size=12, seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (n, size, size, 3)).astype(np.uint8)
    return images, rng.randint(0, 4, n).astype(np.int32)


@pytest.mark.parametrize("train", [True, False])
def test_loader_host_batches_equal_jax_for_two_epochs(train):
    images, labels = small_dataset()
    ours = Loader(ArrayDataset(images, labels, "ImageNet"), 5, img_size=12, train=train,
                  seed=3, device="cpu")
    theirs = JaxLoader(JaxArrayDataset(images, labels, "ImageNet"), 5, img_size=12,
                       train=train, seed=3)
    assert ours.steps_per_epoch() == theirs.steps_per_epoch() == (4 if train else 5)
    for epoch in (0, 1):
        got, want = list(ours._host_batches(epoch)), list(theirs._host_batches(epoch))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for key in ("image", "label", "mask"):
                np.testing.assert_array_equal(g[key], w[key])
    if train:  # each epoch has its own order
        assert not np.array_equal(ours._epoch_indices(0), ours._epoch_indices(1))


def test_loader_device_batches_equal_jax():
    images, labels = small_dataset(n=13, size=20)
    ours = Loader(ArrayDataset(images, labels, "ImageNet"), 4, img_size=16, train=False,
                  device="cpu")
    theirs = JaxLoader(JaxArrayDataset(images, labels, "ImageNet"), 4, img_size=16,
                       train=False)
    got, want = list(ours.epoch(0)), list(theirs.epoch(0))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g["image"].shape == (4, 3, 16, 16) and g["label"].dtype == torch.int64
        np.testing.assert_allclose(g["image"].numpy().transpose(0, 2, 3, 1),
                                   np.asarray(w["image"]), rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(g["label"].numpy(), np.asarray(w["label"]))
        np.testing.assert_array_equal(g["mask"].numpy(), np.asarray(w["mask"]))
    assert got[-1]["mask"].tolist() == [1.0, 0.0, 0.0, 0.0]


def test_loader_augments_train_batches_deterministically():
    images, labels = small_dataset(n=8, size=24)
    ds = ArrayDataset(images, labels, "ImageNet")
    aug = Loader(ds, 4, img_size=24, train=True, aug=True, seed=1, device="cpu")
    plain = Loader(ds, 4, img_size=24, train=True, aug=False, seed=1, device="cpu")
    a1, a2 = list(aug.epoch(0)), list(aug.epoch(0))
    p = list(plain.epoch(0))
    for x, y, z in zip(a1, a2, p):
        torch.testing.assert_close(x["image"], y["image"], rtol=0, atol=0)
        assert torch.isfinite(x["image"]).all()
        np.testing.assert_array_equal(x["label"].numpy(), z["label"].numpy())
    assert any(not torch.equal(x["image"], z["image"]) for x, z in zip(a1, p))


def test_loader_raises_without_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for hosts without one")
    images, labels = small_dataset(n=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        Loader(ArrayDataset(images, labels, "ImageNet"), 2, img_size=12, train=True)


# -------------------------------------------------------------- augmentation

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_augs_equals_jax(seed):
    rng = np.random.RandomState(seed)
    b, h, w = 6, 22, 19
    images = (rng.rand(b, h, w, 3) * 255).astype(np.float32)
    gates = rng.rand(b, 4) < 0.7
    params = np.stack([rng.uniform(0.8, 1.0, b), rng.uniform(0.8, 1.0, b),
                       rng.uniform(0.0, 0.1, b), rng.uniform(-0.1, 0.1, b),
                       rng.randint(-10, 10, b), rng.uniform(0.0, 3.0, b)], 1).astype(np.float32)
    order = np.stack([rng.permutation(4) for _ in range(b)])
    got = transforms._apply_augs(torch.from_numpy(images), torch.from_numpy(gates),
                                 torch.from_numpy(params), torch.from_numpy(order)).numpy()
    for i in range(b):
        want = jax_transforms._apply_augs(
            jnp.asarray(images[i]), tuple(bool(g) for g in gates[i]),
            tuple(jnp.float32(p) for p in params[i]), order[i])
        np.testing.assert_allclose(got[i], np.asarray(want), rtol=0, atol=1e-3)


@pytest.mark.parametrize("op", range(4))
def test_each_aug_op_equals_jax(op):
    rng = np.random.RandomState(10 + op)
    images = (rng.rand(3, 17, 23, 3) * 255).astype(np.float32)
    params = np.array([[0.85, 0.95, 0.05, -0.07, -9.0, 2.5], [1.0, 1.0, 0.0, 0.0, 0.0, 0.0],
                       [0.8, 0.8, 0.1, 0.1, 9.0, 0.3]], np.float32)
    gates = np.zeros((3, 4), bool)
    gates[:, op] = True
    order = np.tile(np.arange(4), (3, 1))
    got = transforms._apply_augs(torch.from_numpy(images), torch.from_numpy(gates),
                                 torch.from_numpy(params), torch.from_numpy(order)).numpy()
    for i in range(3):
        want = jax_transforms._apply_augs(jnp.asarray(images[i]), tuple(gates[i]),
                                          tuple(jnp.float32(p) for p in params[i]), order[i])
        np.testing.assert_allclose(got[i], np.asarray(want), rtol=0, atol=1e-3)


def test_aug_parameters_follow_imgaug_ranges():
    gates, params, order = transforms.draw_aug_params(4096, torch.Generator().manual_seed(0))
    assert 0.45 < gates.float().mean() < 0.55
    sx, sy, tx, ty, rot, sigma = params.T
    for v, lo, hi in ((sx, 0.8, 1.0), (sy, 0.8, 1.0), (tx, 0.0, 0.1), (ty, -0.1, 0.1),
                      (sigma, 0.0, 3.0)):
        assert lo <= v.min() and v.max() <= hi
    assert set(rot.tolist()) == set(float(r) for r in range(-10, 10))
    assert (order.sort(dim=1).values == torch.arange(4)).all()


def test_preprocess_train_without_aug_is_the_eval_transform():
    images = torch.from_numpy(small_dataset(n=2, size=20)[0])
    a = transforms.preprocess_batch(images, dataset="ImageNet", img_size=16, train=True)
    b = transforms.preprocess_batch(images, dataset="ImageNet", img_size=16)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
