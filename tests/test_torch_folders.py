"""The port's image reading against the JAX package and Pillow on the CPU:
the PNG reader, the committed fixtures, ``load_image_list``, the streaming
``FolderDataset`` and its cache, ``select_dataset`` on trees of images, the
Loader over a folder dataset, the host stager, and the server's decode of
PNG and JPEG bodies. Every comparison is bit for bit."""

import io
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from scouter_tpu.core import ScouterConfig as JaxConfig
from scouter_tpu.data import FolderDataset as JaxFolderDataset
from scouter_tpu.data import Loader as JaxLoader
from scouter_tpu.data import load_image_list as jax_load_image_list
from scouter_tpu.data import native_stager as jax_stager
from scouter_tpu.data import select_dataset as jax_select_dataset
from scouter_tpu.serve.server import _decode_image as jax_decode_image
from scouter_tpu_torch.core import ScouterConfig
from scouter_tpu_torch.core.png import decode_png, read_png
from scouter_tpu_torch.data import (FolderDataset, Loader, load_image_list, native_stager,
                                    select_dataset)
from scouter_tpu_torch.serve.server import _decode_image

FIXTURES = Path(__file__).resolve().parent / "torch_fixtures"
JPEGS = ("rgb420_500x375.jpg", "rgb444_375x500.jpg", "progressive_500x333.jpg",
         "gray_500x375.jpg")
PNGS = ("rgb_filters_300x200.png", "palette_trns_240x180.png", "gray_alpha_200x150.png",
        "rgba_220x160.png")


def pil_convert(data: bytes, mode: str) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert(mode))


# ----------------------------------------------------------------- fixtures

def test_fixtures_staged_pixels_are_pillows():
    """``staged_260.npz`` is Pillow's staged 260 px of each JPEG fixture,
    the pixels that nvJPEG's decode is held to on the card."""
    staged = np.load(FIXTURES / "staged_260.npz")
    assert sorted(staged.files) == sorted(JPEGS)
    for name in JPEGS:
        with Image.open(FIXTURES / name) as im:
            want = np.asarray(im.convert("RGB").resize((260, 260), Image.BILINEAR))
        np.testing.assert_array_equal(staged[name], want, err_msg=name)
    total = sum(p.stat().st_size for p in FIXTURES.iterdir())
    assert total < 2 << 20


def test_fixture_png_uses_all_five_filters():
    data = (FIXTURES / PNGS[0]).read_bytes()
    idat = zlib.decompress(data[data.index(b"IDAT") + 4:data.index(b"IEND") - 8])
    w, h = struct.unpack(">II", data[16:24])
    rows = np.frombuffer(idat, np.uint8).reshape(h, 1 + 3 * w)
    assert sorted(set(rows[:, 0].tolist())) == [0, 1, 2, 3, 4]


# --------------------------------------------------------------- PNG reader

@pytest.mark.parametrize("mode", ["RGB", "L"])
@pytest.mark.parametrize("name", PNGS)
def test_read_png_equals_pillow_on_fixtures(name, mode):
    np.testing.assert_array_equal(read_png(str(FIXTURES / name), mode),
                                  pil_convert((FIXTURES / name).read_bytes(), mode))


def _pillow_png(kind: str) -> bytes:
    rng = np.random.RandomState(3)
    yy, xx = np.mgrid[0:23, 0:37]
    smooth = np.stack([xx * 7, yy * 11, (xx + yy) * 5], -1) % 256
    rgb = (smooth + rng.randint(0, 9, smooth.shape)).astype(np.uint8)
    im = {
        "rgb": lambda: Image.fromarray(rgb),
        "rgba": lambda: Image.fromarray(np.dstack([rgb, rgb[..., 1]]), "RGBA"),
        "gray": lambda: Image.fromarray(rgb[..., 0]),
        "gray_alpha": lambda: Image.fromarray(rgb).convert("LA"),
        "bilevel": lambda: Image.fromarray(rgb[..., 0] > 120),
        "palette_2bit": lambda: Image.fromarray(rgb).quantize(4),
        "palette_4bit": lambda: Image.fromarray(rgb).quantize(16),
        "palette_8bit": lambda: Image.fromarray(rgb).quantize(100),
    }[kind]()
    buf = io.BytesIO()
    im.save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("mode", ["RGB", "L"])
@pytest.mark.parametrize("kind", ["rgb", "rgba", "gray", "gray_alpha", "bilevel",
                                  "palette_2bit", "palette_4bit", "palette_8bit"])
def test_read_png_equals_pillow_on_pngs_pillow_writes(tmp_path, kind, mode):
    data = _pillow_png(kind)
    path = tmp_path / "x.png"
    path.write_bytes(data)
    np.testing.assert_array_equal(read_png(str(path), mode), pil_convert(data, mode))


def _interlaced(data: bytes) -> bytes:
    """The PNG with IHDR's interlace method set to Adam7, CRC redone."""
    body = data[16:28] + b"\x01"
    crc = struct.pack(">I", zlib.crc32(b"IHDR" + body) & 0xFFFFFFFF)
    return data[:16] + body + crc + data[33:]


def test_read_png_refuses_interlace_and_16_bit(tmp_path):
    data = _pillow_png("rgb")
    with pytest.raises(ValueError, match="interlace"):
        decode_png(_interlaced(data))
    path = tmp_path / "deep.png"
    Image.fromarray(np.arange(600, dtype=np.uint16).reshape(20, 30) * 100).save(path)
    with Image.open(path) as im:
        assert im.mode.startswith("I")
    with pytest.raises(ValueError, match="16-bit"):
        read_png(str(path))
    with pytest.raises(ValueError, match="CRC"):
        decode_png(data[:20] + bytes([data[20] ^ 1]) + data[21:])


# --------------------------------------------------------- folders, dataset

def write_tree(root: Path, kinds=("png", "jpg"), per_kind=5, seed=0):
    """Images of assorted sizes and modes for a flat ConText directory:
    names ``<class>_<i>.<ext>``. Returns the (path, label) items."""
    rng = np.random.RandomState(seed)
    root.mkdir(parents=True, exist_ok=True)
    items = []
    for k, ext in enumerate(kinds):
        for i in range(per_kind):
            h, w = 20 + 7 * i, 31 - 2 * i
            arr = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            im = Image.fromarray(arr)
            if i % 3 == 1:
                im = im.convert("L")
            elif i % 3 == 2 and ext == "png":
                im = im.convert("RGBA")
            path = root / f"{['bakery', 'cafe'][i % 2]}_{k}{i}.{ext}"
            im.save(path, quality=90) if ext == "jpg" else im.save(path)
            items.append((str(path), i % 2))
    return items


@pytest.mark.parametrize("ext", ["png", "jpg"])
def test_load_image_list_equals_jax(tmp_path, ext):
    items = write_tree(tmp_path, kinds=(ext,))
    got, got_labels = load_image_list(items, 16, device="cpu")
    want, want_labels = jax_load_image_list(items, 16)
    assert got.dtype == torch.uint8 and got.shape == (len(items), 16, 16, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_labels, want_labels)


def test_folder_dataset_gather_equals_jax(tmp_path):
    items = write_tree(tmp_path)
    ours = FolderDataset(items, 24, "ConText", device="cpu")
    theirs = JaxFolderDataset(items, 24, "ConText")
    for idx in ([0, 3, 7, 9], [9, 9, 1], list(range(len(items)))):
        got = ours.gather(idx)
        assert got.device.type == "cpu" and got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), theirs.gather(idx))
    np.testing.assert_array_equal(ours.labels, theirs.labels)


def test_folder_dataset_cache_is_byte_bounded(tmp_path):
    items = write_tree(tmp_path)
    item_bytes = 16 * 16 * 3
    ds = FolderDataset(items, 16, "ConText", cache_bytes=3 * item_bytes, device="cpu")
    fresh = ds.gather(np.arange(len(items)))
    assert ds.cached_bytes == 3 * item_bytes
    cached = ds.gather([0, 1, 2])  # served from the cache
    torch.testing.assert_close(cached, fresh[:3], rtol=0, atol=0)
    uncached = FolderDataset(items, 16, "ConText", cache_bytes=0, device="cpu")
    torch.testing.assert_close(uncached.gather([0, 1, 2]), cached, rtol=0, atol=0)
    assert uncached.cached_bytes == 0


def test_folder_dataset_images_view_equals_eager(tmp_path):
    items = write_tree(tmp_path)
    eager, _ = load_image_list(items, 16, device="cpu")
    ds = FolderDataset(items, 16, "ConText", device="cpu")
    assert len(ds.images) == len(eager)
    torch.testing.assert_close(ds.images[5], eager[5], rtol=0, atol=0)
    torch.testing.assert_close(ds.images[2:7], eager[2:7], rtol=0, atol=0)
    sel = np.array([1, 9, 4])
    torch.testing.assert_close(ds.images[sel], eager[sel], rtol=0, atol=0)


def _imagenet_tree(root):
    rng = np.random.RandomState(1)
    for phase, n in (("train", 3), ("val", 2)):
        for c in range(3):
            d = root / phase / f"n{c:08d}"
            d.mkdir(parents=True)
            for i in range(n):
                Image.fromarray(rng.randint(0, 256, (18, 22, 3)).astype(np.uint8)).save(
                    d / f"img_{i}.JPEG", format="JPEG")


def _cub_tree(root):
    rng = np.random.RandomState(2)
    names = [f"{c:03d}.Bird_{c}/Bird_{c}_{i}.{'jpg' if i % 2 else 'png'}"
             for c in (1, 2, 3) for i in range(3)]
    for n in names:
        (root / "images" / n).parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.randint(0, 256, (19, 25, 3)).astype(np.uint8)).save(
            root / "images" / n)
    (root / "images.txt").write_text("".join(f"{i + 1} {n}\n" for i, n in enumerate(names)))
    (root / "image_class_labels.txt").write_text(
        "".join(f"{i + 1} {int(n[:3])}\n" for i, n in enumerate(names)))
    (root / "train_test_split.txt").write_text(
        "".join(f"{i + 1} {int(i % 3 != 0)}\n" for i in range(len(names))))


@pytest.mark.parametrize("dataset,make", [("ConText", write_tree),
                                          ("ImageNet", _imagenet_tree),
                                          ("CUB200", _cub_tree)])
def test_select_dataset_returns_a_folder_dataset(tmp_path, dataset, make):
    make(tmp_path)
    kw = dict(dataset=dataset, dataset_dir=str(tmp_path), num_classes=3, img_size=16)
    for train in (True, False):
        ours = select_dataset(ScouterConfig(device="cpu", **kw), train=train)
        theirs = jax_select_dataset(JaxConfig(**kw), train=train)
        assert isinstance(ours, FolderDataset) and ours.device.type == "cpu"
        assert ours.items == theirs.items and ours.dataset_name == dataset
        np.testing.assert_array_equal(ours.gather(np.arange(len(ours))).numpy(),
                                      theirs.gather(np.arange(len(theirs))))


@pytest.mark.parametrize("train", [True, False])
def test_loader_over_folder_dataset_equals_jax(tmp_path, train):
    items = write_tree(tmp_path, per_kind=7)
    ours = Loader(FolderDataset(items, 16, "ConText", device="cpu"), 4, img_size=16,
                  train=train, seed=5, device="cpu")
    theirs = JaxLoader(JaxFolderDataset(items, 16, "ConText"), 4, img_size=16, train=train,
                       seed=5, shard_by_host=False)
    for epoch in (0, 1):
        got, want = list(ours._host_batches(epoch)), list(theirs._host_batches(epoch))
        assert len(got) == len(want) == (3 if train else 4)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["image"].numpy(), w["image"])
            np.testing.assert_array_equal(g["label"], w["label"])
            np.testing.assert_array_equal(g["mask"], w["mask"])
    for g, w in zip(ours.epoch(0), theirs.epoch(0)):
        np.testing.assert_allclose(g["image"].numpy().transpose(0, 2, 3, 1),
                                   np.asarray(w["image"]), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(g["label"].numpy(), np.asarray(w["label"]))
        np.testing.assert_array_equal(g["mask"].numpy(), np.asarray(w["mask"]))


# ------------------------------------------------------------------ stager

@pytest.mark.parametrize("shape,size", [((4, 37, 53, 3), (64, 96)),
                                        ((3, 375, 500, 3), (260, 260)),
                                        ((2, 100, 90, 1), (37, 211))])
def test_stager_resize_equals_jax(shape, size):
    images = np.random.RandomState(0).randint(0, 256, shape).astype(np.uint8)
    np.testing.assert_array_equal(native_stager.resize_batch(images, size),
                                  jax_stager.resize_batch(images, size))
    np.testing.assert_array_equal(native_stager.resize_batch(images, shape[1:3]), images)


def test_stager_gather_equals_numpy():
    rng = np.random.RandomState(1)
    items = rng.randint(0, 256, (100, 8, 8, 3)).astype(np.uint8)
    idx = rng.permutation(100)[:37]
    np.testing.assert_array_equal(native_stager.gather_items(items, idx), items[idx])
    np.testing.assert_array_equal(native_stager.gather_items(items, idx[:0]), items[idx[:0]])


def test_stager_raises_as_jax():
    items = np.zeros((5, 2, 2, 3), np.uint8)
    for bad in ([0, 5], [-1]):
        with pytest.raises(IndexError):
            jax_stager.gather_items(items, np.array(bad))
        with pytest.raises(IndexError):
            native_stager.gather_items(items, np.array(bad))
    floats = np.zeros((2, 4, 4, 3), np.float32)
    with pytest.raises(TypeError):
        jax_stager.resize_batch(floats, (2, 2))
    with pytest.raises(TypeError):
        native_stager.resize_batch(floats, (2, 2))
    with pytest.raises(TypeError):
        native_stager.gather_items(floats, [0])


# ------------------------------------------------------------ server decode

@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("name", JPEGS + PNGS)
def test_server_decode_equals_jax(name, channels):
    body = (FIXTURES / name).read_bytes()
    got = _decode_image(body, 40, channels, "cpu")
    want = jax_decode_image(body, 40, channels)
    assert got.shape == want.shape == (40, 40, channels) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_server_decode_refuses_other_bodies():
    with pytest.raises(ValueError, match="neither PNG nor JPEG"):
        _decode_image(b"GIF89a" + bytes(20), 8, 3, "cpu")
