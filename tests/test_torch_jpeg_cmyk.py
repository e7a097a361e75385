"""Four-component JPEGs on the CPU: the plain version of the card's CMYK
conversion (``data/_decode.py::cmyk_to_rgb_ref``, the kernel's arithmetic)
against Pillow bit for bit, on every value grid and on the stored planes of
the committed CMYK and YCCK fixtures; the port's CPU decode of those
fixtures against the JAX package's ``FolderDataset``; the Adobe marker's
transform; the staged pixels the card is held to; and 12-bit samples,
which Pillow refuses as the card's decode does."""

import io
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image, ImageFile, JpegImagePlugin, UnidentifiedImageError

from scouter_tpu.data import FolderDataset as JaxFolderDataset
from scouter_tpu_torch.data import FolderDataset
from scouter_tpu_torch.data._decode import (adobe_transform, cmyk_to_rgb, cmyk_to_rgb_ref,
                                            decode_jpeg, jpeg_frame)

FIXTURES = Path(__file__).resolve().parent / "torch_fixtures"
CMYK_JPEGS = ("cmyk_400x300.jpg", "ycck_400x300.jpg")


def stored_planes(data: bytes) -> np.ndarray:
    """The planes as the file stores them, (4, H, W): Pillow's decoder told
    that the colour space is CMYK (no YCCK conversion) and to read it as
    stored (no inversion), what nvJPEG's NVJPEG_OUTPUT_UNCHANGED gives."""
    im = Image.open(io.BytesIO(data))
    tile = im.tile[0]
    im.tile = [ImageFile._Tile("jpeg", tile[1], tile[2], ("CMYK", "CMYK"))]
    im.load()
    return np.ascontiguousarray(np.asarray(im).transpose(2, 0, 1))


def test_cmyk_arithmetic_equals_pillows_cmyk2rgb():
    """Every (c, k) pair on a grid of all 256 levels and random quadruples:
    Pillow converts the values its decoder leaves (the stored planes
    inverted); the plain version takes the stored planes."""
    c, k = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    rng = np.random.RandomState(0)
    grid = np.stack([c, 255 - c, (c + k) % 256, k], axis=-1).astype(np.uint8)
    values = np.concatenate([grid, rng.randint(0, 256, (256, 256, 4)).astype(np.uint8)])
    want = np.asarray(Image.fromarray(values, "CMYK").convert("RGB"))
    got = cmyk_to_rgb_ref(torch.from_numpy(255 - values).permute(2, 0, 1), ycck=False)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name,ycck", [("cmyk_400x300.jpg", False), ("ycck_400x300.jpg", True)])
def test_conversion_of_stored_planes_equals_pillows_decode(name, ycck):
    data = (FIXTURES / name).read_bytes()
    assert adobe_transform(data) == (2 if ycck else 0)
    assert jpeg_frame(data) == (8, 300, 400, 4)
    with Image.open(io.BytesIO(data)) as im:
        want = np.asarray(im.convert("RGB"))
    planes = torch.from_numpy(stored_planes(data))
    before = cmyk_to_rgb.launches
    got = cmyk_to_rgb(planes, ycck)  # a CPU tensor: the plain version, uncounted
    np.testing.assert_array_equal(got.numpy(), want)
    assert cmyk_to_rgb.launches == before
    # the YCCK fixture's stored planes are the CMYK file's: only the marker
    # tells the two apart
    if ycck:
        other = stored_planes((FIXTURES / CMYK_JPEGS[0]).read_bytes())
        np.testing.assert_array_equal(planes.numpy(), other)
        assert not np.array_equal(want, cmyk_to_rgb_ref(planes, False).numpy())


def test_cpu_decode_equals_jax_folder_dataset():
    items = [(str(FIXTURES / name), i) for i, name in enumerate(CMYK_JPEGS)]
    ours = FolderDataset(items, 260, "ImageNet", device="cpu").gather([0, 1])
    theirs = JaxFolderDataset(items, 260, "ImageNet").gather([0, 1])
    np.testing.assert_array_equal(ours.numpy(), theirs)
    staged = np.load(FIXTURES / "staged_cmyk_260.npz")
    assert sorted(staged.files) == sorted(CMYK_JPEGS)
    for i, name in enumerate(CMYK_JPEGS):
        np.testing.assert_array_equal(staged[name], theirs[i], err_msg=name)


def test_adobe_transform_absent_from_ycbcr_jpegs():
    assert adobe_transform((FIXTURES / "rgb420_500x375.jpg").read_bytes()) is None


def test_twelve_bit_samples_are_refused_by_pillow_as_by_the_card():
    # a frame header that says 12-bit samples: Pillow's JpegImagePlugin
    # refuses it on open ("cannot handle 12-bit layers"), so the JAX
    # package's folder reader raises where the card's decode raises
    data = bytearray((FIXTURES / "cmyk_400x300.jpg").read_bytes())
    sof = data.index(b"\xff\xc0")
    assert data[sof + 4] == 8
    data[sof + 4] = 12
    data = bytes(data)
    assert jpeg_frame(data)[0] == 12
    with pytest.raises(SyntaxError, match="cannot handle 12-bit layers"):
        JpegImagePlugin.JpegImageFile(io.BytesIO(data))
    with pytest.raises(UnidentifiedImageError):
        decode_jpeg(data, "cpu")  # Pillow, as the JAX package decodes
