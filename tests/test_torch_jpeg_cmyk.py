"""Four-component JPEGs on the CPU: the plain version of the card's CMYK
conversion (``data/_decode.py::cmyk_to_rgb_ref``, the kernel's arithmetic)
against Pillow bit for bit, on every value grid and on the stored planes of
the committed CMYK and YCCK fixtures, also where three components are
subsampled 2x2 or 2x1 (libjpeg's upsampling, ``upsample_ref``); the port's
CPU decode of those fixtures against the JAX package's ``FolderDataset``;
the Adobe marker's transform; the staged pixels the card is held to; and
12-bit samples, which Pillow refuses as the card's decode does."""

import io
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image, ImageFile, JpegImagePlugin, UnidentifiedImageError

from scouter_tpu.data import FolderDataset as JaxFolderDataset
from scouter_tpu_torch.data import FolderDataset
from scouter_tpu_torch.data._decode import (_SOF, StoredPlanes, _segments, adobe_transform,
                                            cmyk_to_rgb, cmyk_to_rgb_ref, decode_jpeg,
                                            jpeg_frame, upsample_ref)

FIXTURES = Path(__file__).resolve().parent / "torch_fixtures"
CMYK_JPEGS = ("cmyk_400x300.jpg", "ycck_400x300.jpg", "cmyk420_160x120.jpg",
              "cmyk422_160x120.jpg")


def stored_planes(data: bytes, draft=None) -> np.ndarray:
    """The planes as the file stores them, (4, H, W): Pillow's decoder told
    that the colour space is CMYK (no YCCK conversion) and to read it as
    stored (no inversion), what nvJPEG's NVJPEG_OUTPUT_UNCHANGED gives where
    no component is subsampled; with ``draft`` (a size), decoded at that
    scale by libjpeg's DCT scaling."""
    im = Image.open(io.BytesIO(data))
    if draft is not None:
        im.draft("CMYK", draft)
    tile = im.tile[0]
    im.tile = [ImageFile._Tile("jpeg", tile[1], tile[2], ("CMYK", "CMYK"))]
    im.load()
    return np.ascontiguousarray(np.asarray(im).transpose(2, 0, 1))


def sampling(data: bytes):
    """Each component's (horizontal, vertical) sampling factors."""
    for marker, payload in _segments(data):
        if marker in _SOF:
            return [(payload[7 + 3 * i] >> 4, payload[7 + 3 * i] & 15)
                    for i in range(payload[5])]
    raise ValueError("no frame header")


def unfancy_h2v1(up: np.ndarray) -> np.ndarray:
    """The stored samples (h, ceil(w / 2)) behind libjpeg's 2x horizontal
    triangle filter's output (h, w): the first sample is the first output's,
    and each next one is the only value both of its outputs' formulas
    allow (a test asserts it is the only one)."""
    h, w = up.shape
    u = up.astype(np.int64)
    out = np.zeros((h, -(-w // 2)), np.int64)
    out[:, 0] = u[:, 0]
    cand = np.arange(256)[None, :]
    for i in range(1, out.shape[1]):
        ok = ((3 * out[:, i - 1:i] + cand + 2) >> 2) == u[:, 2 * i - 1:2 * i]
        if 2 * i < w:
            ok &= ((3 * cand + out[:, i - 1:i] + 1) >> 2) == u[:, 2 * i:2 * i + 1]
        assert (ok.sum(axis=1) == 1).all()
        out[:, i] = ok.argmax(axis=1)
    return out.astype(np.uint8)


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


@pytest.mark.parametrize("name,factors", [("cmyk420_160x120.jpg", (2, 2)),
                                          ("cmyk422_160x120.jpg", (2, 1))])
def test_subsampled_planes_convert_as_pillow_decodes(name, factors):
    """The first component sampled 2x2 (Pillow's subsampling=2) or 2x1 (=1),
    so the other three are stored at half size: their stored samples (the
    draft decode at half scale, which libjpeg's DCT scaling gives without
    upsampling them; or, for 2x1, read back from the upsampled ones) go
    through the plain version's upsampling and conversion, bit for bit with
    Pillow's decode."""
    data = (FIXTURES / name).read_bytes()
    assert sampling(data) == [factors, (1, 1), (1, 1), (1, 1)]
    assert jpeg_frame(data) == (8, 120, 160, 4)
    full = stored_planes(data)  # every component upsampled by libjpeg
    if factors == (2, 2):
        small = stored_planes(data, draft=(80, 60))
        assert small.shape == (4, 60, 80)
        parts = [full[0]] + [small[c] for c in (1, 2, 3)]
    else:
        parts = [full[0]] + [unfancy_h2v1(full[c]) for c in (1, 2, 3)]
    for c in (1, 2, 3):  # libjpeg's upsampling of the stored samples
        np.testing.assert_array_equal(
            upsample_ref(torch.from_numpy(parts[c]), 120, 160).numpy(), full[c])
    planes = StoredPlanes(torch.from_numpy(np.concatenate([p.reshape(-1) for p in parts])),
                          tuple(p.shape[0] for p in parts), tuple(p.shape[1] for p in parts))
    with Image.open(io.BytesIO(data)) as im:
        want = np.asarray(im.convert("RGB"))
    before = cmyk_to_rgb.launches
    np.testing.assert_array_equal(cmyk_to_rgb(planes, False).numpy(), want)
    assert cmyk_to_rgb.launches == before


@pytest.mark.parametrize("shape,size", [((5, 3), (10, 6)), ((3, 5), (3, 10)),
                                        ((5, 5), (10, 10)), ((4, 2), (8, 4)),
                                        ((3, 2), (3, 6)), ((2, 3), (7, 11))])
def test_upsampling_keeps_flat_planes_flat_at_every_factor(shape, size):
    # the triangle filters (2x1, 1x2, 2x2 where wider than 2 samples) and
    # replication (2x2 at width 2, 3x, and odd cuts past the stored edge)
    # give a flat plane back flat, at the image's size
    for level in (0, 7, 128, 255):
        out = upsample_ref(torch.full(shape, level, dtype=torch.uint8), *size)
        assert out.shape == size and (out == level).all()


def test_cpu_decode_equals_jax_folder_dataset():
    # staged at 260 px, the 160 x 120 ones at 120 (the fixtures' byte budget)
    staged = np.load(FIXTURES / "staged_cmyk_260.npz")
    assert sorted(staged.files) == sorted(CMYK_JPEGS)
    for size, names in ((260, CMYK_JPEGS[:2]), (120, CMYK_JPEGS[2:])):
        items = [(str(FIXTURES / name), i) for i, name in enumerate(names)]
        ours = FolderDataset(items, size, "ImageNet", device="cpu").gather([0, 1])
        theirs = JaxFolderDataset(items, size, "ImageNet").gather([0, 1])
        np.testing.assert_array_equal(ours.numpy(), theirs)
        for i, name in enumerate(names):
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
