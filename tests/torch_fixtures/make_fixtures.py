"""Write the image fixtures of the port's folder tests and of chip_smoke.py.

    python tests/torch_fixtures/make_fixtures.py

The images are made from a seed with numpy and written with Pillow:

- JPEG at CUB-200's sizes: ``rgb420_500x375.jpg`` (baseline 4:2:0),
  ``rgb444_375x500.jpg`` (baseline 4:4:4), ``progressive_500x333.jpg`` and
  ``gray_500x375.jpg``;
- PNG: ``rgb_filters_300x200.png`` (RGB, its rows filtered with each of the
  five PNG filters in turn, Average included, by this script's own encoder),
  ``palette_trns_240x180.png`` (palette with ``tRNS``), ``gray_alpha_200x150.png``
  and ``rgba_220x160.png`` (Pillow's encoder, which picks its own filters);
- ``staged_260.npz``: Pillow's ``convert("RGB").resize((260, 260), BILINEAR)``
  of each JPEG, the pixels that nvJPEG's decode is held to on the card;
- four-component JPEGs: ``cmyk_400x300.jpg``, CMYK as Pillow writes it
  (inverted, under an Adobe marker with transform 0), and
  ``ycck_400x300.jpg``, the same file with the marker's transform set to 2,
  which makes its stored planes YCCK to every decoder (Pillow cannot write
  YCCK, and no ``cjpeg`` is at hand); ``cmyk420_160x120.jpg`` and
  ``cmyk422_160x120.jpg``, CMYK with the first component sampled 2x2 and
  2x1 (Pillow's ``subsampling=2`` and ``1``), so that the other three are
  subsampled; ``staged_cmyk_260.npz`` holds Pillow's staged pixels of all
  four, at ``CMYK_STAGE``'s size each (260 px, and 120 for the small ones:
  the fixtures stay under 2 MiB).

A CPU test regenerates ``staged_260.npz`` with Pillow and checks it.
"""

import io
import os
import struct
import zlib

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
STAGE = 260
JPEGS = ("rgb420_500x375.jpg", "rgb444_375x500.jpg", "progressive_500x333.jpg",
         "gray_500x375.jpg")
PNGS = ("rgb_filters_300x200.png", "palette_trns_240x180.png", "gray_alpha_200x150.png",
        "rgba_220x160.png")


def scene(width, height, seed):
    """A photo-like RGB scene: a sky gradient, a few soft discs, texture."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    img = np.stack([0.3 + 0.4 * yy / height, 0.5 + 0.2 * xx / width,
                    0.8 - 0.3 * yy / height], axis=-1)
    for _ in range(6):
        cx, cy = rng.rand() * width, rng.rand() * height
        r = (0.08 + 0.2 * rng.rand()) * min(width, height)
        disc = np.clip(1.5 - np.hypot(xx - cx, yy - cy) / r, 0, 1)[..., None]
        img = img * (1 - disc) + rng.rand(3).astype(np.float32) * disc
    img += 0.06 * np.sin(xx / 3.0 + yy / 5.0)[..., None] + 0.04 * rng.randn(height, width, 3)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def png_all_filters(pixels):
    """An RGB PNG whose row y is filtered with filter type y % 5."""
    h, w, c = pixels.shape
    rows = pixels.reshape(h, w * c).astype(np.int32)
    out = []
    for y in range(h):
        x = rows[y]
        up = rows[y - 1] if y else np.zeros_like(x)
        left = np.concatenate([np.zeros(c, np.int32), x[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), up[:-c]])
        ftype = y % 5
        pred = [0, left, up, (left + up) >> 1, _paeth(left, up, upleft)][ftype]
        out.append(bytes([ftype]) + ((x - pred) % 256).astype(np.uint8).tobytes())

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(out), 9)) + chunk(b"IEND", b""))


def staged(path, size=STAGE):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB").resize((size, size), Image.BILINEAR))


CMYK_JPEGS = ("cmyk_400x300.jpg", "ycck_400x300.jpg", "cmyk420_160x120.jpg",
              "cmyk422_160x120.jpg")
CMYK_STAGE = dict(zip(CMYK_JPEGS, (STAGE, STAGE, 120, 120)))  # the staged size of each


def cmyk_scene(width, height, seed):
    """A CMYK scene: ``scene``'s colours, with a black plane that varies."""
    cmy = 255 - scene(width, height, seed).astype(np.int32)
    k = (cmy.min(axis=-1) * 3) // 4
    return np.dstack([cmy - k[..., None], k]).astype(np.uint8)


def write_cmyk():
    """The four-component fixtures and their staged pixels."""
    buf = io.BytesIO()
    Image.fromarray(cmyk_scene(400, 300, 20), "CMYK").save(buf, "JPEG", quality=90)
    data = buf.getvalue()
    at = data.index(b"Adobe") + 11  # the APP14 payload's transform byte
    if data[at] != 0:
        raise ValueError("Pillow wrote a CMYK JPEG without Adobe transform 0")
    ycck = data[:at] + b"\x02" + data[at + 1:]
    blobs = [data, ycck]
    for subsampling in (2, 1):
        buf = io.BytesIO()
        Image.fromarray(cmyk_scene(160, 120, 21), "CMYK").save(buf, "JPEG", quality=85,
                                                               subsampling=subsampling)
        blobs.append(buf.getvalue())
    for name, blob in zip(CMYK_JPEGS, blobs):
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(blob)
    np.savez_compressed(os.path.join(HERE, "staged_cmyk_260.npz"),
                        **{name: staged(os.path.join(HERE, name), CMYK_STAGE[name])
                           for name in CMYK_JPEGS})


def main():
    rgb = {name: scene(w, h, seed) for seed, (name, w, h) in enumerate(
        (("a", 500, 375), ("b", 375, 500), ("c", 500, 333), ("d", 500, 375)))}
    Image.fromarray(rgb["a"]).save(os.path.join(HERE, JPEGS[0]), quality=85, subsampling=2)
    Image.fromarray(rgb["b"]).save(os.path.join(HERE, JPEGS[1]), quality=85, subsampling=0)
    Image.fromarray(rgb["c"]).save(os.path.join(HERE, JPEGS[2]), quality=85, progressive=True)
    Image.fromarray(rgb["d"]).convert("L").save(os.path.join(HERE, JPEGS[3]), quality=85)

    with open(os.path.join(HERE, PNGS[0]), "wb") as f:
        f.write(png_all_filters(scene(300, 200, 10)))
    pal = Image.fromarray(scene(240, 180, 11)).quantize(64)
    pal.save(os.path.join(HERE, PNGS[1]), transparency=bytes(range(0, 256, 4)))
    Image.fromarray(scene(200, 150, 12)).convert("LA").save(os.path.join(HERE, PNGS[2]))
    rgba = np.dstack([scene(220, 160, 13), scene(220, 160, 14)[..., 0]])
    Image.fromarray(rgba, "RGBA").save(os.path.join(HERE, PNGS[3]))

    np.savez_compressed(os.path.join(HERE, "staged_260.npz"),
                        **{name: staged(os.path.join(HERE, name)) for name in JPEGS})
    write_cmyk()


if __name__ == "__main__":
    main()
