"""PNG files from ``zlib`` and ``struct`` alone, where Pillow is not
installed: the server's slot maps and the explain path's images are
written with :func:`encode_png`, and images on disk or in a request are read
with :func:`decode_png`.

The reader takes every 8-bit PNG and the sub-byte gray and palette depths:
filters 0-4 (undone by the host stager, ``csrc/stager.cpp``), gray, gray +
alpha, RGB, RGBA, and palette with ``PLTE`` and ``tRNS``. It converts as
Pillow's ``convert("RGB")`` and ``convert("L")`` do (Convert.c): alpha is
dropped, gray is replicated, a palette is looked up, and RGB becomes gray by
Pillow's integer luma ``(R*19595 + G*38470 + B*7471 + 0x8000) >> 16``. Adam7
interlace and 16-bit samples raise ``ValueError``.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

__all__ = ["decode_png", "encode_png", "luma", "read_png", "write_png"]

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> PNG colour type: gray, RGB, RGBA
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples a pixel
_DEPTHS = {0: (1, 2, 4, 8), 2: (8,), 3: (1, 2, 4, 8), 4: (8,), 6: (8,)}
_LUMA = (19595, 38470, 7471)  # Pillow's L24 weights, 16 fraction bits


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(arr, level: int = 6) -> bytes:
    """The PNG bytes of a uint8 (H, W) gray, (H, W, 1) gray, (H, W, 3) RGB or
    (H, W, 4) RGBA array or tensor: filter-0 rows, one zlib IDAT."""
    arr = arr.cpu().numpy() if hasattr(arr, "cpu") else np.asarray(arr)
    if arr.dtype != np.uint8:
        raise TypeError(f"PNG images here are uint8, got {arr.dtype}")
    channels = 1 if arr.ndim == 2 else arr.shape[2]
    if arr.ndim not in (2, 3) or channels not in _COLOR_TYPE:
        raise ValueError(f"cannot write a PNG of shape {arr.shape}")
    h, w = arr.shape[:2]
    raw = np.zeros((h, 1 + w * channels), np.uint8)  # column 0: filter type 0
    raw[:, 1:] = arr.reshape(h, w * channels)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[channels], 0, 0, 0)
    return (_PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) + _chunk(b"IEND", b""))


def write_png(path: str, arr) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(arr))


def luma(rgb):
    """Pillow's ``convert("L")`` of uint8 RGB pixels (..., 3), a numpy array
    or a torch tensor: (..., ) uint8."""
    if hasattr(rgb, "int"):  # a torch tensor, on any device
        px = rgb.int()
        return ((px[..., 0] * _LUMA[0] + px[..., 1] * _LUMA[1] + px[..., 2] * _LUMA[2]
                 + 0x8000) >> 16).to(rgb.dtype)
    px = rgb.astype(np.int32)
    return ((px[..., 0] * _LUMA[0] + px[..., 1] * _LUMA[1] + px[..., 2] * _LUMA[2]
             + 0x8000) >> 16).astype(np.uint8)


def _chunks(data: bytes, name: str):
    """(tag, body) of each chunk up to IEND, CRCs checked."""
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{name}: not a PNG file")
    pos = len(_PNG_SIGNATURE)
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{name}: bad CRC in chunk {tag!r}")
        if tag == b"IEND":
            return
        yield tag, body
        pos += 12 + length
    raise ValueError(f"{name}: truncated, no IEND chunk")


def _unpack_bits(rows: np.ndarray, depth: int, width: int) -> np.ndarray:
    """Sub-byte samples, most significant first, to one uint8 per sample."""
    bits = np.unpackbits(rows, axis=1).reshape(rows.shape[0], -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)[:, :width]


def decode_png(data: bytes, mode: Optional[str] = None, name: str = "PNG") -> np.ndarray:
    """Decode PNG bytes to uint8 pixels.

    ``mode=None`` keeps the stored channels: (H, W) gray, (H, W, 2) gray +
    alpha, (H, W, 3) RGB or (H, W, 4) RGBA; a palette image comes back as
    RGB, and sub-byte gray is scaled to 0-255 as Pillow opens it. ``mode``
    "RGB" gives (H, W, 3) and "L" gives (H, W), as Pillow's ``convert``."""
    if mode not in (None, "RGB", "L"):
        raise ValueError(f"mode must be None, 'RGB' or 'L', got {mode!r}")
    header, palette, idat = None, None, []
    for tag, body in _chunks(data, name):
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    w, h, depth, color_type, _, _, interlace = header
    if depth == 16:
        raise ValueError(f"{name}: 16-bit samples are not read, only 8-bit and less")
    if interlace != 0:
        raise ValueError(f"{name}: Adam7-interlaced PNGs are not read")
    if depth not in _DEPTHS.get(color_type, ()):
        raise ValueError(f"{name}: bit depth {depth} with colour type {color_type} is "
                         "not a valid PNG")
    if color_type == 3 and palette is None:
        raise ValueError(f"{name}: palette image without a PLTE chunk")
    samples = _CHANNELS[color_type]
    rowbytes = (w * samples * depth + 7) // 8
    from ..data.native_stager import png_unfilter

    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = png_unfilter(raw[:h * (rowbytes + 1)], h, rowbytes, max(1, samples * depth // 8))
    if depth < 8:
        rows = _unpack_bits(rows, depth, w)
        if color_type == 0:
            rows = rows * np.uint8(255 // ((1 << depth) - 1))
    pixels = rows.reshape(h, w, samples)
    if color_type == 3:
        # Pillow's palette starts as a gray ramp and PLTE overwrites its head
        lut = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
        lut[:len(palette)] = palette[:256]
        pixels = lut[pixels[..., 0]]
    if mode is None:
        return pixels[..., 0] if pixels.shape[-1] == 1 else pixels
    if pixels.shape[-1] in (1, 2):  # gray, alpha dropped
        gray = pixels[..., 0]
        return gray if mode == "L" else np.repeat(gray[..., None], 3, axis=2)
    rgb = pixels[..., :3]
    return luma(rgb) if mode == "L" else np.ascontiguousarray(rgb)


def read_png(path: str, mode: Optional[str] = None) -> np.ndarray:
    """:func:`decode_png` of the file at ``path``."""
    with open(path, "rb") as f:
        return decode_png(f.read(), mode, name=str(path))
