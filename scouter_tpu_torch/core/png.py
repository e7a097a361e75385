"""8-bit gray, RGB and RGBA PNG files with filter-0 rows in one zlib stream,
from ``zlib`` and ``struct`` alone: the server's slot maps and the explain
path's images are written with it, and the explain path's files read back,
where Pillow is not installed.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["encode_png", "read_png", "write_png"]

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> PNG colour type: gray, RGB, RGBA


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


def read_png(path: str) -> np.ndarray:
    """Decode a PNG that :func:`encode_png` wrote (8-bit gray, RGB or RGBA,
    not interlaced, filter-0 rows) to (H, W) or (H, W, C) uint8; raises for
    anything else and for a bad chunk CRC."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = len(_PNG_SIGNATURE), None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in chunk {tag!r}")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + length
    w, h, depth, color_type, _, _, interlace = header
    channels = {v: k for k, v in _COLOR_TYPE.items()}.get(color_type)
    if depth != 8 or channels is None or interlace != 0:
        raise ValueError(f"{path}: only 8-bit gray, RGB and RGBA without interlace are read")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * channels)
    if raw[:, 0].any():
        raise ValueError(f"{path}: only filter-0 rows are read")
    pixels = raw[:, 1:].reshape(h, w, channels).copy()  # writable, unlike the buffer
    return pixels[..., 0] if channels == 1 else pixels
