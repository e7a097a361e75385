"""Image files to staged uint8 pixels on a device: the decode that the
folder reader, the eager list loader and the server share.

- PNG: ``core/png.py``'s reader on the host, then the pixels go to the device.
- JPEG: on the card, nvJPEG (``csrc/jpeg_decode.cu``) writes the pixels
  straight into a CUDA tensor; on the CPU, Pillow decodes them, as the JAX
  package does (``scouter_tpu/data/streaming.py::FolderDataset._decode``). A
  CUDA device never falls back to Pillow or the CPU: a JPEG that nvJPEG
  cannot take raises (CMYK, 12-bit samples).
- Staging: Pillow's bilinear resize of each plane
  (``explain/_imaging.py::resize_bilinear_u8``, bit for bit), on the device.

A decode is a pure function of the file's bytes. ``decode_jpeg.decodes``
counts the JPEGs that went through nvJPEG, as the kernel wrappers count
their launches.
"""

from __future__ import annotations

import ctypes
import io
import struct
import threading

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.png import decode_png, luma

__all__ = ["decode_file", "decode_image", "decode_jpeg", "jpeg_frame", "stage"]

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
JPEG_MAGIC = b"\xff\xd8"
_NVJPEG_RGBI, _NVJPEG_Y = 5, 2  # nvjpegOutputFormat_t
# start-of-frame markers: every SOFn but DHT (C4), JPG (C8) and DAC (CC)
_SOF = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF}


def jpeg_frame(data: bytes):
    """(precision, height, width, components) from a JPEG's frame header."""
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise ValueError("JPEG: marker expected")
        marker = data[pos + 1]
        if marker == 0xFF:  # fill byte
            pos += 1
            continue
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:  # markers without a length
            pos += 2
            continue
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        if marker in _SOF:
            return struct.unpack(">BHHB", data[pos + 4:pos + 10])
        pos += 2 + length
    raise ValueError("JPEG: no frame header")


class _NvJpeg:
    """The process's nvJPEG handle and one decode state per host thread."""

    def __init__(self):
        from ..ops import cuda_build

        self.lib = lib = cuda_build.load("jpeg_decode")
        p, i, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
        pi = ctypes.POINTER(ctypes.c_int)
        lib.jpeg_handle_create.argtypes = [ctypes.POINTER(p)]
        lib.jpeg_state_create.argtypes = [p, ctypes.POINTER(p)]
        lib.jpeg_image_info.argtypes = [p, ctypes.c_char_p, sz, pi, pi, pi, pi]
        lib.jpeg_decode.argtypes = [p, p, ctypes.c_char_p, sz, i, p, sz, p]
        for fn in (lib.jpeg_handle_create, lib.jpeg_state_create, lib.jpeg_image_info,
                   lib.jpeg_decode):
            fn.restype = i
        self.handle = p()
        self._check(lib.jpeg_handle_create(ctypes.byref(self.handle)), "nvjpegCreateSimple")
        self._local = threading.local()

    @staticmethod
    def _check(status: int, what: str) -> None:
        if status:
            raise RuntimeError(f"{what} failed with status {status} (an nvjpegStatus_t, "
                               "or 100 + a cudaError_t)")

    def _state(self):
        state = getattr(self._local, "state", None)
        if state is None:
            state = ctypes.c_void_p()
            self._check(self.lib.jpeg_state_create(self.handle, ctypes.byref(state)),
                        "nvjpegJpegStateCreate")
            self._local.state = state
        return state

    def decode(self, data: bytes, device: torch.device) -> torch.Tensor:
        comps, css, w, h = (ctypes.c_int() for _ in range(4))
        self._check(self.lib.jpeg_image_info(self.handle, data, len(data), ctypes.byref(comps),
                                             ctypes.byref(css), ctypes.byref(w),
                                             ctypes.byref(h)), "nvjpegGetImageInfo")
        gray = comps.value == 1
        out = torch.empty((h.value, w.value) if gray else (h.value, w.value, 3),
                          dtype=torch.uint8, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        self._check(self.lib.jpeg_decode(self.handle, self._state(), data, len(data),
                                         _NVJPEG_Y if gray else _NVJPEG_RGBI, out.data_ptr(),
                                         w.value if gray else 3 * w.value, stream),
                    "nvjpegDecode")
        return out[..., None].expand(-1, -1, 3) if gray else out


_nvjpeg = None
_nvjpeg_lock = threading.Lock()


def decode_jpeg(data: bytes, device) -> torch.Tensor:
    """A JPEG's pixels as Pillow's ``convert("RGB")`` gives them: (H, W, 3)
    uint8 on ``device``. The card decodes with nvJPEG (gray replicated to
    RGB), the CPU with Pillow."""
    global _nvjpeg
    device = resolve_device(device)
    if device.type != "cuda":
        from PIL import Image

        with Image.open(io.BytesIO(data)) as im:
            return torch.from_numpy(np.asarray(im.convert("RGB"), np.uint8).copy())
    precision, _, _, components = jpeg_frame(data)
    if precision != 8:
        raise ValueError(f"JPEG: {precision}-bit samples; nvJPEG decodes 8-bit JPEGs only")
    if components not in (1, 3):
        raise ValueError(f"JPEG: {components} components (CMYK?); nvJPEG decodes gray and "
                         "YCbCr JPEGs only")
    with _nvjpeg_lock:
        if _nvjpeg is None:
            _nvjpeg = _NvJpeg()
    with torch.cuda.device(device):
        out = _nvjpeg.decode(data, device)
    with _nvjpeg_lock:
        decode_jpeg.decodes += 1
    return out


decode_jpeg.decodes = 0


def decode_image(data: bytes, device, mode: str = "RGB") -> torch.Tensor:
    """PNG or JPEG bytes to (H, W, 3) uint8 (``mode="RGB"``) or (H, W)
    (``mode="L"``, Pillow's luma) on ``device``."""
    device = resolve_device(device)
    if data.startswith(PNG_MAGIC):
        return torch.from_numpy(decode_png(data, mode)).to(device)
    if data.startswith(JPEG_MAGIC):
        rgb = decode_jpeg(data, device)
        return luma(rgb) if mode == "L" else rgb
    raise ValueError("image bytes are neither PNG nor JPEG")


def stage(pixels: torch.Tensor, size: int) -> torch.Tensor:
    """Pillow's ``resize((size, size), BILINEAR)`` of (H, W) or (H, W, C)
    uint8 pixels, on their device."""
    from ..explain._imaging import resize_bilinear_u8

    if pixels.dim() == 2:
        return resize_bilinear_u8(pixels, size, size)
    return resize_bilinear_u8(pixels.permute(2, 0, 1), size, size).permute(1, 2, 0).contiguous()


def decode_file(path: str, size: int, device) -> torch.Tensor:
    """The image at ``path`` staged to (size, size, 3) uint8 on ``device``:
    Pillow's ``convert("RGB").resize((size, size), BILINEAR)``."""
    with open(path, "rb") as f:
        data = f.read()
    return stage(decode_image(data, device), size)
