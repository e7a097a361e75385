"""Image files to staged uint8 pixels on a device: the decode that the
folder reader, the eager list loader and the server share.

- PNG: ``core/png.py``'s reader on the host, then the pixels go to the device.
- JPEG: on the card, nvJPEG (``csrc/jpeg_decode.cu``) writes the pixels
  straight into a CUDA tensor; on the CPU, Pillow decodes them, as the JAX
  package does (``scouter_tpu/data/streaming.py::FolderDataset._decode``). A
  four-component JPEG (CMYK, or YCCK under an Adobe marker's transform 2)
  is decoded into its planes, each component at its own size, and
  converted to RGB as Pillow converts it, subsampled components upsampled as
  libjpeg upsamples them (``cmyk_to_rgb``: the kernel on the card,
  ``cmyk_to_rgb_ref`` its plain version). A CUDA device never falls back to
  Pillow or the CPU: a JPEG that nvJPEG cannot take raises (12-bit
  samples, which Pillow refuses too).
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
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.png import decode_png, luma

__all__ = ["StoredPlanes", "adobe_transform", "cmyk_to_rgb", "cmyk_to_rgb_ref", "decode_file",
           "decode_image", "decode_jpeg", "jpeg_frame", "stage", "upsample_ref"]

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
JPEG_MAGIC = b"\xff\xd8"
_NVJPEG_RGBI, _NVJPEG_Y = 5, 2  # nvjpegOutputFormat_t
# start-of-frame markers: every SOFn but DHT (C4), JPG (C8) and DAC (CC)
_SOF = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF}


def _segments(data: bytes):
    """(marker, payload) of each marker segment before the first scan."""
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
        if marker == 0xDA:  # start of scan
            return
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        yield marker, data[pos + 4:pos + 2 + length]
        pos += 2 + length


def jpeg_frame(data: bytes):
    """(precision, height, width, components) from a JPEG's frame header."""
    for marker, payload in _segments(data):
        if marker in _SOF:
            return struct.unpack(">BHHB", payload[:6])
    raise ValueError("JPEG: no frame header")


def adobe_transform(data: bytes):
    """The transform byte of a JPEG's Adobe APP14 marker (0: none, 1: YCbCr,
    2: YCCK), or None without one; libjpeg reads it as Pillow's decoder
    does (jdmarker.c::examine_app14, the last such marker counting)."""
    transform = None
    for marker, payload in _segments(data):
        if marker == 0xEE and len(payload) >= 12 and payload.startswith(b"Adobe"):
            transform = payload[11]
    return transform


def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)  # libjpeg's FIX at SCALEBITS 16


class StoredPlanes(NamedTuple):
    """A four-component JPEG's planes as stored: ``flat`` holds the
    components one after another, component c ``heights[c]`` x
    ``widths[c]`` uint8; the image's size is the largest component's."""

    flat: torch.Tensor
    heights: Tuple[int, ...]
    widths: Tuple[int, ...]

    @property
    def size(self) -> Tuple[int, int]:
        return max(self.heights), max(self.widths)

    def plane(self, c: int) -> torch.Tensor:
        off = sum(h * w for h, w in zip(self.heights[:c], self.widths[:c]))
        h, w = self.heights[c], self.widths[c]
        return self.flat[off:off + h * w].view(h, w)


def _stored(planes) -> StoredPlanes:
    """``planes`` as ``StoredPlanes``: as they are, or a (4, H, W) tensor of
    four components of the image's size."""
    if isinstance(planes, StoredPlanes):
        return planes
    if planes.dim() != 3 or planes.shape[0] != 4:
        raise ValueError(f"four-component planes are (4, H, W) or StoredPlanes, got "
                         f"{tuple(planes.shape)}")
    _, h, w = planes.shape
    return StoredPlanes(planes.contiguous().reshape(-1), (h,) * 4, (w,) * 4)


def upsample_ref(plane: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """A component's stored samples (hc, wc) uint8 at the image's size
    (height, width), int32, as libjpeg-turbo upsamples them under Pillow
    (jdsample.c, fancy upsampling on): the triangle filter for 2x
    horizontal (where the component is wider than 2 samples), 2x vertical
    and both (wider than 2), the edge sample repeated at the borders as
    libjpeg's context rows repeat it; replication otherwise."""
    hc, wc = plane.shape
    x = plane.to(torch.int32)
    hx, vx = -(-width // wc), -(-height // hc)

    def shifted(t, dim, step):  # t[i + step] along dim, the edge sample repeated
        n = t.shape[dim]
        idx = (torch.arange(n, device=t.device) + step).clamp(0, n - 1)
        return t.index_select(dim, idx)

    if (hx, vx) == (1, 1):
        out = x
    elif (hx, vx) == (2, 1) and wc > 2:
        even = (3 * x + shifted(x, 1, -1) + 1) >> 2
        odd = (3 * x + shifted(x, 1, 1) + 2) >> 2
        out = torch.stack([even, odd], dim=2).reshape(hc, 2 * wc)
    elif (hx, vx) == (1, 2):
        even = (3 * x + shifted(x, 0, -1) + 1) >> 2
        odd = (3 * x + shifted(x, 0, 1) + 2) >> 2
        out = torch.stack([even, odd], dim=1).reshape(2 * hc, wc)
    elif (hx, vx) == (2, 2) and wc > 2:
        rows = []
        for sums in (3 * x + shifted(x, 0, -1), 3 * x + shifted(x, 0, 1)):
            even = (3 * sums + shifted(sums, 1, -1) + 8) >> 4
            odd = (3 * sums + shifted(sums, 1, 1) + 7) >> 4
            rows.append(torch.stack([even, odd], dim=2).reshape(hc, 2 * wc))
        out = torch.stack(rows, dim=1).reshape(2 * hc, 2 * wc)
    else:
        out = x.repeat_interleave(vx, dim=0).repeat_interleave(hx, dim=1)
    return out[:height, :width]


def cmyk_to_rgb_ref(planes, ycck: bool) -> torch.Tensor:
    """Plain version of ``csrc/jpeg_decode.cu``'s cmyk_to_rgb_kernel: a
    four-component JPEG's planes as stored (``StoredPlanes``, or (4, H, W)
    uint8 where no component is subsampled) to the (H, W, 3) uint8 pixels
    Pillow's ``convert("RGB")`` gives. Each component is upsampled to the
    image's size (``upsample_ref``); YCCK becomes CMYK as libjpeg's
    ``ycck_cmyk_convert`` computes it; Pillow reads the result inverted
    ("CMYK;I", Adobe's convention) and applies ``cmyk2rgb``: nk = 255 - k,
    out = clip(nk - MULDIV255(c, nk)). Integer arithmetic, bit for bit with
    Pillow's on the same planes."""
    stored = _stored(planes)
    height, width = stored.size
    c, m, y, k = (upsample_ref(stored.plane(i), height, width) for i in range(4))
    if ycck:
        luma, cb, cr, one_half = c, m - 128, y - 128, 1 << 15
        c = (255 - (luma + ((_fix(1.402) * cr + one_half) >> 16))).clamp(0, 255)
        m = (255 - (luma + ((-_fix(0.34414) * cb + one_half - _fix(0.71414) * cr) >> 16))
             ).clamp(0, 255)
        y = (255 - (luma + ((_fix(1.772) * cb + one_half) >> 16))).clamp(0, 255)
    nk = k  # 255 - the inverted K
    t = (255 - torch.stack([c, m, y], dim=-1)) * nk[..., None] + 128
    return (nk[..., None] - ((t + (t >> 8)) >> 8)).clamp(0, 255).to(torch.uint8)


def cmyk_to_rgb(planes, ycck: bool) -> torch.Tensor:
    """``cmyk_to_rgb_ref``'s function: on a CUDA tensor the kernel, one
    launch (``cmyk_to_rgb.launches`` counts it), on a CPU tensor the plain
    version."""
    stored = _stored(planes)
    if stored.flat.device.type != "cuda":
        return cmyk_to_rgb_ref(stored, ycck)
    if stored.flat.dtype != torch.uint8 or not stored.flat.is_contiguous():
        raise ValueError(f"cmyk_to_rgb takes contiguous uint8 planes, got {stored.flat.dtype}")
    height, width = stored.size
    out = torch.empty((height, width, 3), dtype=torch.uint8, device=stored.flat.device)
    lib = _nvjpeg_instance().lib
    with torch.cuda.device(stored.flat.device):
        err = lib.jpeg_cmyk_to_rgb(stored.flat.data_ptr(), (ctypes.c_int * 4)(*stored.widths),
                                   (ctypes.c_int * 4)(*stored.heights), int(ycck),
                                   out.data_ptr(),
                                   torch.cuda.current_stream(stored.flat.device).cuda_stream)
    if err:
        raise RuntimeError(f"cmyk_to_rgb_kernel launch failed: CUDA error {err}")
    cmyk_to_rgb.launches += 1
    return out


cmyk_to_rgb.launches = 0


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
        lib.jpeg_decode_planes.argtypes = [p, p, ctypes.c_char_p, sz, p, pi, pi, p]
        lib.jpeg_cmyk_to_rgb.argtypes = [p, pi, pi, i, p, p]
        for fn in (lib.jpeg_handle_create, lib.jpeg_state_create, lib.jpeg_image_info,
                   lib.jpeg_decode, lib.jpeg_decode_planes, lib.jpeg_cmyk_to_rgb):
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

    def info(self, data: bytes):
        """(components, [(width, height)] of each component)."""
        comps, css = ctypes.c_int(), ctypes.c_int()
        widths, heights = (ctypes.c_int * 4)(), (ctypes.c_int * 4)()
        self._check(self.lib.jpeg_image_info(self.handle, data, len(data), ctypes.byref(comps),
                                             ctypes.byref(css), widths, heights),
                    "nvjpegGetImageInfo")
        return comps.value, list(zip(widths, heights))[:comps.value]

    def planes(self, data: bytes, device: torch.device) -> StoredPlanes:
        """A four-component JPEG's planes as stored, each component at its
        own size, on ``device``."""
        comps, sizes = self.info(data)
        if comps != 4:
            raise ValueError(f"JPEG: {comps} components; the plane decode takes four")
        widths, heights = tuple(w for w, _ in sizes), tuple(h for _, h in sizes)
        flat = torch.empty(sum(w * h for w, h in sizes), dtype=torch.uint8, device=device)
        self._check(self.lib.jpeg_decode_planes(
            self.handle, self._state(), data, len(data), flat.data_ptr(),
            (ctypes.c_int * 4)(*widths), (ctypes.c_int * 4)(*heights),
            torch.cuda.current_stream(device).cuda_stream), "nvjpegDecode")
        return StoredPlanes(flat, heights, widths)

    def decode(self, data: bytes, device: torch.device) -> torch.Tensor:
        comps, sizes = self.info(data)
        if comps == 4:
            return cmyk_to_rgb(self.planes(data, device), adobe_transform(data) not in (None, 0))
        gray = comps == 1
        w, h = sizes[0]
        out = torch.empty((h, w) if gray else (h, w, 3), dtype=torch.uint8, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        self._check(self.lib.jpeg_decode(self.handle, self._state(), data, len(data),
                                         _NVJPEG_Y if gray else _NVJPEG_RGBI, out.data_ptr(),
                                         w if gray else 3 * w, stream),
                    "nvjpegDecode")
        return out[..., None].expand(-1, -1, 3) if gray else out


_nvjpeg = None
_nvjpeg_lock = threading.Lock()


def _nvjpeg_instance() -> _NvJpeg:
    global _nvjpeg
    with _nvjpeg_lock:
        if _nvjpeg is None:
            _nvjpeg = _NvJpeg()
        return _nvjpeg


def decode_jpeg(data: bytes, device) -> torch.Tensor:
    """A JPEG's pixels as Pillow's ``convert("RGB")`` gives them: (H, W, 3)
    uint8 on ``device``. The card decodes with nvJPEG (gray replicated to
    RGB; CMYK and YCCK through ``cmyk_to_rgb``), the CPU with Pillow."""
    device = resolve_device(device)
    if device.type != "cuda":
        from PIL import Image

        with Image.open(io.BytesIO(data)) as im:
            return torch.from_numpy(np.asarray(im.convert("RGB"), np.uint8).copy())
    precision, _, _, components = jpeg_frame(data)
    if precision != 8:
        raise ValueError(f"JPEG: {precision}-bit samples; nvJPEG decodes 8-bit JPEGs only "
                         "(Pillow refuses them too)")
    if components not in (1, 3, 4):
        raise ValueError(f"JPEG: {components} components; the decode takes gray, YCbCr and "
                         "CMYK/YCCK JPEGs")
    nvjpeg = _nvjpeg_instance()
    with torch.cuda.device(device):
        out = nvjpeg.decode(data, device)
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
