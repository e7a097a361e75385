"""AutoAugment / RandAugment (counterpart of ``scouter_tpu/data/auto_augment.py``,
timm's ``timm/data/auto_augment.py``) on uint8 image tensors, on their
device, without Pillow.

The JAX package applies Pillow ops on the host. Here each op is the tensor
counterpart of the Pillow call, reproducing Pillow 12's integer and float
arithmetic:

- every enhance op is ``Image.blend(degenerate, image, factor)``:
  ``deg + f32(factor) * (img - deg)`` in float32, clipped to [0, 255] and
  truncated (not rounded); Color's degenerate is the ITU-R 601-2 luma in
  fixed point (``(19595 R + 38470 G + 7471 B + 0x8000) >> 16``) taken back
  to RGB, Contrast's a flat image at ``int(mean luma + 0.5)``,
  Brightness's black, Sharpness's ``ImageFilter.SMOOTH`` (3x3, centre 5,
  divisor 13, float32 taps summed row by row from the next row up, plus
  0.5, truncated; the border pixels kept);
- ``equalize`` and ``autocontrast``: per-channel histograms and
  ``ImageOps``' lookup tables (equalize's ``step``/``n`` walk in integers,
  autocontrast's ``int(ix * scale + offset)`` in float64), clipped to 255;
- ``posterize``, ``solarize``, ``solarize_add``, ``invert``: integer ops;
- shear, translate and rotate: ``Image.transform(AFFINE, BILINEAR)`` with
  fill (128, 128, 128): the source point of each pixel centre in float64
  (``a0 * x + a1 * y + a2``), outside ``[0, size)`` the fill, else the
  bilinear blend of the clamped neighbours in float64, truncated; rotate
  builds Pillow's matrix (cos and sin rounded to 15 decimals) and, at 0
  degrees, returns a copy.

Products and sums are separate calls, so no fused multiply-add rounds them
differently on the card. Images are uint8 (3, H, W), or a batch (N, 3, H,
W); an op takes one argument, or one per image of a batch.

The policies keep the JAX package's ``random.Random(seed)`` stream and its
order of draws: the sub-policy ``choice`` (AutoAugment) or the op
``choice`` (RandAugment), ``random() <= prob`` (AutoAugment), then, only
for the signed ops, the negation draw. A batch draws image by image, in
order, as the JAX package's transform called on each image; its ops then
run grouped: each position of the sub-policy, each op once over the images
that drew it.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Sequence, Tuple

import torch

__all__ = ["AutoAugment", "RandAugment", "auto_augment_policy", "rand_augment_ops"]

_MAX_LEVEL = 10.0
_FILL = 128
_TRANSLATE_CONST = 250.0  # timm _HPARAMS_DEFAULT translate_const


def _randomly_negate(v, rng=random):
    return -v if rng.random() > 0.5 else v


# ---- helpers ------------------------------------------------------------------

def _batched(fn):
    """Run ``fn(images (N, 3, H, W), args (N,))`` on one image or a batch,
    with one argument for all or one per image."""

    def op(img: torch.Tensor, arg):
        single = img.dim() == 3
        batch = img[None] if single else img
        args = list(arg) if isinstance(arg, (list, tuple)) else [arg] * batch.shape[0]
        out = fn(batch, args)
        return out[0] if single else out

    return op


def _per_image(args, images, dtype) -> torch.Tensor:
    """(N, 1, 1, 1) tensor of per-image arguments on the images' device."""
    return torch.tensor(args, dtype=dtype, device=images.device).view(-1, 1, 1, 1)


def _f32(x: float) -> float:
    return float(torch.tensor(x, dtype=torch.float32))


def _luma(images: torch.Tensor) -> torch.Tensor:
    """Pillow's RGB -> L (Convert.c ``rgb2l``): (N, 1, H, W) int32."""
    x = images.to(torch.int32)
    return (x[:, 0:1] * 19595 + x[:, 1:2] * 38470 + x[:, 2:3] * 7471 + 0x8000) >> 16


def _blend(degenerate: torch.Tensor, images: torch.Tensor, factors) -> torch.Tensor:
    """``Image.blend(degenerate, images, factor)`` (Blend.c): float32
    ``deg + factor * (img - deg)``, clipped and truncated."""
    deg = degenerate.to(torch.int32)
    diff = (images.to(torch.int32) - deg).to(torch.float32)
    f = _per_image([_f32(a) for a in factors], images, torch.float32)
    v = deg.to(torch.float32) + f * diff
    return v.clamp(0.0, 255.0).floor().to(torch.uint8)


def _apply_lut(images: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """``image.point(lut)`` with a (N, 3, 256) table, values clipped to 255."""
    n, c, h, w = images.shape
    idx = images.reshape(n, c, h * w).long()
    return lut.clamp(0, 255).to(torch.uint8).gather(2, idx).reshape(n, c, h, w)


def _histograms(images: torch.Tensor) -> torch.Tensor:
    """(N, 3, 256) int64 per-channel histograms."""
    n, c, h, w = images.shape
    flat = images.reshape(n * c, h * w).long()
    flat = flat + torch.arange(n * c, device=images.device)[:, None] * 256
    hist = torch.zeros(n * c * 256, dtype=torch.int64, device=images.device)
    hist.index_add_(0, flat.reshape(-1), torch.ones_like(flat.reshape(-1)))
    return hist.view(n, c, 256)


# ---- op implementations --------------------------------------------------------

def _autocontrast(images, args):
    """``ImageOps.autocontrast(img)``: per channel, lo/hi the first and last
    used levels; ``int(ix * scale + offset)`` with ``scale = 255 / (hi -
    lo)`` and ``offset = -lo * scale`` in float64, identity where hi <= lo."""
    hist = _histograms(images)
    used = hist > 0
    levels = torch.arange(256, device=images.device)
    lo = torch.where(used, levels, 256).amin(-1, keepdim=True)
    hi = torch.where(used, levels, -1).amax(-1, keepdim=True)
    span = (hi - lo).clamp_min(1).to(torch.float64)
    # a true division: torch computes ``scalar / tensor`` (and, on the card,
    # ``tensor / scalar``) through a reciprocal, off by an ulp
    scale = torch.full_like(span, 255.0) / span
    offset = -lo.to(torch.float64) * scale
    lut = torch.trunc(levels.to(torch.float64) * scale + offset).clamp(0, 255).long()
    lut = torch.where(hi <= lo, levels, lut)
    return _apply_lut(images, lut)


def _equalize(images, args):
    """``ImageOps.equalize(img)``: per channel, ``step = (total - count of
    the last used level) // 255``, ``lut[i] = (step // 2 + count below i)
    // step``; identity where at most one level is used or step is 0."""
    hist = _histograms(images)
    used = hist > 0
    levels = torch.arange(256, device=images.device)
    last = torch.where(used, levels, -1).amax(-1, keepdim=True)
    last_count = hist.gather(-1, last.clamp_min(0))
    step = (hist.sum(-1, keepdim=True) - last_count) // 255
    below = torch.cumsum(hist, -1) - hist
    lut = (step // 2 + below) // step.clamp_min(1)
    keep = (used.sum(-1, keepdim=True) <= 1) | (step == 0)
    return _apply_lut(images, torch.where(keep, levels, lut))


def _invert(images, args):
    return 255 - images


def _posterize(images, args):
    """``ImageOps.posterize(img, bits)``: ``x & ~(2 ** (8 - bits) - 1)``;
    8 bits and more leave the image as it is, 0 bits blacks it (timm
    auto_augment.py:153-156)."""
    masks = [255 if b >= 8 else (255 << (8 - int(b))) & 255 for b in args]
    return images & _per_image(masks, images, torch.uint8)


def _solarize(images, args):
    """``ImageOps.solarize(img, thresh)``: ``255 - x`` from ``thresh`` up."""
    t = _per_image([int(a) for a in args], images, torch.int32)
    return torch.where(images.to(torch.int32) < t, images, 255 - images)


def _solarize_add(images, args, thresh=128):
    """``x + add`` clipped to [0, 255] where ``x < thresh``."""
    x = images.to(torch.int32)
    add = _per_image([int(a) for a in args], images, torch.int32)
    return torch.where(x < thresh, (x + add).clamp(0, 255), x).to(torch.uint8)


def _color(images, args):
    return _blend(_luma(images).expand_as(images), images, args)


def _contrast(images, args):
    luma = _luma(images)
    n, _, h, w = luma.shape
    total = luma.reshape(n, -1).sum(-1).to(torch.float64)
    mean = total / torch.full_like(total, float(h * w))
    level = torch.floor(mean + 0.5).to(torch.int32).view(n, 1, 1, 1)
    return _blend(level.expand_as(images), images, args)


def _brightness(images, args):
    return _blend(torch.zeros_like(images), images, args)


def _smooth(images: torch.Tensor) -> torch.Tensor:
    """``image.filter(ImageFilter.SMOOTH)`` (Filter.c ``ImagingFilter3x3``):
    float32 taps 1/13 and 5/13; each output ``0.5 + row(y+1) + row(y) +
    row(y-1)``, each row ``(a*k0 + b*k1) + c*k2``, truncated and clipped;
    the first and last rows and columns copied."""
    out = images.clone()
    h, w = images.shape[-2:]
    if h < 3 or w < 3:
        return out
    k = _f32(_f32(1.0) / _f32(13.0))
    kc = _f32(_f32(5.0) / _f32(13.0))
    x = images.to(torch.float32)

    def row(r, centre):
        a, b, c = x[..., r, 0:w - 2], x[..., r, 1:w - 1], x[..., r, 2:w]
        return (a * k + b * (kc if centre else k)) + c * k

    ss = torch.full_like(x[..., 1:h - 1, 1:w - 1], 0.5)
    ss = ss + row(slice(2, h), False)
    ss = ss + row(slice(1, h - 1), True)
    ss = ss + row(slice(0, h - 2), False)
    out[..., 1:h - 1, 1:w - 1] = ss.clamp(0.0, 255.0).floor().to(torch.uint8)
    return out


def _sharpness(images, args):
    return _blend(_smooth(images), images, args)


def _affine(images: torch.Tensor, matrices: Sequence[Sequence[float]]) -> torch.Tensor:
    """``img.transform(img.size, AFFINE, m, BILINEAR, fillcolor=(128,)*3)``
    (Geometry.c ``affine_transform`` + ``bilinear_filter32RGB``), one
    6-tuple a image, in float64."""
    n, c, h, w = images.shape
    dev = images.device
    m = torch.tensor(matrices, dtype=torch.float64, device=dev).view(n, 6, 1, 1).unbind(1)
    yin = (torch.arange(h, device=dev, dtype=torch.float64) + 0.5).view(1, h, 1)
    xin = (torch.arange(w, device=dev, dtype=torch.float64) + 0.5).view(1, 1, w)
    sx = (m[0] * xin + m[1] * yin) + m[2]
    sy = (m[3] * xin + m[4] * yin) + m[5]
    inside = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    sx, sy = sx - 0.5, sy - 0.5
    x0, y0 = torch.floor(sx), torch.floor(sy)
    dx, dy = sx - x0, sy - y0
    x0, y0 = x0.long(), y0.long()
    xa, xb = x0.clamp(0, w - 1), (x0 + 1).clamp(0, w - 1)
    ya = y0.clamp(0, h - 1)
    has_next = (y0 + 1 >= 0) & (y0 + 1 < h)
    yb = (y0 + 1).clamp(0, h - 1)
    flat = images.reshape(n, c, h * w).to(torch.int32)

    def pick(yy, xx):
        idx = (yy * w + xx).reshape(n, 1, h * w).expand(n, c, h * w)
        return flat.gather(2, idx).reshape(n, c, h, w)

    def lerp_x(yy):
        a = pick(yy, xa)
        return a.to(torch.float64) + (pick(yy, xb) - a).to(torch.float64) * dx[:, None]

    v1 = lerp_x(ya)
    v2 = torch.where(has_next[:, None], lerp_x(yb), v1)
    v = v1 + (v2 - v1) * dy[:, None]
    out = torch.where(inside[:, None], v.to(torch.uint8), torch.full_like(images, _FILL))
    return out


def _shear_x(images, args):
    return _affine(images, [(1, f, 0, 0, 1, 0) for f in args])


def _shear_y(images, args):
    return _affine(images, [(1, 0, 0, f, 1, 0) for f in args])


def _translate_x_rel(images, args):
    w = images.shape[-1]
    return _affine(images, [(1, 0, pct * w, 0, 1, 0) for pct in args])


def _translate_y_rel(images, args):
    h = images.shape[-2]
    return _affine(images, [(1, 0, 0, 0, 1, pct * h) for pct in args])


def _translate_x_abs(images, args):
    return _affine(images, [(1, 0, px, 0, 1, 0) for px in args])


def _translate_y_abs(images, args):
    return _affine(images, [(1, 0, 0, 0, 1, px) for px in args])


def _rotate_matrix(degrees: float, width: int, height: int) -> List[float]:
    """``Image.rotate``'s inverse affine matrix about the centre, as Pillow
    computes it (cos and sin rounded to 15 decimals)."""
    angle = -math.radians(degrees % 360.0)
    matrix = [round(math.cos(angle), 15), round(math.sin(angle), 15), 0.0,
              round(-math.sin(angle), 15), round(math.cos(angle), 15), 0.0]
    cx, cy = width / 2, height / 2
    a, b, c, d, e, f = matrix
    matrix[2] = a * -cx + b * -cy + c + cx
    matrix[5] = d * -cx + e * -cy + f + cy
    return matrix


def _rotate(images, args):
    """``img.rotate(degrees, BILINEAR, fillcolor=(128,)*3)``; a copy at 0."""
    out = images.clone()
    turn = [i for i, deg in enumerate(args) if deg % 360.0 != 0]
    if turn:
        h, w = images.shape[-2:]
        out[turn] = _affine(images[turn], [_rotate_matrix(args[i], w, h) for i in turn])
    return out


def _enhance_arg(l):
    """plain enhance magnitude (timm _enhance_level_to_arg): unsigned."""
    return (l / _MAX_LEVEL) * 1.8 + 0.1


def _enhance_increasing_arg(l, rng=random):
    return 1.0 + _randomly_negate((l / _MAX_LEVEL) * 0.9, rng)


def _signed(scale: float):
    return lambda l, rng=random: _randomly_negate(l / _MAX_LEVEL * scale, rng)


# (op_fn, level->arg): names and magnitude rules of timm LEVEL_TO_ARG
# (auto_augment.py:180-286), as the JAX package's table
_OPS = {
    "AutoContrast": (_batched(_autocontrast), lambda l: None),
    "Equalize": (_batched(_equalize), lambda l: None),
    "Invert": (_batched(_invert), lambda l: None),
    "Rotate": (_batched(_rotate), _signed(30.0)),
    "Posterize": (_batched(_posterize), lambda l: int(l / _MAX_LEVEL * 4)),
    "PosterizeIncreasing": (_batched(_posterize), lambda l: 4 - int(l / _MAX_LEVEL * 4)),
    "PosterizeOriginal": (_batched(_posterize), lambda l: int(l / _MAX_LEVEL * 4) + 4),
    "Solarize": (_batched(_solarize), lambda l: int(l / _MAX_LEVEL * 256)),
    "SolarizeIncreasing": (_batched(_solarize), lambda l: 256 - int(l / _MAX_LEVEL * 256)),
    "SolarizeAdd": (_batched(_solarize_add), lambda l: int(l / _MAX_LEVEL * 110)),
    "Color": (_batched(_color), _enhance_arg),
    "ColorIncreasing": (_batched(_color), _enhance_increasing_arg),
    "Contrast": (_batched(_contrast), _enhance_arg),
    "ContrastIncreasing": (_batched(_contrast), _enhance_increasing_arg),
    "Brightness": (_batched(_brightness), _enhance_arg),
    "BrightnessIncreasing": (_batched(_brightness), _enhance_increasing_arg),
    "Sharpness": (_batched(_sharpness), _enhance_arg),
    "SharpnessIncreasing": (_batched(_sharpness), _enhance_increasing_arg),
    "ShearX": (_batched(_shear_x), _signed(0.3)),
    "ShearY": (_batched(_shear_y), _signed(0.3)),
    "TranslateX": (_batched(_translate_x_abs), _signed(_TRANSLATE_CONST)),
    "TranslateY": (_batched(_translate_y_abs), _signed(_TRANSLATE_CONST)),
    "TranslateXRel": (_batched(_translate_x_rel), _signed(0.45)),
    "TranslateYRel": (_batched(_translate_y_rel), _signed(0.45)),
}
# the ops whose level->arg takes the rng and draws the negation (the JAX
# package's ``_apply`` finds them by the TypeError of the others)
SIGNED_OPS = frozenset(("Rotate", "ShearX", "ShearY", "TranslateX", "TranslateY",
                        "TranslateXRel", "TranslateYRel", "ColorIncreasing",
                        "ContrastIncreasing", "BrightnessIncreasing", "SharpnessIncreasing"))


def _arg(name: str, level, rng=random):
    to_arg = _OPS[name][1]
    return to_arg(level, rng) if name in SIGNED_OPS else to_arg(level)


def _apply(img, name, level, rng=random):
    return _OPS[name][0](img, _arg(name, level, rng))


def apply_plans(images: torch.Tensor, plans: Sequence[Sequence[Tuple[str, object]]]
                ) -> torch.Tensor:
    """Apply ``plans[i]`` (a list of (op, arg)) to ``images[i]`` (N, 3, H,
    W), each position of the plans in turn, each op once over the images
    that drew it."""
    out = images.clone()
    for pos in range(max((len(p) for p in plans), default=0)):
        groups: Dict[str, List[int]] = {}
        for i, plan in enumerate(plans):
            if pos < len(plan):
                groups.setdefault(plan[pos][0], []).append(i)
        for name, idx in groups.items():
            args = [plans[i][pos][1] for i in idx]
            sel = torch.tensor(idx, device=images.device)
            out[sel] = _OPS[name][0](out[sel], args)
    return out


def auto_augment_policy(name: str = "v0") -> List[List[Tuple[str, float, float]]]:
    """ImageNet sub-policies (timm auto_augment policy tables)."""
    if name == "v0":
        return [
            [("Equalize", 0.8, 1), ("ShearY", 0.8, 4)],
            [("Color", 0.4, 9), ("Equalize", 0.6, 3)],
            [("Color", 0.4, 1), ("Rotate", 0.6, 8)],
            [("Solarize", 0.8, 3), ("Equalize", 0.4, 7)],
            [("Solarize", 0.4, 2), ("Solarize", 0.6, 2)],
            [("Color", 0.2, 0), ("Equalize", 0.8, 8)],
            [("Equalize", 0.4, 8), ("SolarizeAdd", 0.8, 3)],
            [("ShearX", 0.2, 9), ("Rotate", 0.6, 8)],
            [("Color", 0.6, 1), ("Equalize", 1.0, 2)],
            [("Invert", 0.4, 9), ("Rotate", 0.6, 0)],
            [("Equalize", 1.0, 9), ("ShearY", 0.6, 3)],
            [("Color", 0.4, 7), ("Equalize", 0.6, 0)],
            [("Posterize", 0.4, 6), ("AutoContrast", 0.4, 7)],
            [("Solarize", 0.6, 8), ("Color", 0.6, 9)],
            [("Solarize", 0.2, 4), ("Rotate", 0.8, 9)],
            [("Rotate", 1.0, 7), ("TranslateYRel", 0.8, 9)],
            [("ShearX", 0.0, 0), ("Solarize", 0.8, 4)],
            [("ShearY", 0.8, 0), ("Color", 0.6, 4)],
            [("Color", 1.0, 0), ("Rotate", 0.6, 2)],
            [("Equalize", 0.8, 4), ("Equalize", 0.0, 8)],
            [("Equalize", 1.0, 4), ("AutoContrast", 0.6, 2)],
            [("ShearY", 0.4, 7), ("SolarizeAdd", 0.6, 7)],
            [("Posterize", 0.8, 2), ("Solarize", 0.6, 10)],
            [("Solarize", 0.6, 8), ("Equalize", 0.6, 1)],
            [("Color", 0.8, 6), ("Rotate", 0.4, 5)],
        ]
    if name == "original":
        return [
            [("PosterizeOriginal", 0.4, 8), ("Rotate", 0.6, 9)],
            [("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)],
            [("Equalize", 0.8, 8), ("Equalize", 0.6, 3)],
            [("PosterizeOriginal", 0.6, 7), ("PosterizeOriginal", 0.6, 6)],
            [("Equalize", 0.4, 7), ("Solarize", 0.2, 4)],
            [("Equalize", 0.4, 4), ("Rotate", 0.8, 8)],
            [("Solarize", 0.6, 3), ("Equalize", 0.6, 7)],
            [("PosterizeOriginal", 0.8, 5), ("Equalize", 1.0, 2)],
            [("Rotate", 0.2, 3), ("Solarize", 0.6, 8)],
            [("Equalize", 0.6, 8), ("PosterizeOriginal", 0.4, 6)],
            [("Rotate", 0.8, 8), ("Color", 0.4, 0)],
            [("Rotate", 0.4, 9), ("Equalize", 0.6, 2)],
            [("Equalize", 0.0, 7), ("Equalize", 0.8, 8)],
            [("Invert", 0.6, 4), ("Equalize", 1.0, 8)],
            [("Color", 0.6, 4), ("Contrast", 1.0, 8)],
            [("Rotate", 0.8, 8), ("Color", 1.0, 2)],
            [("Color", 0.8, 8), ("Solarize", 0.8, 7)],
            [("Sharpness", 0.4, 7), ("Invert", 0.6, 8)],
            [("ShearX", 0.6, 5), ("Equalize", 1.0, 9)],
            [("Color", 0.4, 0), ("Equalize", 0.6, 3)],
            [("Equalize", 0.4, 7), ("Solarize", 0.2, 4)],
            [("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)],
            [("Invert", 0.6, 4), ("Equalize", 1.0, 8)],
            [("Color", 0.6, 4), ("Contrast", 1.0, 8)],
            [("Equalize", 0.8, 8), ("Equalize", 0.6, 3)],
        ]
    raise ValueError(f"unknown policy {name!r}")


class AutoAugment:
    """One random sub-policy an image: each of its ops applied with its
    probability. Takes uint8 (3, H, W) or a batch (N, 3, H, W)."""

    def __init__(self, policy: str = "v0", seed: int | None = None):
        self.policy = auto_augment_policy(policy)
        self.rng = random.Random(seed)

    def plan(self) -> List[Tuple[str, object]]:
        """The next image's (op, arg) list, drawn from the stream."""
        sub = self.rng.choice(self.policy)
        return [(name, _arg(name, magnitude, self.rng)) for name, prob, magnitude in sub
                if self.rng.random() <= prob]

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        if img.dim() == 3:
            return apply_plans(img[None], [self.plan()])[0]
        return apply_plans(img, [self.plan() for _ in range(img.shape[0])])


def rand_augment_ops() -> Sequence[str]:
    """timm _RAND_TRANSFORMS (auto_augment.py:538-555)."""
    return ("AutoContrast", "Equalize", "Invert", "Rotate", "Posterize",
            "Solarize", "SolarizeAdd", "Color", "Contrast", "Brightness",
            "Sharpness", "ShearX", "ShearY", "TranslateXRel", "TranslateYRel")


class RandAugment:
    """``num_layers`` random ops at magnitude ``magnitude`` an image. Takes
    uint8 (3, H, W) or a batch (N, 3, H, W)."""

    def __init__(self, num_layers: int = 2, magnitude: float = 9,
                 ops: Sequence[str] | None = None, seed: int | None = None):
        self.num_layers = num_layers
        self.magnitude = magnitude
        self.ops = list(ops or rand_augment_ops())
        self.rng = random.Random(seed)

    def plan(self) -> List[Tuple[str, object]]:
        out = []
        for _ in range(self.num_layers):
            name = self.rng.choice(self.ops)
            out.append((name, _arg(name, self.magnitude, self.rng)))
        return out

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        if img.dim() == 3:
            return apply_plans(img[None], [self.plan()])[0]
        return apply_plans(img, [self.plan() for _ in range(img.shape[0])])
