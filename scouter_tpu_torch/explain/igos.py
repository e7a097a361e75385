"""IGOS, Integrated-Gradient Optimized Saliency (counterpart of
``scouter_tpu/explain/igos.py``; the capability of ``torchcam/IGOS.py``).

- blur baseline: 51x51 Gaussian, sigma 50, cv2's reflect-101 border
  (Get_blurred_img :151-196);
- mask optimisation (Integrated_Mask :234-527): a size_init^2 mask of ones;
  each outer iteration takes the gradient of ``l1*mean|1-m| +
  tv*TV_beta(m) + (1/K) sum_j softmax(model(img*(j/K)*up(m) +
  blurred*(1-(j/K)*up(m)) + noise))[c]`` (K=20 mask scalings, Gaussian noise
  sigma 0.2), then a backtracking line search (start 200, shrink x0.2,
  alpha 1e-4, floor 1e-5) and a clamp to [0, 1]; l1_coeff anneals when the
  score curve stalls (:482-494);
- deletion/insertion curves (Deletion_Insertion :588-755).

The noise is drawn per outer iteration from a ``torch.Generator`` on the
CPU (``seed``); :func:`integrated_mask` takes ``draw_noise`` in its place,
so JAX's draws reproduce JAX's mask. The line search reads its condition
on the host each step; the arithmetic stays float32 on the device.
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.layers import _reflect_index

__all__ = ["gaussian_blur_baseline", "tv_norm", "integrated_mask",
           "deletion_insertion_curve", "write_video"]


def gaussian_blur_baseline(img: torch.Tensor, ksize: int = 51, sigma: float = 50.0) -> torch.Tensor:
    """cv2.GaussianBlur(img, (51, 51), 50) with reflect-101 borders.
    img: (1, C, H, W)."""
    half = ksize // 2
    xs = np.arange(ksize, dtype=np.float32) - half
    g = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    k = torch.from_numpy(g).to(img.device, img.dtype)
    b, c, h, w = img.shape
    xt = img.reshape(b * c, 1, h, w)
    # numpy's "reflect" (the edge not repeated) is cv2's reflect-101
    xt = xt.index_select(2, _reflect_index(h, half, img.device))
    xt = xt.index_select(3, _reflect_index(w, half, img.device))
    out = F.conv2d(xt, k.view(1, 1, -1, 1))
    out = F.conv2d(out, k.view(1, 1, 1, -1))
    return out.reshape(b, c, h, w)


def _resize_bilinear_align_corners(m: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """2-D bilinear resize with align_corners=True, torch's
    ``nn.UpsamplingBilinear2d`` (the reference's mask upsampler,
    ``IGOS.py:274-276``), in JAX's arithmetic."""
    ih, iw = m.shape
    ys = torch.linspace(0.0, ih - 1.0, oh, device=m.device, dtype=m.dtype)
    xs = torch.linspace(0.0, iw - 1.0, ow, device=m.device, dtype=m.dtype)
    y0 = ys.floor().long().clamp(0, ih - 1)
    x0 = xs.floor().long().clamp(0, iw - 1)
    y1 = (y0 + 1).clamp(max=ih - 1)
    x1 = (x0 + 1).clamp(max=iw - 1)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[None, :]
    top = m[y0][:, x0] * (1 - wx) + m[y0][:, x1] * wx
    bot = m[y1][:, x0] * (1 - wx) + m[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's derivative at 0, which is 1 (``torch.abs``'s is 0): the
    l1 term starts at m = 1, where every |1 - m| is 0."""
    return torch.where(x >= 0, x, -x)


def tv_norm(mask: torch.Tensor, tv_beta: float = 2.0) -> torch.Tensor:
    """Total-variation norm of an (h, w) mask (IGOS.py:60-64)."""
    row = (_abs(mask[:-1, :] - mask[1:, :]) ** tv_beta).mean()
    col = (_abs(mask[:, :-1] - mask[:, 1:]) ** tv_beta).mean()
    return row + col


class IgosResult(NamedTuple):
    mask: torch.Tensor  # (size_init, size_init) in [0, 1]; 0 = important
    upsampled: torch.Tensor  # (H, W)
    curve_reg: torch.Tensor  # (T,) l1+tv values
    curve_score: torch.Tensor  # (T,) class prob under the current mask


def integrated_mask(
    forward: Callable,
    img: torch.Tensor,
    blurred: torch.Tensor,
    category: int,
    seed: int = 0,
    *,
    max_iterations: int = 15,
    integ_iter: int = 20,
    tv_beta: float = 2.0,
    l1_coeff: float = 0.01 * 300,
    tv_coeff: float = 0.2 * 300,
    size_init: int = 112,
    noise_std: float = 0.2,
    draw_noise: Optional[Callable[[int], torch.Tensor]] = None,
) -> IgosResult:
    """IGOS mask optimisation. forward: (B, C, H, W) -> logits; img and
    blurred: (1, C, H, W). ``draw_noise(t)`` gives outer iteration t's
    (integ_iter, C, H, W) noise; by default ``noise_std`` x N(0, 1) drawn
    from ``seed``."""
    h, w = img.shape[2:]
    dev = img.device
    dt = torch.promote_types(img.dtype, torch.float32)  # the mask's dtype
    if draw_noise is None:
        gen = torch.Generator().manual_seed(seed)
        shape = (integ_iter, *img.shape[1:])

        def draw_noise(t):
            return (noise_std * torch.randn(shape, generator=gen)).to(dev, dt)

    def upsample(m):
        return _resize_bilinear_align_corners(m, h, w)[None, None]

    def class_prob(x):
        return torch.softmax(forward(x), dim=1)[:, category]

    def reg_loss(m, l1c):
        return l1c * _abs(1.0 - m).mean() + tv_coeff * tv_norm(m, tv_beta)

    scales = ((torch.arange(integ_iter, dtype=dt, device=dev) + 1.0)
              / integ_iter)[:, None, None, None]

    def total_loss(m, l1c, noise):
        masks = scales * upsample(m)  # (K, 1, H, W)
        perturbed = img * masks + blurred * (1.0 - masks)
        return reg_loss(m, l1c) + class_prob(perturbed + noise).sum() / integ_iter

    def masked_score(m):
        um = upsample(m)
        return class_prob(img * um + blurred * (1.0 - um))[0]

    alpha, beta = np.float32(1e-4), np.float32(0.2)
    m = torch.ones((size_init, size_init), dtype=dt, device=dev)
    l1c = torch.tensor(l1_coeff, dtype=dt, device=dev)
    score0 = torch.zeros((), dtype=dt, device=dev)
    curve_reg, curve_score = [], []
    for t in range(max_iterations):
        noise = draw_noise(t)
        with torch.enable_grad():
            mg = m.detach().requires_grad_(True)
            (grad,) = torch.autograd.grad(total_loss(mg, l1c, noise), mg)
        with torch.no_grad():
            score_ori = masked_score(m)
            loss_ori = reg_loss(m, l1c) + score_ori
            gnorm2 = (grad ** 2).sum()
            step = np.float32(200.0)
            while step >= np.float32(1e-5):
                cand = (m - float(step) * grad).clamp(0.0, 1.0)
                ls = reg_loss(cand, l1c) + masked_score(cand)
                if not bool(ls > loss_ori - float(alpha * step) * gnorm2):
                    break
                step = np.float32(step * beta)
            m = (m - float(step) * grad).clamp(0.0, 1.0)
            # l1 annealing when the score curve stalls (:482-494), only with
            # more than 3 iterations, as the reference (IGOS.py:478)
            if t == 0:
                score0 = score_ori
            if max_iterations > 3:
                stall = (score0 - score_ori).abs()
                if t == max_iterations // 2:
                    l1c = torch.where(stall <= 0.001, l1c / 10.0, l1c)
                if t == int(max_iterations / 1.25):
                    l1c = torch.where(stall <= 0.01, l1c / 5.0, l1c)
            curve_reg.append(reg_loss(m, l1c))
            curve_score.append(masked_score(m))
    with torch.no_grad():
        up = upsample(m)[0, 0]
    return IgosResult(m, up, torch.stack(curve_reg), torch.stack(curve_score))


def deletion_insertion_curve(
    forward: Callable,
    img: torch.Tensor,
    blurred: torch.Tensor,
    mask: torch.Tensor,
    category: int,
    num_points: int = 20,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deletion and insertion probability curves: pixels removed (inserted)
    in order of mask importance, ascending mask value first
    (topmaxPixel :33-44)."""
    h, w = mask.shape
    n = h * w
    order = torch.argsort(mask.reshape(-1), stable=True)
    ranks = torch.empty(n, dtype=torch.float32, device=mask.device)
    ranks[order] = torch.arange(n, dtype=torch.float32, device=mask.device)
    fractions = torch.linspace(0.0, 1.0, num_points)
    ih, iw = img.shape[2:]
    dels, ins = [], []
    with torch.no_grad():
        for frac in fractions:
            kcount = int(frac * n)
            removed = (ranks < kcount).to(torch.float32).reshape(h, w)
            um = _resize_bilinear_align_corners(1.0 - removed, ih, iw)[None, None]
            dels.append(torch.softmax(forward(img * um + blurred * (1 - um)), dim=1)[0, category])
            um_ins = _resize_bilinear_align_corners(removed, ih, iw)[None, None]
            ins.append(torch.softmax(forward(img * um_ins + blurred * (1 - um_ins)),
                                     dim=1)[0, category])
    return torch.stack(dels), torch.stack(ins)


def write_video(inputpath: str, outputname: str, img_num: int, fps: int = 10) -> str:
    """Mask-optimisation video export (``torchcam/IGOS.py:755-775``
    capability): the ``video{i}.jpg`` (or ``.png``) frames under
    ``inputpath`` written as an animated GIF with Pillow (imported here:
    no other path needs it). Returns the path written."""
    from PIL import Image

    frames = []
    for i in range(img_num):
        path = os.path.join(inputpath, f"video{i + 1}.jpg")
        if not os.path.exists(path):
            path = os.path.join(inputpath, f"video{i + 1}.png")
        frames.append(Image.open(path).convert("RGB"))
    if not frames:
        raise ValueError(f"no video*.jpg frames under {inputpath!r}")
    out = os.path.splitext(outputname)[0] + ".gif"
    frames[0].save(out, save_all=True, append_images=frames[1:],
                   duration=int(1000 / fps), loop=0)
    return out
