"""Plain PyTorch reference of the SCOUTER model the benchmark runs: a ResNeSt-d
backbone, the 1x1 head conv, the sine position embedding, the xSlot loop, the
loss with its area term, and AdamW's arithmetic.

It follows the published descriptions the port follows (timm's
``resnest.py`` and ``layers/split_attn.py``, the reference's
``sloter/utils/slot_attention.py``, ``sloter/slot_model.py`` and
``torch.optim.AdamW``) and imports nothing of the program: every tensor op
is written out here over a dict of tensors named as the program's
``state_dict()`` names them, so the benchmark hands both sides one set of
weights.

Where the configuration states a bf16 backbone, the backbone's products
take bf16 operands and its BatchNorms, ReLUs, pools and adds run on bf16
tensors (the statistics and the normalisation in f32, the result rounded to
bf16); the head, the xSlot loop, the loss and AdamW stay f32.
``precision`` (``reference/precision.py``) lowers every product one step
for the controls.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .precision import EXACT, Precision

__all__ = ["BLOCKS", "Spec", "adamw_step", "forward", "loss_of", "param_spec",
           "preprocess", "render_maps"]

# depth of each ResNeSt-d (timm: deep stem of width 32, avg_down, radix 2,
# avd, base width 64, cardinality 1)
BLOCKS = {"resnest14d": (1, 1, 1, 1), "resnest26d": (2, 2, 2, 2),
          "resnest50d": (3, 4, 6, 3)}
_STEM_WIDTH = 32
_RADIX = 2
_PLANES = (64, 128, 256, 512)
_STRIDES = (1, 2, 2, 2)
_BN_EPS = 1e-5
# per-dataset normalisation (the reference's transform_func.py:102-105)
_NORM = {"ImageNet": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
         "CUB200": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))}

# (name, shape, init) with init one of: ("fan_out", fan), ("fan_in", fan),
# ("uniform", bound), ("slots",), ("ones",), ("zeros",), ("count",)
Spec = List[Tuple[str, Tuple[int, ...], tuple]]


def _bn(spec: Spec, name: str, c: int) -> None:
    spec += [(f"{name}.weight", (c,), ("ones",)), (f"{name}.bias", (c,), ("zeros",)),
             (f"{name}.running_mean", (c,), ("zeros",)),
             (f"{name}.running_var", (c,), ("ones",)),
             (f"{name}.num_batches_tracked", (), ("count",))]


def _conv(spec: Spec, name: str, cout: int, cin_g: int, k: int, fan_out: bool,
          bias: bool = False) -> None:
    fan = cout * k * k if fan_out else cin_g * k * k
    spec.append((f"{name}.weight", (cout, cin_g, k, k), ("fan_out" if fan_out else "fan_in", fan)))
    if bias:
        spec.append((f"{name}.bias", (cout,), ("zeros",)))


def _blocks(model: str) -> Iterator[Tuple[str, int, int, int, bool]]:
    """(prefix, in channels, planes, stride, has skip projection) per block."""
    channels, current = 2 * _STEM_WIDTH, 2 * _STEM_WIDTH
    for i, (planes, stride, n) in enumerate(zip(_PLANES, _STRIDES, BLOCKS[model]), start=1):
        for j in range(n):
            s = stride if j == 0 else 1
            skip = j == 0 and (s != 1 or current != planes * 4)
            current = planes * 4
            yield f"backbone.layer{i}.{j}", channels, planes, s, skip
            channels = planes * 4


def param_spec(cfg: Dict) -> Spec:
    """Every entry of the model's state dict, in a fixed order, with its
    shape and init."""
    spec: Spec = []
    w = _STEM_WIDTH
    _conv(spec, "backbone.conv1.0", w, 3, 3, True)
    _bn(spec, "backbone.conv1.1", w)
    _conv(spec, "backbone.conv1.3", w, w, 3, True)
    _bn(spec, "backbone.conv1.4", w)
    _conv(spec, "backbone.conv1.6", 2 * w, w, 3, True)
    _bn(spec, "backbone.bn1", 2 * w)
    for p, cin, planes, _stride, skip in _blocks(cfg["model"]):
        gw = planes
        attn = max(gw * _RADIX // 4, 32)
        _conv(spec, f"{p}.conv1", gw, cin, 1, True)
        _bn(spec, f"{p}.bn1", gw)
        _conv(spec, f"{p}.conv2.conv", gw * _RADIX, gw // _RADIX, 3, False)
        _bn(spec, f"{p}.conv2.bn0", gw * _RADIX)
        _conv(spec, f"{p}.conv2.fc1", attn, gw, 1, False, bias=True)
        _bn(spec, f"{p}.conv2.bn1", attn)
        _conv(spec, f"{p}.conv2.fc2", gw * _RADIX, attn, 1, False, bias=True)
        _conv(spec, f"{p}.conv3", planes * 4, gw, 1, True)
        _bn(spec, f"{p}.bn3", planes * 4)
        if skip:
            _conv(spec, f"{p}.downsample.1", planes * 4, cin, 1, True)
            _bn(spec, f"{p}.downsample.2", planes * 4)
    d, s = cfg["hidden_dim"], cfg["num_classes"] * cfg["slots_per_class"]
    _conv(spec, "conv1x1", d, 2048, 1, False, bias=True)
    spec.append(("slot.initial_slots", (1, s, d), ("slots",)))
    bound = 1.0 / math.sqrt(d)
    for i in range(cfg["to_k_layer"]):
        spec += [(f"slot.to_k.{2 * i}.weight", (d, d), ("uniform", bound)),
                 (f"slot.to_k.{2 * i}.bias", (d,), ("uniform", bound))]
    spec += [("slot.gru.weight_ih_l0", (3 * d, d), ("uniform", bound)),
             ("slot.gru.weight_hh_l0", (3 * d, d), ("uniform", bound)),
             ("slot.gru.bias_ih_l0", (3 * d,), ("uniform", bound)),
             ("slot.gru.bias_hh_l0", (3 * d,), ("uniform", bound))]
    return spec


class _Net:
    """One forward over the weights ``P`` in a mode (train: batch
    statistics; eval: running statistics)."""

    def __init__(self, P: Dict[str, torch.Tensor], cfg: Dict, train: bool,
                 precision: Precision):
        self.P, self.cfg, self.train, self.prec = P, cfg, train, precision
        self.dt = torch.bfloat16 if cfg["compute_dtype"] == "bfloat16" else torch.float32

    def conv(self, x, name, stride=1, padding=0, groups=1, dt=None):
        dt = dt or self.dt
        w = self.P[f"{name}.weight"].to(dt)
        y = self.prec.product(lambda a, b: F.conv2d(a, b, None, stride, padding, 1, groups),
                              x.to(dt), w)
        b = self.P.get(f"{name}.bias")
        return y if b is None else y + b.to(dt)[None, :, None, None]

    def bn(self, x, name):
        P = self.P
        y = F.batch_norm(x.float(), None if self.train else P[f"{name}.running_mean"],
                         None if self.train else P[f"{name}.running_var"],
                         P[f"{name}.weight"], P[f"{name}.bias"], self.train, 0.0, _BN_EPS)
        return y.to(self.dt)

    def split_attn(self, x, p, stride):
        x = torch.relu(self.bn(self.conv(x, f"{p}.conv", stride, 1, groups=_RADIX), f"{p}.bn0"))
        b, rc, h, w = x.shape
        chs = rc // _RADIX
        x_r = x.view(b, _RADIX, chs, h, w)
        gap = x_r.sum(dim=1).mean(dim=(2, 3), keepdim=True)
        gap = torch.relu(self.bn(self.conv(gap, f"{p}.fc1"), f"{p}.bn1"))
        attn = self.conv(gap, f"{p}.fc2")
        # radix softmax over (groups=1, radix, chs), applied in the
        # (radix, groups, chs) flat order
        attn = attn.view(b, 1, _RADIX, -1).transpose(1, 2)
        attn = torch.softmax(attn, dim=1).reshape(b, _RADIX, chs, 1, 1)
        return (x_r * attn).sum(dim=1)

    def block(self, x, p, stride, skip):
        out = torch.relu(self.bn(self.conv(x, f"{p}.conv1"), f"{p}.bn1"))
        out = self.split_attn(out, f"{p}.conv2", 1)
        if stride > 1:  # avd: the stride in a 3x3 average pool after the conv
            out = F.avg_pool2d(out, 3, stride, 1, count_include_pad=True)
        out = self.bn(self.conv(out, f"{p}.conv3"), f"{p}.bn3")
        if skip:
            r = x
            if stride > 1:
                r = F.avg_pool2d(r, 2, stride, 0, ceil_mode=True, count_include_pad=False)
            r = self.bn(self.conv(r, f"{p}.downsample.1"), f"{p}.downsample.2")
        else:
            r = x
        return torch.relu(out + r)

    def backbone(self, x):
        x = torch.relu(self.bn(self.conv(x, "backbone.conv1.0", 2, 1), "backbone.conv1.1"))
        x = torch.relu(self.bn(self.conv(x, "backbone.conv1.3", 1, 1), "backbone.conv1.4"))
        x = self.conv(x, "backbone.conv1.6", 1, 1)
        x = torch.relu(self.bn(x, "backbone.bn1"))
        x = F.max_pool2d(x, 3, 2, 1)
        for p, _cin, _planes, stride, skip in _blocks(self.cfg["model"]):
            x = self.block(x, p, stride, skip)
        return x

    def matmul(self, a, b):
        return self.prec.product(torch.matmul, a, b)

    def xslot(self, k, v):
        """The xSlot loop (three iterations, renorm without epsilon, GRU);
        returns the last iteration's updates and attention."""
        P, cfg = self.P, self.cfg
        b, n, d = k.shape
        slots = P["slot.initial_slots"].expand(b, -1, d)
        s = slots.shape[1]
        scale = float(d) ** -0.5
        w_ih, w_hh = P["slot.gru.weight_ih_l0"], P["slot.gru.weight_hh_l0"]
        b_ih, b_hh = P["slot.gru.bias_ih_l0"], P["slot.gru.bias_hh_l0"]
        updates = attn = None
        for _ in range(cfg.get("iters", 3)):
            dots = self.matmul(slots, k.transpose(1, 2)) * scale
            dots = dots / dots.sum(dim=2, keepdim=True) * dots.sum(dim=(1, 2), keepdim=True)
            attn = torch.sigmoid(dots)
            updates = self.matmul(attn, v) / d
            x, h = updates.reshape(b * s, d), slots.reshape(b * s, d)
            gi = self.matmul(x, w_ih.T) + b_ih
            gh = self.matmul(h, w_hh.T) + b_hh
            i_r, i_z, i_n = gi.chunk(3, dim=-1)
            h_r, h_z, h_n = gh.chunk(3, dim=-1)
            r = torch.sigmoid(i_r + h_r)
            z = torch.sigmoid(i_z + h_z)
            nn_ = torch.tanh(i_n + r * h_n)
            slots = ((1.0 - z) * nn_ + z * h).reshape(b, s, d)
        return updates, attn

    def __call__(self, x):
        cfg, P = self.cfg, self.P
        feats = self.backbone(x).to(torch.float32)
        feats = torch.relu(self.conv(feats, "conv1x1", dt=torch.float32))
        b, d, fh, fw = feats.shape
        feats = feats.permute(0, 2, 3, 1)
        pe = sine_position_embedding(fh, fw, d, feats.device)
        inputs_x = feats.reshape(b, fh * fw, d)
        k = (feats + pe).reshape(b, fh * fw, d)
        for i in range(cfg["to_k_layer"]):
            if i > 0:
                k = torch.relu(k)
            k = self.matmul(k, P[f"slot.to_k.{2 * i}.weight"].T) + P[f"slot.to_k.{2 * i}.bias"]
        updates, attn = self.xslot(k, inputs_x)
        c, spc = cfg["num_classes"], cfg["slots_per_class"]
        pooled = updates.reshape(b, c, spc, d).sum(dim=2) if spc > 1 else updates
        logits = float(cfg["loss_status"]) * pooled.sum(dim=-1)
        area = torch.pow(attn.sum() / attn.numel(), float(cfg["power"]))
        return logits, area, attn


def sine_position_embedding(h: int, w: int, d: int, device) -> torch.Tensor:
    """DETR's normalised sine embedding, (h, w, d), channels [y, x]."""
    npf = d // 2
    f32 = dict(dtype=torch.float32, device=device)
    scale, eps = 2.0 * math.pi, 1e-6
    y = torch.arange(1, h + 1, **f32) / (float(h) + eps) * scale
    x = torch.arange(1, w + 1, **f32) / (float(w) + eps) * scale
    idx = torch.arange(npf, **f32)
    dim_t = torch.pow(torch.tensor(10000.0, **f32), 2.0 * torch.floor(idx / 2.0) / npf)

    def sincos(pos):
        return torch.stack([pos[..., 0::2].sin(), pos[..., 1::2].cos()], dim=-1).flatten(-2)

    pos_x = sincos(x[None, :, None] / dim_t).expand(h, w, npf)
    pos_y = sincos(y[:, None, None] / dim_t).expand(h, w, npf)
    return torch.cat([pos_y, pos_x], dim=-1)


def preprocess(images_u8: torch.Tensor, cfg: Dict) -> torch.Tensor:
    """uint8 (B, H, W, C) at the configured size -> normalised f32 NCHW."""
    if tuple(images_u8.shape[1:3]) != (cfg["img_size"],) * 2:
        raise ValueError(f"images of {tuple(images_u8.shape[1:3])}, the config serves "
                         f"{cfg['img_size']} px")
    mean, std = _NORM[cfg["dataset"]]
    x = images_u8.to(torch.float32)
    m = torch.tensor(mean, dtype=torch.float32, device=x.device) * 255.0
    s = torch.tensor(std, dtype=torch.float32, device=x.device) * 255.0
    return ((x - m) / s).permute(0, 3, 1, 2)


def forward(P: Dict[str, torch.Tensor], images_u8: torch.Tensor, cfg: Dict, *, train: bool,
            precision: Precision = EXACT):
    """(logits (B, C) f32, area loss, attention (B, S, N) f32)."""
    return _Net(P, cfg, train, precision)(preprocess(images_u8, cfg))


def loss_of(logits: torch.Tensor, area: torch.Tensor, labels: torch.Tensor,
            cfg: Dict) -> torch.Tensor:
    """Mean NLL of log_softmax plus lambda times the area loss."""
    log_probs = torch.log_softmax(logits.to(torch.float32), dim=1)
    nll = -log_probs.gather(1, labels.long()[:, None]).mean()
    return nll + float(cfg["lambda_value"]) * area.to(torch.float32)


def render_maps(attn: torch.Tensor, cfg: Dict) -> torch.Tensor:
    """(B, S, N) attention -> (B, C, side, side) uint8: slots summed per
    class, min-max scaled per sample over the whole set, truncated."""
    b, s, n = attn.shape
    c, spc = cfg["num_classes"], cfg["slots_per_class"]
    a = attn.to(torch.float32)
    if spc > 1:
        a = a.reshape(b, c, spc, n).sum(dim=2)
    lo = a.amin(dim=(1, 2), keepdim=True)
    hi = a.amax(dim=(1, 2), keepdim=True)
    scaled = (a - lo) / (hi - lo + 1e-12) * 255.0
    side = int(round(n ** 0.5))
    return scaled.reshape(b, c, side, side).to(torch.uint8)


def adamw_step(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
               state: Dict[int, Dict[str, torch.Tensor]], step: int, lr: float,
               betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.01) -> None:
    """One AdamW step in place (decoupled decay first, then the bias-corrected
    Adam update), ``step`` counting from 1."""
    b1, b2 = betas
    with torch.no_grad():
        for i, (p, g) in enumerate(zip(params, grads)):
            st = state.setdefault(i, {"m": torch.zeros_like(p), "v": torch.zeros_like(p)})
            p.mul_(1.0 - lr * weight_decay)
            st["m"].mul_(b1).add_(g, alpha=1.0 - b1)
            st["v"].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = (st["v"].sqrt() / math.sqrt(1.0 - b2 ** step)).add_(eps)
            p.addcdiv_(st["m"], denom, value=-lr / (1.0 - b1 ** step))
