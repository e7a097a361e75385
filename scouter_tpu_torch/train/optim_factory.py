"""Optimizer factory (counterpart of ``scouter_tpu/train/optim_factory.py``,
timm's ``create_optimizer``).

:func:`create_optimizer` returns a ``torch.optim.Optimizer`` that computes
optax 0.2.6's arithmetic for each name, operation for operation, rather than
torch's built-in optimizer of the same name, whose eps placement, initial
accumulators and momentum placement differ:

- ``sgd``/``nesterov``/``momentum``: ``optax.sgd`` (a ``trace``, then the lr);
- ``adam``/``adamw``: ``scale_by_adam``; adamw adds ``wd * p`` after it;
- ``radam``: eps on the bias-corrected second moment, rectified from
  ``ro >= 5`` on (``optax.scale_by_radam``);
- ``rmsprop``/``rmsproptf``: eps inside the square root, the accumulator
  starting at 0 or 1, momentum a ``trace`` after the lr;
- ``adadelta``; ``adagrad``: the accumulator starts at 0.1;
- ``lamb``: adam, masked decay, the trust ratio, the lr;
- ``lars``: masked decay, the trust ratio (coefficient 0.001), the lr, a
  0.9 ``trace``;
- ``nadam``, ``novograd``, ``nvnovograd``: the JAX package's hand-written
  timm variants (``_timm_nadam``, ``_timm_novograd``, ``_timm_nvnovograd``);
- ``lookahead_<name>``: every k-th step the slow weights move by alpha toward
  the fast ones, and the fast weights jump to them.

Where the JAX package chains ``optax.add_decayed_weights`` in front (every
name but adamw, nadam, novograd, nvnovograd, lamb and lars), ``g + wd * p``
comes first. Parameters with ``ndim <= 1`` (biases, norm scales) sit in a
group with ``weight_decay=0`` (``no_decay_mask``); ``decay_mask=False`` is
the JAX package's ``params=None`` form, which decays every parameter.

The per-step scalars (bias corrections, RAdam's ``ro``, NAdam's momentum
schedule) are float32 numpy arithmetic, as XLA computes them; the tensors
go through ``torch._foreach_*`` lists, one call a stage for all parameters;
norms (the trust ratio, NovoGrad's moments) accumulate in float64.
Products and sums are separate calls, so no fused multiply-add rounds them
differently on the card, and ``1 / sqrt`` stands where optax writes
``rsqrt`` (``torch.rsqrt`` on the card is not correctly rounded). Step
counts and NAdam's schedule stay on the host as 0-d float64 tensors; the
per-tensor NovoGrad moments are 0-d tensors on the parameters' device.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Union

import numpy as np
import torch

__all__ = ["create_optimizer", "no_decay_mask"]

BASE_NAMES = ("sgd", "nesterov", "momentum", "adam", "adamw", "nadam", "radam", "rmsprop",
              "rmsproptf", "novograd", "nvnovograd", "adadelta", "adagrad", "lamb", "lars")
# names whose update applies the weight decay itself; the others get
# ``g + wd * p`` chained in front (``create_optimizer``'s add_decayed_weights)
_DECAY_INCLUDED = ("adamw", "nadam", "novograd", "nvnovograd", "lamb", "lars")
_HOST_SCALARS = ("step", "m_schedule")
_F32 = np.float32

Params = Union[Dict[str, torch.Tensor], Iterable[torch.Tensor]]


def no_decay_mask(params: Params):
    """True where weight decay applies (ndim > 1), for a dict of tensors
    (a dict back) or a sequence (a list back)."""
    if isinstance(params, dict):
        return {k: p.ndim > 1 for k, p in params.items()}
    return [p.ndim > 1 for p in params]


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay ** count`` in float32 (``optax.tree.bias_correction``)."""
    return float(_F32(1) - _F32(decay) ** _F32(count))


def _mul(xs, s):
    return torch._foreach_mul(xs, s)


def _add(xs, ys):
    return torch._foreach_add(xs, ys)


def _div(xs, ys):
    return torch._foreach_div(xs, ys)


def _sqrt(xs):
    return torch._foreach_sqrt(xs)


def _moment(g, t, decay: float, square: bool = False):
    """``(1 - decay) * g**order + decay * t`` (``optax.tree.update_moment``)."""
    gp = _mul(g, g) if square else g
    return _add(_mul(gp, 1.0 - decay), _mul(t, decay))


def _add_decay(u, p, wd: float):
    """``u + wd * p`` (``optax.add_decayed_weights``); nothing for wd 0."""
    return _add(u, _mul(p, wd)) if wd else u


def _norms(xs, squared: bool = False) -> torch.Tensor:
    """Each tensor's L2 norm (or its square) as one f32 vector, accumulated
    in float64: a correctly rounded value on the card and on the CPU alike,
    whose f32 reductions run in different orders (1e-4 apart on a 2.4M
    tensor)."""
    n = torch.stack(torch._foreach_norm(xs, 2, dtype=torch.float64))
    return (n * n if squared else n).to(torch.float32)


def _trust_ratio(u, p, coefficient: float = 1.0):
    """``optax.scale_by_trust_ratio``: ``u * coefficient * |p| / |u|``, a
    ratio of 1 where either norm is 0."""
    pn = _norms(p)
    un = _norms(u)
    ratio = (pn * coefficient if coefficient != 1.0 else pn) / un
    ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(ratio), ratio)
    return torch._foreach_mul(u, list(ratio.unbind()))


def _state_list(states, key, like, fill: float = 0.0):
    """``state[key]`` of each parameter, made like ``like``'s tensor (filled
    with ``fill``) where it is missing."""
    for st, p in zip(states, like):
        if key not in st:
            st[key] = torch.full_like(p, fill, memory_format=torch.preserve_format)
    return [st[key] for st in states]


def _scalar_list(states, key, device):
    """A 0-d tensor of ``state[key]`` per parameter, on ``device``."""
    for st in states:
        if key not in st:
            st[key] = torch.zeros((), device=device)
    return [st[key] for st in states]


def _set(dst: List[torch.Tensor], src: List[torch.Tensor]) -> None:
    torch._foreach_copy_(dst, src)


class FactoryOptimizer(torch.optim.Optimizer):
    """One optimizer of :func:`create_optimizer`'s names (``name``), as optax
    computes it. Each parameter group carries its ``weight_decay`` (0 for the
    no-decay group). ``chain_decay``: apply ``g + wd * p`` before the
    update (the names outside ``_DECAY_INCLUDED``). ``lookahead``: (k,
    alpha) or None."""

    def __init__(self, params, name: str, lr: float, weight_decay: float, momentum: float,
                 eps: float, lookahead: Optional[tuple] = None):
        if name not in BASE_NAMES:
            raise ValueError(f"unknown optimizer {name!r}")
        defaults = dict(lr=lr, weight_decay=weight_decay, momentum=momentum, eps=eps)
        super().__init__(params, defaults)
        self.name = name
        self.chain_decay = name not in _DECAY_INCLUDED
        self.lookahead = lookahead

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)
        # the base class moves every tensor but "step" to the parameter's
        # device and dtype; the host scalars go back to the host
        for st in self.state.values():
            for key in _HOST_SCALARS:
                if key in st:
                    st[key] = st[key].to("cpu", torch.float64)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            # parameters that have taken as many steps share the step's scalars
            by_count = defaultdict(list)
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if "step" not in st:
                    st["step"] = torch.zeros((), dtype=torch.float64)
                by_count[int(st["step"])].append(p)
            for count, params in by_count.items():
                self._step(group, params, count)
        return loss

    def _step(self, group, params, count: int) -> None:
        states = [self.state[p] for p in params]
        grads = [p.grad for p in params]
        wd = group["weight_decay"]
        if self.chain_decay:
            grads = _add_decay(grads, params, wd)
        t = count + 1
        updates = getattr(self, "_" + self.name)(group, params, grads, states, t)
        if self.lookahead is not None:
            updates = self._lookahead(params, updates, states, t)
        torch._foreach_add_(params, updates)
        for st in states:
            st["step"] += 1

    # -- optax's chains ------------------------------------------------------

    def _trace(self, u, states, nesterov: bool = False):
        """``optax.trace``: ``t = u + m * t``; ``u + m * t`` with Nesterov."""
        m = self.defaults["momentum"] if self.name != "lars" else 0.9
        trace = _state_list(states, "trace", u)
        new = _add(u, _mul(trace, m))
        _set(trace, new)
        return _add(u, _mul(new, m)) if nesterov else new

    def _sgd(self, group, params, g, states, t):
        return _mul(self._trace(g, states, nesterov=self.name in ("sgd", "nesterov")),
                    -group["lr"])

    _nesterov = _sgd

    def _momentum(self, group, params, g, states, t):
        return _mul(self._trace(g, states), -group["lr"])

    def _adam_scale(self, g, states, t, eps, b1=0.9, b2=0.999):
        """``optax.scale_by_adam``: ``m_hat / (sqrt(v_hat) + eps)``."""
        mu = _state_list(states, "mu", g)
        nu = _state_list(states, "nu", g)
        mu_new = _moment(g, mu, b1)
        nu_new = _moment(g, nu, b2, square=True)
        _set(mu, mu_new)
        _set(nu, nu_new)
        mu_hat = torch._foreach_div(mu_new, _bias_correction(b1, t))
        nu_hat = torch._foreach_div(nu_new, _bias_correction(b2, t))
        return _div(mu_hat, torch._foreach_add(_sqrt(nu_hat), eps))

    def _adam(self, group, params, g, states, t):
        return _mul(self._adam_scale(g, states, t, group["eps"]), -group["lr"])

    def _adamw(self, group, params, g, states, t):
        u = _add_decay(self._adam_scale(g, states, t, group["eps"]), params,
                       group["weight_decay"])
        return _mul(u, -group["lr"])

    def _lamb(self, group, params, g, states, t):
        u = _add_decay(self._adam_scale(g, states, t, group["eps"]), params,
                       group["weight_decay"])
        return _mul(_trust_ratio(u, params), -group["lr"])

    def _lars(self, group, params, g, states, t):
        u = _trust_ratio(_add_decay(g, params, group["weight_decay"]), params, 0.001)
        return self._trace(_mul(u, -group["lr"]), states)

    def _radam(self, group, params, g, states, t, b1=0.9, b2=0.999, threshold=5.0):
        mu = _state_list(states, "mu", g)
        nu = _state_list(states, "nu", g)
        mu_new = _moment(g, mu, b1)
        nu_new = _moment(g, nu, b2, square=True)
        _set(mu, mu_new)
        _set(nu, nu_new)
        mu_hat = torch._foreach_div(mu_new, _bias_correction(b1, t))
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = _F32(b2) ** _F32(t)
        ro = _F32(ro_inf) - _F32(2 * t) * b2t / (_F32(1) - b2t)
        if ro >= threshold:
            r = np.sqrt((ro - _F32(4)) * (ro - _F32(2)) * _F32(ro_inf)
                        / ((_F32(ro_inf) - _F32(4)) * (_F32(ro_inf) - _F32(2)) * ro))
            nu_hat = torch._foreach_div(nu_new, _bias_correction(b2, t))
            u = _div(_mul(mu_hat, float(r)), torch._foreach_add(_sqrt(nu_hat), group["eps"]))
        else:
            u = mu_hat
        return _mul(u, -group["lr"])

    def _rmsprop(self, group, params, g, states, t, decay=0.9):
        nu = _state_list(states, "nu", g, 1.0 if self.name == "rmsproptf" else 0.0)
        nu_new = _moment(g, nu, decay, square=True)
        _set(nu, nu_new)
        scale = torch._foreach_reciprocal(_sqrt(torch._foreach_add(nu_new, group["eps"])))
        return self._trace(_mul(torch._foreach_mul(scale, g), -group["lr"]), states)

    _rmsproptf = _rmsprop

    def _adadelta(self, group, params, g, states, t, rho=0.9):
        eps = group["eps"]
        e_g = _state_list(states, "e_g", g)
        e_x = _state_list(states, "e_x", g)
        e_g_new = _moment(g, e_g, rho, square=True)
        u = torch._foreach_mul(_div(_sqrt(torch._foreach_add(e_x, eps)),
                                    _sqrt(torch._foreach_add(e_g_new, eps))), g)
        _set(e_x, _moment(u, e_x, rho, square=True))
        _set(e_g, e_g_new)
        return _mul(u, -group["lr"])

    def _adagrad(self, group, params, g, states, t):
        acc = _state_list(states, "sum_of_squares", g, 0.1)
        acc_new = _add(_mul(g, g), acc)
        _set(acc, acc_new)
        # rsqrt(acc + eps) where acc > 0, else 0: acc >= 0, so its sign masks
        inv = _mul(torch._foreach_reciprocal(_sqrt(torch._foreach_add(acc_new, group["eps"]))),
                   torch._foreach_sign(acc_new))
        return _mul(torch._foreach_mul(inv, g), -group["lr"])

    # -- the JAX package's timm variants ------------------------------------

    def _nadam(self, group, params, g, states, t, b1=0.9, b2=0.999, schedule_decay=4e-3):
        lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
        tf = _F32(t)
        mc_t = _F32(b1) * (_F32(1) - _F32(0.5) * _F32(0.96) ** (tf * _F32(schedule_decay)))
        mc_t1 = _F32(b1) * (_F32(1) - _F32(0.5) * _F32(0.96) ** ((tf + _F32(1))
                                                                 * _F32(schedule_decay)))
        for st in states:
            if "m_schedule" not in st:
                st["m_schedule"] = torch.ones((), dtype=torch.float64)
        msched_new = _F32(float(states[0]["m_schedule"])) * mc_t
        msched_next = msched_new * mc_t1
        g = _add_decay(g, params, wd)
        m = _state_list(states, "exp_avg", g)
        v = _state_list(states, "exp_avg_sq", g)
        m_new = _add(_mul(m, b1), _mul(g, 1.0 - b1))
        v_new = _add(_mul(v, b2), _mul(_mul(g, 1.0 - b2), g))
        _set(m, m_new)
        _set(v, v_new)
        denom = torch._foreach_add(_sqrt(torch._foreach_div(v_new, _bias_correction(b2, t))),
                                   eps)
        c1 = _F32(-lr) * (_F32(1) - mc_t) / (_F32(1) - msched_new)
        c2 = _F32(lr) * mc_t1 / (_F32(1) - msched_next)
        first = _div(_mul(g, float(c1)), denom)
        second = _div(_mul(m_new, float(c2)), denom)
        for st in states:
            st["m_schedule"].fill_(float(msched_new))
        return torch._foreach_sub(first, second)

    def _novograd(self, group, params, g, states, t, b1=0.95, b2=0.98):
        lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
        device = g[0].device
        g2_raw = _norms(g, squared=True)
        v = _scalar_list(states, "v", device)
        gema = _scalar_list(states, "grad_ema", device)
        m = _state_list(states, "m", g)
        wp = _mul(params, wd) if wd else None
        if t == 1:  # the first gradient seeds v and m (novograd.py:31-46)
            v_in = g2_raw
            m_in = _div(g, list((torch.sqrt(g2_raw) + eps).unbind()))
            if wp is not None:
                m_in = _add(m_in, wp)
            gema_new = g2_raw
        else:
            v_in, m_in = torch.stack(v), m
            gema_new = torch.stack(gema) * b2 + g2_raw * (1.0 - b2)
        gn = _div(g, list((torch.sqrt(gema_new) + eps).unbind()))
        g2 = _norms(gn, squared=True)
        v_new = v_in * b2 + g2 * (1.0 - b2)
        step = _div(gn, list((torch.sqrt(v_new) + eps).unbind()))
        if wp is not None:
            step = _add(step, wp)
        m_new = _add(_mul(m_in, b1), step)
        _set(m, m_new)
        _set(v, list(v_new.unbind()))
        _set(gema, list(gema_new.unbind()))
        step_size = _F32(lr) * np.sqrt(_F32(1) - _F32(b2) ** _F32(t)) / (
            _F32(1) - _F32(b1) ** _F32(t))
        return _mul(m_new, -float(step_size))

    def _nvnovograd(self, group, params, g, states, t, b1=0.95, b2=0.98):
        lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
        norm = _norms(g, squared=True)
        vsq = _scalar_list(states, "exp_avg_sq", g[0].device)
        vsq_new = norm if t == 1 else torch.stack(vsq) * b2 + norm * (1.0 - b2)
        gn = _div(g, list((torch.sqrt(vsq_new) + eps).unbind()))
        gn = _add_decay(gn, params, wd)
        m = _state_list(states, "exp_avg", g)
        m_new = _add(_mul(m, b1), gn)
        _set(m, m_new)
        _set(vsq, list(vsq_new.unbind()))
        return _mul(m_new, -lr)

    def _lookahead(self, params, updates, states, t):
        """Every k-th update the slow weights move by alpha toward the fast
        ones (``p + u``) and the update takes the parameters to them."""
        k, alpha = self.lookahead
        for st, p in zip(states, params):
            if "slow" not in st:
                st["slow"] = p.detach().clone()
        slow = [st["slow"] for st in states]
        if t % k:
            return updates
        fast = _add(params, updates)
        new_slow = _add(slow, _mul(torch._foreach_sub(fast, slow), alpha))
        _set(slow, new_slow)
        return torch._foreach_sub(new_slow, params)


def _groups(params: Params, weight_decay: float, decay_mask: bool):
    tensors = list(params.values()) if isinstance(params, dict) else list(params)
    if not tensors:
        raise ValueError("create_optimizer got no parameters")
    if not decay_mask:
        return [{"params": tensors, "weight_decay": weight_decay}]
    mask = no_decay_mask(tensors)
    groups = [{"params": [p for p, m in zip(tensors, mask) if m], "weight_decay": weight_decay},
              {"params": [p for p, m in zip(tensors, mask) if not m], "weight_decay": 0.0}]
    return [g for g in groups if g["params"]]


def create_optimizer(opt: str = "adamw", lr: float = 1e-4, weight_decay: float = 0.0,
                     momentum: float = 0.9, eps: float = 1e-8, params: Optional[Params] = None,
                     lookahead_sync_period: int = 6, lookahead_slow_step: float = 0.5, *,
                     decay_mask: bool = True) -> FactoryOptimizer:
    """The optimizer named ``opt`` (timm's names, optionally
    ``lookahead_<name>``) over ``params`` (a dict of tensors or a sequence),
    as the JAX package's ``create_optimizer(..., params=...)`` builds it.

    ``decay_mask=False`` decays every parameter, as the JAX package does
    when it is given no ``params``. ``params`` is required: a torch
    optimizer holds its parameters."""
    if params is None:
        raise TypeError("create_optimizer needs params: a torch optimizer holds its parameters")
    name = opt.lower()
    lookahead = None
    if name.startswith("lookahead_"):
        name = name[len("lookahead_"):]
        lookahead = (int(lookahead_sync_period), float(lookahead_slow_step))
    return FactoryOptimizer(_groups(params, weight_decay, decay_mask), name, lr, weight_decay,
                            momentum, eps, lookahead)
