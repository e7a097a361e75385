"""K1's operations and bytes from its shapes: the least time one call of the
fused xSlot loop could take on a card, frozen here as the yardstick of
``k1_roofline.*``.

Forward: ``iters`` attention passes of two (S, N, d) products and
``iters`` - 1 GRUs of two (S, d) x (d, 3d) products per element, all f32,
against HBM over each input read once and each output written once, the
(B, iters, S, d) hist output included where the call writes it. Backward:
``iters`` attention recomputes (two products) and backwards (four),
``iters`` - 1 GRU recomputes (two) and backwards (four: dx, dh, dW_ih,
dW_hh), against k, v and the GRU weights (``elem`` bytes each: 2 for bf16
residuals), hist, du and dattn (f32) read once and dk, dv and the seven
parameter gradients written once. Both products run at the f32 rate: K1
computes in f32 whatever its inputs' dtype.
"""

from __future__ import annotations

__all__ = ["bwd_bound_s", "fwd_bound_s"]


def fwd_bound_s(b: int, n: int, s: int, d: int, peaks: dict, hist_iters: int = 0,
                iters: int = 3) -> float:
    flops = b * (iters * 2 * (2 * s * n * d) + (iters - 1) * 2 * (2 * s * d * 3 * d))
    nbytes = 4 * (2 * b * n * d + s * d + 2 * 3 * d * d + 2 * 3 * d + b * s * d + b * s * n
                  + b * hist_iters * s * d)
    return max(flops / peaks["float32"], nbytes / peaks["hbm_bytes_per_s"])


def bwd_bound_s(b: int, n: int, s: int, d: int, peaks: dict, iters: int = 3,
                elem: int = 4) -> float:
    flops = b * (iters * 6 * (2 * s * n * d) + (iters - 1) * 6 * (2 * s * d * 3 * d))
    nbytes = (elem * (2 * b * n * d + 2 * (3 * d * d + 3 * d) + 2 * b * n * d
                      + 2 * (3 * d * d + 3 * d) + s * d)
              + 4 * (b * iters * s * d + b * s * d + b * s * n))
    return max(flops / peaks["float32"], nbytes / peaks["hbm_bytes_per_s"])
