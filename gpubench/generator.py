"""The traffic generator: arrival times and image choices from a traffic
mix's parameters and the seed.

- ``arrivals``: Poisson arrivals at ``rate_img_s`` over a window.
- ``picks``: which image of the seeded pool each request sends.

The same parameters and seed give the same schedule.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["arrivals", "picks"]


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2**63, stream])


def arrivals(params: Dict, seconds: float, seed: int) -> np.ndarray:
    """Sorted send times, in seconds from the window's start, all below
    ``seconds``."""
    rng = _rng(seed, 11)
    n = rng.poisson(float(params["rate_img_s"]) * seconds)
    return np.sort(rng.uniform(0.0, seconds, n))


def picks(n: int, pool: int, seed: int) -> np.ndarray:
    """The pool index of each of ``n`` requests."""
    return _rng(seed, 12).integers(0, pool, n)
