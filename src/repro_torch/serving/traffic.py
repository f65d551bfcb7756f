"""Arrival processes for serving: the deterministic and Poisson generators
of ``repro/serving/traffic.py``.  The multi-tenant traffic layer over the
store (``materialize``, ``serve``, ``serve_grid``) waits for the
traffic/admission slice (ROADMAP queue 1, item 4)."""

from __future__ import annotations

import numpy as np


def deterministic_arrivals(n: int, rate_ops_s: float) -> np.ndarray:
    """Fixed-interval offsets from 0: op i arrives at ``i / rate``."""
    return np.arange(n, dtype=np.float64) / rate_ops_s


def poisson_arrivals(n: int, rate_ops_s: float,
                     rng: np.random.Generator) -> np.ndarray:
    """Poisson process offsets: i.i.d. exponential interarrivals."""
    return np.cumsum(rng.exponential(1.0 / rate_ops_s, size=n))
