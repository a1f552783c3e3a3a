"""Sampling noise schedule and churn (``buddy_tpu/sampling/schedule.py``).

Both are host constants (float32 numpy): the sampler reads them as Python
floats, so stepping costs no device round trip.
"""

from __future__ import annotations

import numpy as np


def create_schedule(T: int, *, sigma_min: float, sigma_max: float, rho: float,
                    schedule: str = "edm") -> np.ndarray:
    """EDM schedule: T+1 sigmas; index T-1 is sigma_min (the division is by
    T-1) and index T is overwritten with 0."""
    if schedule != "edm":
        raise NotImplementedError(f"schedule {schedule} not implemented")
    a = np.arange(0, T + 1, dtype=np.float64)
    t = (sigma_max ** (1 / rho)
         + a / (T - 1) * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))) ** rho
    t[-1] = 0.0
    return t.astype(np.float32)


def get_gamma(t: np.ndarray, *, Schurn: float, Stmin: float, Stmax: float) -> np.ndarray:
    """gamma_i = min(Schurn/N, sqrt(2)-1) where Stmin < t_i < Stmax, else 0;
    N is the schedule length T+1."""
    base = min(Schurn / t.shape[0], 2 ** 0.5 - 1)
    return np.where((t > Stmin) & (t < Stmax), base, 0.0).astype(t.dtype)
