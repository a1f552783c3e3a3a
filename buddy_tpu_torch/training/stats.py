"""Training statistics (the reference's training_stats API), numpy only.

A copy of ``buddy_tpu/training/stats.py`` (the port imports nothing of the
JAX package).  ``report(name, value)`` accumulates [count, sum,
sum-of-squares] moments under a name, ``report_moments`` injects moments
computed elsewhere (the trainer's accumulator, summed on the device between
log intervals), and a ``Collector`` exposes their mean and std.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict

import numpy as np

_NUM_MOMENTS = 3

_counters: Dict[str, list] = defaultdict(list)


def report(name: str, value) -> None:
    """Accumulate [n, sum(x), sum(x^2)] for a named statistic
    (training_stats.py:54-97)."""
    x = np.asarray(value, np.float32).reshape(-1)
    moments = np.stack([np.float32(x.size), np.sum(x), np.sum(x * x)])
    _counters[name].append(moments)


def report_moments(name: str, *, n: float, total: float, total_sq: float) -> None:
    """Inject precomputed [n, sum, sum-of-squares] moments: the trainer sums
    its metrics on the device and feeds them here once per log interval,
    instead of reporting raw values with a host sync every step."""
    _counters[name].append(np.asarray([n, total, total_sq], np.float64))


def report0(name: str, value) -> None:
    """Report on rank 0 only (training_stats.py:101); single-process here."""
    report(name, value)


class Collector:
    """Snapshot + query accumulated statistics (training_stats.py:111-209)."""

    def __init__(self, regex: str = ".*", keep_previous: bool = True):
        import re
        self._regex = re.compile(regex)
        self._keep_previous = keep_previous
        self._moments: Dict[str, np.ndarray] = {}
        self.update()

    def names(self):
        return [n for n in _counters if self._regex.fullmatch(n)]

    def update(self) -> None:
        if not self._keep_previous:
            self._moments.clear()
        for name in self.names():
            pending = _counters.pop(name, [])
            if not pending:
                continue
            total = np.sum(np.stack([np.asarray(m) for m in pending]), axis=0)
            prev = self._moments.get(name, np.zeros(_NUM_MOMENTS, np.float64))
            self._moments[name] = (prev + total) if self._keep_previous else total

    def _get(self, name: str) -> np.ndarray:
        return self._moments.get(name, np.zeros(_NUM_MOMENTS, np.float64))

    def num(self, name: str) -> int:
        return int(self._get(name)[0])

    def mean(self, name: str) -> float:
        m = self._get(name)
        return float(m[1] / m[0]) if m[0] > 0 else float("nan")

    def std(self, name: str) -> float:
        m = self._get(name)
        if m[0] <= 1:
            return 0.0 if m[0] == 1 else float("nan")
        mean = m[1] / m[0]
        return float(np.sqrt(max(m[2] / m[0] - mean ** 2, 0.0)))

    def as_dict(self) -> dict:
        return {n: {"num": self.num(n), "mean": self.mean(n), "std": self.std(n)}
                for n in self._moments}


default_collector = Collector(keep_previous=False)
