"""Streaming (single-pass, batch-size-invariant) statistics accumulators.

Port of ``nequip_tpu/data/stats.py``: (count, sum, sum of squares, extrema)
accumulators in float64 on the host.
"""

from __future__ import annotations

import numpy as np


class _Accumulator:
    def __init__(self):
        self.count = 0.0
        self.total = 0.0
        self.total_sq = 0.0
        self.maximum = -np.inf
        self.minimum = np.inf

    def update(self, values: np.ndarray) -> None:
        values = np.asarray(values, dtype=np.float64).reshape(-1)
        values = values[np.isfinite(values)]
        if values.size == 0:
            return
        self.count += values.size
        self.total += values.sum()
        self.total_sq += (values**2).sum()
        self.maximum = max(self.maximum, values.max())
        self.minimum = min(self.minimum, values.min())

    def compute(self) -> float:
        raise NotImplementedError


class Mean(_Accumulator):
    def compute(self) -> float:
        return self.total / max(self.count, 1.0)


class RootMeanSquare(_Accumulator):
    def compute(self) -> float:
        return float(np.sqrt(self.total_sq / max(self.count, 1.0)))


class StandardDeviation(_Accumulator):
    def __init__(self, unbiased: bool = True):
        super().__init__()
        self.unbiased = unbiased

    def compute(self) -> float:
        n = max(self.count, 1.0)
        var = self.total_sq / n - (self.total / n) ** 2
        if self.unbiased and self.count > 1:
            var = var * self.count / (self.count - 1)
        return float(np.sqrt(max(var, 0.0)))


class Max(_Accumulator):
    def compute(self) -> float:
        return float(self.maximum)


class Min(_Accumulator):
    def compute(self) -> float:
        return float(self.minimum)


class Count(_Accumulator):
    def compute(self) -> float:
        return float(self.count)


STAT_CLASSES = {
    "mean": Mean,
    "rms": RootMeanSquare,
    "std": StandardDeviation,
    "max": Max,
    "min": Min,
    "count": Count,
}
