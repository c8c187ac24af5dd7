"""Stress and virial label transforms.

Port of ``nequip_tpu/data/transforms/stress_utils.py`` (plain numpy).
"""

from __future__ import annotations

import numpy as np

from .. import _keys


class VirialToStressTransform:
    """stress = -virial / volume (sign convention: virial = -stress * V)."""

    def __call__(self, data: dict) -> dict:
        if _keys.VIRIAL_KEY not in data or _keys.CELL_KEY not in data:
            raise KeyError("VirialToStressTransform needs a virial and a cell")
        cell = np.asarray(data[_keys.CELL_KEY]).reshape(-1, 3, 3)
        vol = np.abs(np.linalg.det(cell)).reshape(-1, 1, 1)
        virial = np.asarray(data[_keys.VIRIAL_KEY]).reshape(-1, 3, 3)
        data[_keys.STRESS_KEY] = -virial / vol
        return data


class StressSignFlipTransform:
    """Flip the sign of stress labels (datasets with the opposite convention)."""

    def __call__(self, data: dict) -> dict:
        data[_keys.STRESS_KEY] = -np.asarray(data[_keys.STRESS_KEY])
        return data


class AddNaNStressTransform:
    """Give frames without stress labels NaN ones (losses that ignore NaNs mask them)."""

    def __call__(self, data: dict) -> dict:
        if _keys.STRESS_KEY not in data:
            data[_keys.STRESS_KEY] = np.full((1, 3, 3), np.nan)
        return data
