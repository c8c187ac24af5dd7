"""A finite cell for frames without one.

Port of ``nequip_tpu/data/transforms/cell_utils.py``: mixed periodic and
non-periodic batches then have well-defined volumes (non-periodic stress
labels are NaN and masked in the loss).
"""

from __future__ import annotations

import numpy as np

from .. import _keys


class NonPeriodicCellTransform:
    """A box of the frame's extent plus ``vacuum`` on each axis, pbc off,
    for frames whose cell is missing or zero."""

    def __init__(self, vacuum: float = 100.0):
        self.vacuum = float(vacuum)

    def __call__(self, data: dict) -> dict:
        if _keys.CELL_KEY in data and np.abs(np.asarray(data[_keys.CELL_KEY])).sum() > 0:
            return data
        pos = np.asarray(data[_keys.POSITIONS_KEY])
        extent = pos.max(axis=0) - pos.min(axis=0) + self.vacuum
        data[_keys.CELL_KEY] = np.diag(extent).reshape(1, 3, 3)
        data[_keys.PBC_KEY] = np.zeros((1, 3), dtype=bool)
        return data
