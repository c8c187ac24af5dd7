"""Neighbour-list transform (host-side data pipeline stage).

Port of ``NeighborListTransform`` (``nequip_tpu/data/transforms/neighborlist.py``)
on the port's scipy kdtree neighbour list.
"""

from __future__ import annotations

from ..neighborlist import compute_neighborlist_


class NeighborListTransform:
    """Build the full directed neighbour list at ``r_max``."""

    def __init__(self, r_max: float):
        self.r_max = float(r_max)

    def __call__(self, data: dict) -> dict:
        return compute_neighborlist_(data, self.r_max)
