"""Neighbour-list transform (host-side data pipeline stage).

Port of ``NeighborListTransform`` (``nequip_tpu/data/transforms/neighborlist.py``)
on the port's neighbour-list backends (``data/neighborlist.py``).
"""

from __future__ import annotations

from ..neighborlist import DEFAULT_BACKEND, compute_neighborlist_


class NeighborListTransform:
    """Build the full directed neighbour list at ``r_max`` with ``backend``."""

    def __init__(self, r_max: float, backend: str = DEFAULT_BACKEND):
        self.r_max = float(r_max)
        self.backend = backend

    def __call__(self, data: dict) -> dict:
        return compute_neighborlist_(data, self.r_max, backend=self.backend)
