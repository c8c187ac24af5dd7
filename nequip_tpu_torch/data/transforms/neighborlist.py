"""Neighbour-list transforms (host-side data pipeline stages).

Port of ``nequip_tpu/data/transforms/neighborlist.py`` on the port's
neighbour-list backends (``data/neighborlist.py``).
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np

from .. import _keys
from ..neighborlist import DEFAULT_BACKEND, compute_neighborlist_


class NeighborListTransform:
    """Build the full directed neighbour list at ``r_max`` with ``backend``."""

    def __init__(self, r_max: float, backend: str = DEFAULT_BACKEND):
        self.r_max = float(r_max)
        self.backend = backend

    def __call__(self, data: dict) -> dict:
        return compute_neighborlist_(data, self.r_max, backend=self.backend)


class NeighborListPruneTransform:
    """Drop the edges beyond their per-edge-type cutoff (center -> neighbour
    type, as the model's ``per_edge_type_cutoff``), which shrinks the edge
    capacity the loader pads to."""

    def __init__(
        self,
        per_edge_type_cutoff: Dict[str, Union[float, Dict[str, float]]],
        type_names,
        r_max: float,
    ):
        from ...nn.embedding.utils import cutoff_dict_to_matrix

        self._cutoff_matrix = cutoff_dict_to_matrix(per_edge_type_cutoff, list(type_names), r_max)

    def __call__(self, data: dict) -> dict:
        ei = data[_keys.EDGE_INDEX_KEY]
        types = np.asarray(data[_keys.ATOM_TYPE_KEY]).reshape(-1)
        pos = data[_keys.POSITIONS_KEY]
        vec = pos[ei[1]] - pos[ei[0]]
        if _keys.EDGE_CELL_SHIFT_KEY in data:
            cell = np.asarray(data[_keys.CELL_KEY]).reshape(3, 3)
            vec = vec + data[_keys.EDGE_CELL_SHIFT_KEY] @ cell
        keep = np.linalg.norm(vec, axis=1) <= self._cutoff_matrix[types[ei[0]], types[ei[1]]]
        for k in [k for k in data if k.startswith(_keys.EDGE_LAYOUT_KEY_PREFIX)]:
            del data[k]  # a kernel layout of the old edges is stale
        data[_keys.EDGE_INDEX_KEY] = ei[:, keep]
        if _keys.EDGE_CELL_SHIFT_KEY in data:
            data[_keys.EDGE_CELL_SHIFT_KEY] = data[_keys.EDGE_CELL_SHIFT_KEY][keep]
        return data


class SortedNeighborListTransform(NeighborListTransform):
    """The neighbour list sorted by (dst, src), with the permutation that
    sorts it by (src, dst) under ``edge_transpose_perm``."""

    def __call__(self, data: dict) -> dict:
        data = super().__call__(data)
        ei = data[_keys.EDGE_INDEX_KEY]
        order = np.lexsort((ei[1], ei[0]))
        ei = ei[:, order]
        data[_keys.EDGE_INDEX_KEY] = ei
        if _keys.EDGE_CELL_SHIFT_KEY in data:
            data[_keys.EDGE_CELL_SHIFT_KEY] = data[_keys.EDGE_CELL_SHIFT_KEY][order]
        data[_keys.EDGE_TRANSPOSE_PERM_KEY] = np.lexsort((ei[0], ei[1])).astype(np.int32)
        return data
