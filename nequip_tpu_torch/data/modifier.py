"""Field modifiers: extract or derive quantities from AtomicDataDicts for
statistics and metrics.

Port of ``nequip_tpu/data/modifier.py``.  Modifiers work on host (numpy)
and torch dicts alike.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _keys
from ._key_registry import get_field_type


class BaseModifier:
    def __init__(self, field: str):
        self.field = field

    def __call__(self, data: dict):
        return data[self.field]

    @property
    def name(self) -> str:
        return self.field

    @property
    def field_type(self) -> str:
        return get_field_type(self.field)


class PerAtomModifier(BaseModifier):
    """Normalise a per-frame field by the number of atoms (e.g. E/N)."""

    def __call__(self, data: dict):
        v = data[self.field]
        n = data[_keys.NUM_NODES_KEY].reshape(-1, *([1] * (v.ndim - 1)))
        if isinstance(v, torch.Tensor):
            return v / torch.clamp(n, min=1).to(v.dtype)
        return v / np.maximum(n, 1)

    @property
    def name(self) -> str:
        return f"per_atom_{self.field}"


class MappedFieldModifier(BaseModifier):
    """Read another key than the nominal field name (a prediction or target
    stored under another name)."""

    def __init__(self, field: str, mapped_field: str):
        super().__init__(field)
        self.mapped_field = mapped_field

    def __call__(self, data: dict):
        return data[self.mapped_field]


class EdgeLengths(BaseModifier):
    """Edge lengths ``[E, 1]``: the stored field, or computed on the host
    from the positions, the edge index and the cell shifts."""

    def __init__(self):
        super().__init__(_keys.EDGE_LENGTH_KEY)

    def __call__(self, data: dict):
        if _keys.EDGE_LENGTH_KEY in data:
            return data[_keys.EDGE_LENGTH_KEY]
        pos = np.asarray(data[_keys.POSITIONS_KEY])
        ei = np.asarray(data[_keys.EDGE_INDEX_KEY])
        vec = pos[ei[1]] - pos[ei[0]]
        if _keys.CELL_KEY in data:
            cell = np.asarray(data[_keys.CELL_KEY])
            batch = np.asarray(data.get(_keys.BATCH_KEY, np.zeros(len(pos), dtype=int)))
            vec = vec + np.einsum("ei,eij->ej", np.asarray(data[_keys.EDGE_CELL_SHIFT_KEY]), cell[batch[ei[0]]])
        return np.linalg.norm(vec, axis=1, keepdims=True)

    @property
    def name(self) -> str:
        return "edge_lengths"

    @property
    def field_type(self) -> str:
        return "edge"


class NumNeighbors(BaseModifier):
    """Per-node neighbour counts of a host frame (for avg_num_neighbors)."""

    def __init__(self):
        super().__init__("num_neighbors")

    def __call__(self, data: dict):
        ei = np.asarray(data[_keys.EDGE_INDEX_KEY])
        n = np.asarray(data[_keys.POSITIONS_KEY]).shape[0]
        return np.bincount(ei[0], minlength=n).astype(np.float64).reshape(-1, 1)

    @property
    def field_type(self) -> str:
        return "node"
