"""Average-number-of-neighbours feature normalisation.

Port of ``nequip_tpu/nn/norm.py``: multiply node features by
``1/sqrt(avg_num_neighbors)``, globally or per atom type.
"""

from __future__ import annotations

from math import sqrt
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from ..data import _keys
from .module import GraphModule


class AvgNumNeighborsNorm(GraphModule):
    def __init__(
        self,
        avg_num_neighbors: Union[float, Dict[str, float]],
        type_names: Optional[Sequence[str]] = None,
        irreps_in=None,
    ):
        super().__init__()
        if avg_num_neighbors is None:
            raise ValueError("avg_num_neighbors must be specified")
        if isinstance(avg_num_neighbors, (int, float)):
            consts = [float(avg_num_neighbors)]
        elif isinstance(avg_num_neighbors, dict):
            if type_names is None or set(type_names) != set(avg_num_neighbors):
                raise ValueError("per-type avg_num_neighbors must cover type_names")
            consts = [float(avg_num_neighbors[k]) for k in type_names]
        else:
            raise TypeError("avg_num_neighbors must be a float or dict")
        self._norm_const = [1.0 / sqrt(n) for n in consts]
        self._tables: Dict[Tuple[torch.dtype, torch.device], torch.Tensor] = {}  # per-type table, per device
        self._init_irreps(irreps_in=irreps_in)

    def forward(self, data: dict) -> dict:
        feats = data[_keys.NODE_FEATURES_KEY]
        data = dict(data)
        if len(self._norm_const) == 1:
            data[_keys.NODE_FEATURES_KEY] = feats * self._norm_const[0]
            return data
        key = (feats.dtype, feats.device)
        if key not in self._tables:
            self._tables[key] = torch.tensor(self._norm_const, dtype=feats.dtype, device=feats.device)
        table = self._tables[key]
        data[_keys.NODE_FEATURES_KEY] = table[data[_keys.ATOM_TYPE_KEY].reshape(-1)].unsqueeze(-1) * feats
        return data
