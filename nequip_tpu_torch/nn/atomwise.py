"""Per-type scale/shift and per-frame energy sum.

Port of ``PerTypeScaleShift`` and ``AtomwiseReduce`` from
``nequip_tpu/nn/atomwise.py``.  The scale/shift runs in the global dtype
(float64); padded nodes are masked out of the frame sum.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..data import _keys
from ..data._key_registry import get_field_type
from ..ops.irreps import Irreps
from ..ops.scatter import scatter_sum
from ..utils.dtype import GLOBAL_DTYPE
from .module import GraphModule


class AtomwiseReduce(GraphModule):
    """Sum a node field into a per-frame field (padded nodes masked out)."""

    def __init__(self, field: str, out_field: str, irreps_in=None):
        super().__init__()
        self.field = field
        self.out_field = out_field
        irreps_in = irreps_in or {}
        self._init_irreps(
            irreps_in=irreps_in,
            irreps_out={self.out_field: irreps_in[field]} if field in irreps_in else {},
        )

    def forward(self, data: dict) -> dict:
        field = data[self.field]
        num_frames = data[_keys.NUM_NODES_KEY].shape[0]
        batch = data[_keys.BATCH_KEY].reshape(-1)
        mask = data.get(_keys.NODE_MASK_KEY)
        data = dict(data)
        data[self.out_field] = scatter_sum(field, batch, num_frames, mask=mask)
        return data


class PerTypeScaleShift(GraphModule):
    """out = shift[type] + scale[type] * in, computed in float64."""

    def __init__(
        self,
        type_names: List[str],
        field: str,
        out_field: Optional[str] = None,
        scales: Optional[Union[float, Dict[str, float]]] = None,
        shifts: Optional[Union[float, Dict[str, float]]] = None,
        irreps_in=None,
    ):
        super().__init__()
        self.type_names = list(type_names)
        self.num_types = len(type_names)
        self.field = field
        self.out_field = field if out_field is None else out_field
        if get_field_type(self.field) != "node" or get_field_type(self.out_field) != "node":
            raise ValueError("PerTypeScaleShift acts on node fields")
        self._init_irreps(
            irreps_in=irreps_in,
            my_irreps_in={self.field: Irreps("1x0e")},
            irreps_out={self.out_field: Irreps(irreps_in[self.field])},
        )
        for name, v in (("scales", scales), ("shifts", shifts)):
            if v is None:
                setattr(self, name, None)
                continue
            if isinstance(v, (int, float)):
                vals = np.array([float(v)])
            elif isinstance(v, dict):
                if set(self.type_names) != set(v):
                    raise ValueError(f"per-type {name} must cover type_names {self.type_names}")
                vals = np.array([float(v[k]) for k in self.type_names])
            else:
                raise TypeError(f"{name} must be a float or a dict over type_names")
            self.register_buffer(name, torch.as_tensor(vals.reshape(-1, 1), dtype=GLOBAL_DTYPE))

    def forward(self, data: dict) -> dict:
        x = data[self.field].to(GLOBAL_DTYPE)
        types = data[_keys.ATOM_TYPE_KEY].reshape(-1)

        def lookup(v):
            return v if v.shape[0] == 1 else v[types]

        if self.scales is not None:
            x = lookup(self.scales) * x
        if self.shifts is not None:
            x = lookup(self.shifts) + x
        data = dict(data)
        data[self.out_field] = x
        return data
