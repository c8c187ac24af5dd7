"""Small utility graph modules.

Port of ``nequip_tpu/nn/misc.py``: ``ApplyFactor``, ``Concat`` and
``SaveForOutput``.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..ops.irreps import Irreps
from .module import GraphModule


class ApplyFactor(GraphModule):
    """Multiply a field by a constant (e.g. the 2*pi/r_max^2 Bessel factor)."""

    def __init__(self, in_field: str, factor: float, out_field: Optional[str] = None, irreps_in=None):
        super().__init__()
        self.in_field = in_field
        self.out_field = out_field if out_field is not None else in_field
        self.factor = float(factor)
        self._init_irreps(
            irreps_in=irreps_in,
            required_irreps_in=[in_field],
            irreps_out={self.out_field: (irreps_in or {}).get(in_field)},
        )

    def forward(self, data: dict) -> dict:
        data = dict(data)
        data[self.out_field] = data[self.in_field] * self.factor
        return data


class Concat(GraphModule):
    """Concatenate fields along the feature dimension into ``out_field``."""

    def __init__(self, in_fields: List[str], out_field: str, irreps_in=None):
        super().__init__()
        self.in_fields = list(in_fields)
        self.out_field = out_field
        self._init_irreps(irreps_in=irreps_in, required_irreps_in=self.in_fields)
        irreps = Irreps()
        for f in self.in_fields:
            irreps = irreps + self.irreps_in[f]
        self.irreps_out[self.out_field] = irreps

    def forward(self, data: dict) -> dict:
        data = dict(data)
        data[self.out_field] = torch.cat([data[f] for f in self.in_fields], dim=-1)
        return data


class SaveForOutput(GraphModule):
    """Copy a field to another name, so that later modules cannot overwrite it."""

    def __init__(self, field: str, out_field: str, irreps_in=None):
        super().__init__()
        self.field = field
        self.out_field = out_field
        self._init_irreps(irreps_in=irreps_in, required_irreps_in=[field],
                          irreps_out={out_field: (irreps_in or {}).get(field)})

    def forward(self, data: dict) -> dict:
        data = dict(data)
        data[self.out_field] = data[self.field]
        return data
