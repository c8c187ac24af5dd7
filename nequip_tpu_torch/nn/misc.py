"""Small utility graph modules.

Port of ``ApplyFactor`` from ``nequip_tpu/nn/misc.py``.
"""

from __future__ import annotations

from typing import Optional

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
