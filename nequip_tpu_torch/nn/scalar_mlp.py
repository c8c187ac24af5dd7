"""Graph-module wrapper around scalar MLPs.

Port of ``nequip_tpu/nn/scalar_mlp.py``.
"""

from __future__ import annotations

from typing import Optional

from ..data import _keys
from ..ops.irreps import Irreps
from ..ops.mlp import ScalarMLP as ScalarMLPFunction
from .module import GraphModule


class ScalarMLP(GraphModule):
    """Apply an MLP to a scalar (0e) field."""

    _jax_transparent = ("mlp",)

    def __init__(
        self,
        output_dim: int,
        hidden_layers_depth: int = 0,
        hidden_layers_width: Optional[int] = None,
        nonlinearity: Optional[str] = "silu",
        bias: bool = False,
        forward_weight_init: bool = True,
        init_mode: str = "uniform",
        parametrization: Optional[str] = None,
        field: str = _keys.NODE_FEATURES_KEY,
        out_field: Optional[str] = None,
        irreps_in=None,
    ):
        super().__init__()
        self.field = field
        self.out_field = out_field if out_field is not None else field
        self._init_irreps(irreps_in=irreps_in, required_irreps_in=[field])
        in_irreps = self.irreps_in[field]
        if len(in_irreps) != 1 or in_irreps[0].ir.l != 0 or in_irreps[0].ir.p != 1:
            raise ValueError(f"ScalarMLP input must be 0e scalars, got {in_irreps}")
        self.mlp = ScalarMLPFunction(
            input_dim=in_irreps[0].mul,
            output_dim=output_dim,
            hidden_layers_depth=hidden_layers_depth,
            hidden_layers_width=hidden_layers_width,
            nonlinearity=nonlinearity,
            bias=bias,
            forward_weight_init=forward_weight_init,
            init_mode=init_mode,
            parametrization=parametrization,
        )
        self.irreps_out[self.out_field] = Irreps([(self.mlp.output_dim, (0, 1))])

    def forward(self, data: dict) -> dict:
        data = dict(data)
        data[self.out_field] = self.mlp(data[self.field])
        return data
