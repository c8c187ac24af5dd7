"""Convolution layer: interaction block + gated equivariant nonlinearity.

Port of ``ConvNetLayer`` (``nequip_tpu/nn/convnetlayer.py``) with the gate
nonlinearity and without the rematerialisation options, including
CG-path-existence pruning of the hidden irreps and the gate parity rules.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ..data import _keys
from ..ops.gate import Gate
from ..ops.irreps import Irrep, Irreps, tp_path_exists
from .interaction_block import InteractionBlock
from .module import GraphModule


class ConvNetLayer(GraphModule):
    def __init__(
        self,
        irreps_in,
        feature_irreps_hidden,
        convolution_kwargs: Optional[Dict[str, Any]] = None,
        resnet: bool = False,
        nonlinearity_scalars: Dict[str, str] = {"e": "silu", "o": "tanh"},
        nonlinearity_gates: Dict[str, str] = {"e": "silu", "o": "tanh"},
    ):
        super().__init__()
        nl_scalars = {1: nonlinearity_scalars["e"], -1: nonlinearity_scalars["o"]}
        nl_gates = {1: nonlinearity_gates["e"], -1: nonlinearity_gates["o"]}
        self.feature_irreps_hidden = Irreps(feature_irreps_hidden)
        self._init_irreps(irreps_in=irreps_in, required_irreps_in=[_keys.NODE_FEATURES_KEY])

        edge_attr_irreps = self.irreps_in[_keys.EDGE_ATTRS_KEY]
        irreps_prev = self.irreps_in[_keys.NODE_FEATURES_KEY]
        irreps_scalars = Irreps(
            [mi for mi in self.feature_irreps_hidden
             if mi.ir.l == 0 and tp_path_exists(irreps_prev, edge_attr_irreps, mi.ir)]
        )
        irreps_gated = Irreps(
            [mi for mi in self.feature_irreps_hidden
             if mi.ir.l > 0 and tp_path_exists(irreps_prev, edge_attr_irreps, mi.ir)]
        )
        gate_ir = Irrep(0, 1) if tp_path_exists(irreps_prev, edge_attr_irreps, "0e") else Irrep(0, -1)
        irreps_gates = Irreps([(mi.mul, gate_ir) for mi in irreps_gated])
        self.equivariant_nonlin = Gate(
            irreps_scalars=irreps_scalars,
            act_scalars=[nl_scalars[mi.ir.p] for mi in irreps_scalars],
            irreps_gates=irreps_gates,
            act_gates=[nl_gates[mi.ir.p] for mi in irreps_gates],
            irreps_gated=irreps_gated,
        )
        conv_irreps_out = self.equivariant_nonlin.irreps_in.simplify()

        self.resnet = bool(resnet) and self.equivariant_nonlin.irreps_out == irreps_prev
        convolution_kwargs = dict(convolution_kwargs or {})
        self.conv = InteractionBlock(irreps_in=self.irreps_in, irreps_out=conv_irreps_out, **convolution_kwargs)
        self.irreps_out.update(self.conv.irreps_out)
        self.irreps_out[_keys.NODE_FEATURES_KEY] = self.equivariant_nonlin.irreps_out

    def forward(self, data: dict) -> dict:
        old_x = data[_keys.NODE_FEATURES_KEY]
        data = self.conv(data)
        x = self.equivariant_nonlin(data[_keys.NODE_FEATURES_KEY])
        if self.resnet:
            x = old_x + x
        data[_keys.NODE_FEATURES_KEY] = x
        return data
