"""Convolution layer: interaction block + equivariant nonlinearity.

Port of ``ConvNetLayer`` (``nequip_tpu/nn/convnetlayer.py``), including
CG-path-existence pruning of the hidden irreps and the gate parity rules.
``nonlinearity_type`` is ``"gate"`` (``ops.gate.Gate``) or ``"norm"``
(``ops.gate.NormActivation``, no gate scalars: the conv outputs the hidden
irreps themselves).

``remat`` trades recompute for memory with ``torch.utils.checkpoint``
(non-reentrant, so it stays differentiable under the double backward of a
force loss):

* ``True``: the whole layer is recomputed in the backward, its kernels
  included;
* ``"save_tp"``: the layer's head (self-connection, ``linear_1``, norm)
  and tail (``linear_2``, nonlinearity, resnet) are two checkpointed
  segments around the conv, whose ``[N, mid_dim]`` output stays saved: the
  kernel is not run again (JAX saves only the TP output the same way).

Remat applies to ``jvp`` too (the fr dual sweep), as one checkpoint of the
whole layer for either setting, as in JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..data import _keys
from ..ops.gate import Gate, NormActivation
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
        remat=False,
        nonlinearity_type: str = "gate",
        nonlinearity_scalars: Dict[str, str] = {"e": "silu", "o": "tanh"},
        nonlinearity_gates: Dict[str, str] = {"e": "silu", "o": "tanh"},
    ):
        super().__init__()
        if nonlinearity_type not in ("gate", "norm"):
            raise ValueError(f"nonlinearity_type must be 'gate' or 'norm', got {nonlinearity_type!r}")
        if remat not in (False, True, "save_tp"):
            raise ValueError(f"remat must be False, True or 'save_tp', got {remat!r}")
        self.remat = remat
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
        if nonlinearity_type == "gate":
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
        else:
            conv_irreps_out = (irreps_scalars + irreps_gated).simplify()
            self.equivariant_nonlin = NormActivation(conv_irreps_out, scalar_nonlinearity=nl_scalars[1])

        self.resnet = bool(resnet) and self.equivariant_nonlin.irreps_out == irreps_prev
        convolution_kwargs = dict(convolution_kwargs or {})
        self.conv = InteractionBlock(irreps_in=self.irreps_in, irreps_out=conv_irreps_out, **convolution_kwargs)
        self.irreps_out.update(self.conv.irreps_out)
        self.irreps_out[_keys.NODE_FEATURES_KEY] = self.equivariant_nonlin.irreps_out

    def _finish(self, x: torch.Tensor, old_x: torch.Tensor) -> torch.Tensor:
        x = self.equivariant_nonlin(x)
        return old_x + x if self.resnet else x

    def _layer(self, data: dict) -> dict:
        old_x = data[_keys.NODE_FEATURES_KEY]
        data = self.conv(data)
        data[_keys.NODE_FEATURES_KEY] = self._finish(data[_keys.NODE_FEATURES_KEY], old_x)
        return data

    def _tail(self, msg, sc, old_x):
        return self._finish(self.conv.tail(msg, sc), old_x)

    def forward(self, data: dict) -> dict:
        if not self.remat:
            return self._layer(data)
        if self.remat is True:
            return checkpoint(self._layer, data, use_reentrant=False)
        # "save_tp": head and tail recomputed, the conv's output kept
        x, sc = checkpoint(self.conv.head, data, use_reentrant=False)
        msg = self.conv.conv(data, x)
        data = dict(data)
        data[_keys.NODE_FEATURES_KEY] = checkpoint(self._tail, msg, sc, data[_keys.NODE_FEATURES_KEY],
                                                   use_reentrant=False)
        return data

    def jvp(self, data: dict, tangents: dict):
        """Dual-number step of the layer (JAX ``ConvNetLayer.jvp``): the
        block's hand-written rule, then the nonlinearity's jvp and the
        resnet tangent, checkpointed as a whole when ``remat`` is set."""
        if self.remat:
            return checkpoint(self._jvp_apply, data, tangents, use_reentrant=False)
        return self._jvp_apply(data, tangents)

    def _jvp_apply(self, data: dict, tangents: dict):
        old_x = data[_keys.NODE_FEATURES_KEY]
        t_old = tangents.get(_keys.NODE_FEATURES_KEY)
        data, tangents = self.conv.jvp(data, tangents)
        x = data[_keys.NODE_FEATURES_KEY]
        tx = tangents.get(_keys.NODE_FEATURES_KEY)
        if tx is None:
            x = self.equivariant_nonlin(x)
        else:
            x, tx = torch.func.jvp(self.equivariant_nonlin, (x,), (tx,))
        if self.resnet:
            x = old_x + x
            if t_old is not None:
                tx = t_old if tx is None else tx + t_old
        data = dict(data)
        data[_keys.NODE_FEATURES_KEY] = x
        tangents = dict(tangents)
        if tx is not None:
            tangents[_keys.NODE_FEATURES_KEY] = tx
        else:
            tangents.pop(_keys.NODE_FEATURES_KEY, None)
        return data, tangents
