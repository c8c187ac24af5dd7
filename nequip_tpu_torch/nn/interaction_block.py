"""The NequIP message-passing interaction block.

Port of ``InteractionBlock.__call__`` (``nequip_tpu/nn/interaction_block.py``):

    linear_1 -> avg-num-neighbor norm -> TP-scatter with radial-MLP edge
    weights -> merge of same-irrep mid chunks -> linear_2 -> + self-connection

With ``tp_impl="fused"`` the radial MLP runs inside the fused kernel and
the ``[E, weight_numel]`` radial weights never exist in device memory.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from ..data import _keys
from ..ops.irreps import Irreps
from ..ops.kernels.tp_scatter import LAYOUT_KEY, fused_tp_scatter_mlp
from ..ops.linear import Linear
from ..ops.mlp import ScalarMLP as ScalarMLPFunction
from ..ops.tensor_product import fully_connected_tensor_product, uvu_instructions
from .module import GraphModule
from .norm import AvgNumNeighborsNorm
from .tp_scatter import TensorProductScatter


def merge_mid_permutation(irreps_mid: Irreps) -> np.ndarray:
    """Column permutation taking uncoalesced mid chunks (same irrep, adjacent)
    to the simplified layout ``linear_2`` expects: merged[..., i] =
    x[..., perm[i]].  The same static map as the JAX ``_merge_mid_impl``."""
    cols = np.arange(irreps_mid.dim)
    slices = irreps_mid.slices()
    out = []
    i = 0
    while i < len(irreps_mid):
        ir = irreps_mid[i].ir
        group = []
        while i < len(irreps_mid) and irreps_mid[i].ir == ir:
            group.append(cols[slices[i]].reshape(ir.dim, irreps_mid[i].mul))
            i += 1
        out.append(np.concatenate(group, axis=-1).reshape(-1))
    return np.concatenate(out)


class InteractionBlock(GraphModule):
    def __init__(
        self,
        irreps_in,
        irreps_out,
        radial_mlp_depth: int = 1,
        radial_mlp_width: int = 8,
        use_sc: bool = True,
        is_first_layer: bool = False,
        type_names: Optional[Sequence[str]] = None,
        avg_num_neighbors: Optional[Union[float, Dict[str, float]]] = None,
        tp_impl: str = "torch",
    ):
        super().__init__()
        self._init_irreps(
            irreps_in=irreps_in,
            required_irreps_in=[
                _keys.EDGE_EMBEDDING_KEY,
                _keys.EDGE_ATTRS_KEY,
                _keys.NODE_FEATURES_KEY,
                _keys.NODE_ATTRS_KEY,
            ],
            irreps_out={_keys.NODE_FEATURES_KEY: Irreps(irreps_out)},
        )
        edge_emb_irreps = self.irreps_in[_keys.EDGE_EMBEDDING_KEY]
        if not all(mi.ir.l == 0 and mi.ir.p == 1 for mi in edge_emb_irreps):
            raise ValueError(f"edge embedding must be 0e scalars, got {edge_emb_irreps}")
        self.use_sc = use_sc
        self.is_first_layer = is_first_layer
        feature_irreps_in = self.irreps_in[_keys.NODE_FEATURES_KEY]
        feature_irreps_out = self.irreps_out[_keys.NODE_FEATURES_KEY]
        irreps_edge_attr = self.irreps_in[_keys.EDGE_ATTRS_KEY]

        self.avg_num_neighbors_norm = AvgNumNeighborsNorm(
            avg_num_neighbors=avg_num_neighbors, type_names=type_names, irreps_in=self.irreps_in
        )
        self.linear_1 = Linear(feature_irreps_in, feature_irreps_in)
        irreps_mid, instructions = uvu_instructions(feature_irreps_in, irreps_edge_attr, feature_irreps_out)
        self.tp_scatter = TensorProductScatter(
            feature_irreps_in, irreps_edge_attr, irreps_mid, instructions, impl=tp_impl
        )
        self.edge_mlp = ScalarMLPFunction(
            input_dim=edge_emb_irreps.num_irreps,
            output_dim=self.tp_scatter.weight_numel,
            hidden_layers_depth=radial_mlp_depth,
            hidden_layers_width=radial_mlp_width,
            nonlinearity="silu",
        )
        if tp_impl == "fused" and (
            self.edge_mlp.num_layers != 2 or self.edge_mlp.nonlinearity != "silu"
        ):
            raise ValueError("tp_impl='fused' needs the depth-1 bias-free silu radial MLP")
        self.irreps_mid = irreps_mid
        self.irreps_mid_simplified = irreps_mid.simplify()
        self._merge_perm = (
            merge_mid_permutation(irreps_mid)
            if len(self.irreps_mid_simplified) != len(irreps_mid)
            else None
        )
        self.linear_2 = Linear(self.irreps_mid_simplified, feature_irreps_out)
        # self-connection TP; its shared weights are the parameter ``sc``
        self.sc_tp = (
            fully_connected_tensor_product(
                feature_irreps_in, self.irreps_in[_keys.NODE_ATTRS_KEY], feature_irreps_out
            )
            if use_sc
            else None
        )
        if self.sc_tp is not None:
            self.sc = nn.Parameter(torch.empty(self.sc_tp.weight_numel, dtype=self.model_dtype))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.sc_tp is not None:
            self.sc.copy_(torch.randn(self.sc.shape, generator=generator, dtype=torch.float64))

    def _merge_mid(self, x: torch.Tensor) -> torch.Tensor:
        if self._merge_perm is None:
            return x
        return torch.index_select(x, -1, torch.as_tensor(self._merge_perm, device=x.device))

    def forward(self, data: dict) -> dict:
        x = data[_keys.NODE_FEATURES_KEY]
        num_nodes = x.shape[0]
        if self.sc_tp is not None:
            sc = self.sc_tp(x, data[_keys.NODE_ATTRS_KEY], self.sc.to(x.dtype))

        data = dict(data)
        data[_keys.NODE_FEATURES_KEY] = self.linear_1(x)
        data = self.avg_num_neighbors_norm(data)
        x = data[_keys.NODE_FEATURES_KEY]

        if self.tp_scatter.impl == "fused":
            x = fused_tp_scatter_mlp(
                self.tp_scatter.plan, x,
                data[_keys.EDGE_ATTRS_KEY], data[_keys.EDGE_EMBEDDING_KEY],
                self.edge_mlp.w0.to(x.dtype), self.edge_mlp.w1.to(x.dtype),
                self.edge_mlp.alphas[0], self.edge_mlp.alphas[1],
                data[LAYOUT_KEY],
            )
        else:
            x = self.tp_scatter.forward_tp_scatter(
                x=x,
                edge_attr=data[_keys.EDGE_ATTRS_KEY],
                edge_weight=self.edge_mlp(data[_keys.EDGE_EMBEDDING_KEY]),
                edge_dst=data[_keys.EDGE_INDEX_KEY][0],
                edge_src=data[_keys.EDGE_INDEX_KEY][1],
                edge_mask=data.get(_keys.EDGE_MASK_KEY),
                num_nodes=num_nodes,
            )
        x = self.linear_2(self._merge_mid(x))
        if self.sc_tp is not None:
            x = x + sc
        data[_keys.NODE_FEATURES_KEY] = x
        return data
