"""TensorProductScatter: gather -> CG tensor product -> scatter-sum.

Port of ``nequip_tpu/nn/tp_scatter.py``.  ``impl="torch"`` is the plain
path (gather, unfused TP, masked ``index_add``), the counterpart of the JAX
``xla`` path; ``impl="fused"`` builds the kernel plan for the fused CUDA
convolution (``ops/kernels/tp_scatter.py``), the counterpart of
``pallas_fused``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.irreps import Irreps
from ..ops.kernels.tp_scatter import TPPlan
from ..ops.scatter import scatter_sum
from ..ops.tensor_product import TensorProduct

TP_IMPLS = ("torch", "fused")


class TensorProductScatter:
    def __init__(self, feature_irreps_in, irreps_edge_attr, irreps_mid, instructions, impl: str = "torch"):
        if impl not in TP_IMPLS:
            raise ValueError(f"tp_impl must be one of {TP_IMPLS}, got {impl!r}")
        self.feature_irreps_in = Irreps(feature_irreps_in)
        self.irreps_edge_attr = Irreps(irreps_edge_attr)
        self.irreps_mid = Irreps(irreps_mid)
        self.tp = TensorProduct(
            self.feature_irreps_in, self.irreps_edge_attr, self.irreps_mid, instructions,
            shared_weights=False,
        )
        self.impl = impl
        self.plan = TPPlan(self.tp) if impl == "fused" else None

    @property
    def weight_numel(self) -> int:
        return self.tp.weight_numel

    def forward_tp_scatter(
        self,
        x: torch.Tensor,
        edge_attr: torch.Tensor,
        edge_weight: torch.Tensor,
        edge_dst: torch.Tensor,
        edge_src: torch.Tensor,
        edge_mask: Optional[torch.Tensor],
        num_nodes: int,
    ) -> torch.Tensor:
        """The plain path: ``scatter_dst(TP(x[src], edge_attr, edge_weight))``."""
        messages = self.tp(torch.index_select(x, 0, edge_src), edge_attr, edge_weight)
        return scatter_sum(messages, edge_dst, num_nodes, mask=edge_mask)
