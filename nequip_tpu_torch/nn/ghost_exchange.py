"""Ghost/halo feature-exchange interface for spatially decomposed graphs.

Port of ``nequip_tpu/nn/ghost_exchange.py``.  Every interaction block but
the first calls its ``ghost_exchange`` on the normed ``linear_1`` features
(and on their tangent in the fr sweep).  This default is a no-op for
single-device and replicated execution; ``parallel.ghost.MeshGhostExchange``
replaces it on a graph sharded over ranks, where it refreshes the ghost
rows from their owners' current features.
"""

from __future__ import annotations

from .module import GraphModule


class NoOpGhostExchange(GraphModule):
    def __init__(self, field: str, irreps_in=None):
        super().__init__()
        self.field = field
        self._init_irreps(irreps_in=irreps_in)

    def forward(self, data: dict) -> dict:
        return data
