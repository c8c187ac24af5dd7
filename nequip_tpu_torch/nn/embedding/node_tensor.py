"""Vector-field node embeddings: solid-harmonic embeddings of a node or
per-graph vector field (spins, external fields) appended to the node
features.

Port of ``AppendVectorFieldEmbed`` (``nequip_tpu/nn/embedding/node_tensor.py``):
the field's direction enters as spherical harmonics up to ``lmax`` scaled
by its magnitude (so a zero field embeds to zero, and the l=0 channel is
the magnitude), with the parity of a polar or an axial vector.
"""

from __future__ import annotations

import torch

from ...data import _keys
from ...data._key_registry import _GRAPH_FIELDS, _NODE_FIELDS
from ...ops.irreps import Irrep, Irreps, MulIrrep
from ...ops.spherical import spherical_harmonics
from ..module import GraphModule


class AppendVectorFieldEmbed(GraphModule):
    """Append ``SH(v) * |v|`` of a registered node field ``[N, 3]`` or graph
    field ``[F, 3]`` (given to each node of its frame) to ``NODE_FEATURES``;
    ``axial`` for pseudo-vectors, whose l=1 part is even."""

    def __init__(self, field: str, lmax: int = 1, axial: bool = False, irreps_in=None):
        super().__init__()
        self.field = field
        self.lmax = int(lmax)
        self.axial = bool(axial)
        if field not in _NODE_FIELDS and field not in _GRAPH_FIELDS:
            raise ValueError(f"{field!r} must be a registered node or graph field")
        self.is_graph_field = field in _GRAPH_FIELDS
        irreps_in = dict(irreps_in or {})
        irreps_in.setdefault(field, None)
        base_p = 1 if self.axial else -1
        self.sh_irreps = Irreps([MulIrrep(1, Irrep(l, base_p**l)) for l in range(self.lmax + 1)])
        self._init_irreps(
            irreps_in=irreps_in,
            required_irreps_in=[_keys.NODE_FEATURES_KEY],
            irreps_out={_keys.NODE_FEATURES_KEY: Irreps(irreps_in[_keys.NODE_FEATURES_KEY]) + self.sh_irreps},
        )

    def forward(self, data: dict) -> dict:
        vec = data[self.field]
        if self.is_graph_field:
            vec = torch.index_select(vec.reshape(-1, 3), 0, data[_keys.BATCH_KEY].reshape(-1))
        vec = vec.reshape(-1, 3)
        mag = torch.sqrt(torch.sum(vec * vec, dim=-1, keepdim=True) + 1e-30)
        emb = (spherical_harmonics(self.lmax, vec, normalize=True) * mag).to(self.model_dtype)
        data = dict(data)
        data[_keys.NODE_FEATURES_KEY] = torch.cat([data[_keys.NODE_FEATURES_KEY], emb], dim=-1)
        return data
