"""Node type embedding.

Port of ``NodeTypeEmbed`` (``nequip_tpu/nn/embedding/node.py``) with its
default standard-normal init, without the categorical per-graph field
embeddings.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from ...data import _keys
from ...ops.irreps import Irreps
from ..module import GraphModule


class NodeTypeEmbed(GraphModule):
    def __init__(
        self,
        type_names: List[str],
        num_features: int,
        irreps_in=None,
    ):
        super().__init__()
        self.type_names = list(type_names)
        self.num_types = len(type_names)
        self.num_features = int(num_features)
        out_irreps = Irreps([(self.num_features, (0, 1))])
        self._init_irreps(
            irreps_in=irreps_in,
            irreps_out={_keys.NODE_ATTRS_KEY: out_irreps, _keys.NODE_FEATURES_KEY: out_irreps},
        )
        self.type_embed = nn.Parameter(
            torch.empty(self.num_types, self.num_features, dtype=self.model_dtype)
        )

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.type_embed.copy_(torch.randn(self.type_embed.shape, generator=generator, dtype=torch.float64))

    def forward(self, data: dict) -> dict:
        types = data[_keys.ATOM_TYPE_KEY].reshape(-1)
        emb = self.type_embed[types]
        data = dict(data)
        data[_keys.NODE_ATTRS_KEY] = emb
        data[_keys.NODE_FEATURES_KEY] = emb
        return data
