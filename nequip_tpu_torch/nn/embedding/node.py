"""Node type embedding, with categorical per-graph field embeddings.

Port of ``NodeTypeEmbed`` (``nequip_tpu/nn/embedding/node.py``).  Each entry
of ``categorical_graph_field_embed`` (``field``, ``min``, ``max``,
``num_features``, optional ``init``) names a registered integer graph
field (``data.register_fields``) and adds a table ``embed_<field>`` of
``max - min + 1`` rows; every node gets its frame's row appended to its type
embedding, so ``NODE_ATTRS`` (and the first conv layer's input) widens.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch import nn

from ...data import _keys
from ...data._key_registry import _GRAPH_FIELDS
from ...ops.irreps import Irreps
from ..module import GraphModule

EMBED_INITS = (None, "normal", "uniform", "zero", "near_zero")


def _init_embedding(t: torch.Tensor, init: Optional[str], generator: torch.Generator) -> None:
    if init in (None, "normal"):
        t.copy_(torch.randn(t.shape, generator=generator, dtype=torch.float64))
    elif init == "uniform":
        t.copy_(torch.rand(t.shape, generator=generator, dtype=torch.float64) * 2 - 1)
    elif init == "zero":
        t.zero_()
    else:  # near_zero
        t.copy_(1e-3 * torch.randn(t.shape, generator=generator, dtype=torch.float64))


class NodeTypeEmbed(GraphModule):
    def __init__(
        self,
        type_names: List[str],
        num_features: int,
        type_embed_init: Optional[str] = None,
        set_features: bool = True,
        categorical_graph_field_embed: Optional[List[Dict[str, Any]]] = None,
        irreps_in=None,
    ):
        super().__init__()
        if type_embed_init not in EMBED_INITS:
            raise ValueError(f"unknown embedding init {type_embed_init!r}")
        self.type_names = list(type_names)
        self.num_types = len(type_names)
        self.num_features = int(num_features)
        self.set_features = set_features
        self.type_embed_init = type_embed_init
        self.categorical_specs = []
        irreps_in = dict(irreps_in or {})
        total = self.num_features
        for spec in categorical_graph_field_embed or []:
            field = str(spec["field"])
            if field not in _GRAPH_FIELDS:
                raise ValueError(f"{field!r} is not a registered graph field (data.register_fields)")
            lo, hi = int(spec["min"]), int(spec["max"])
            if hi < lo or spec.get("init") not in EMBED_INITS:
                raise ValueError(f"bad categorical embedding spec {spec}")
            self.categorical_specs.append(dict(field=field, num_features=int(spec["num_features"]), min=lo,
                                               num=hi - lo + 1, init=spec.get("init")))
            total += int(spec["num_features"])
            irreps_in.setdefault(field, None)
        out_irreps = Irreps([(total, (0, 1))])
        irreps_out = {_keys.NODE_ATTRS_KEY: out_irreps}
        if set_features:
            irreps_out[_keys.NODE_FEATURES_KEY] = out_irreps
        self._init_irreps(irreps_in=irreps_in, irreps_out=irreps_out)
        self.type_embed = nn.Parameter(torch.empty(self.num_types, self.num_features, dtype=self.param_dtype))
        for spec in self.categorical_specs:
            self.register_parameter(f"embed_{spec['field']}", nn.Parameter(
                torch.empty(spec["num"], spec["num_features"], dtype=self.param_dtype)))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        _init_embedding(self.type_embed, self.type_embed_init, generator)
        for spec in self.categorical_specs:
            _init_embedding(getattr(self, f"embed_{spec['field']}"), spec["init"], generator)

    def jvp(self, data: dict, tangents: dict):
        """The outputs read only integer fields (atom types, graph labels),
        so they carry no tangent: overriding the default keeps tangents of
        the node attrs and features out of the dual sweep (JAX
        ``NodeTypeEmbed.jvp``)."""
        t_out = {k: v for k, v in tangents.items() if k not in (_keys.NODE_ATTRS_KEY, _keys.NODE_FEATURES_KEY)}
        return self(data), t_out

    def forward(self, data: dict) -> dict:
        types = data[_keys.ATOM_TYPE_KEY].reshape(-1)
        emb = self.type_embed.to(self.model_dtype)[types]
        if self.categorical_specs:
            parts = [emb]
            batch = data[_keys.BATCH_KEY].reshape(-1)
            for spec in self.categorical_specs:
                per_node = torch.index_select(data[spec["field"]].reshape(-1), 0, batch) - spec["min"]
                parts.append(getattr(self, f"embed_{spec['field']}").to(self.model_dtype)[per_node])
            emb = torch.cat(parts, dim=-1)
        data = dict(data)
        data[_keys.NODE_ATTRS_KEY] = emb
        if self.set_features:
            data[_keys.NODE_FEATURES_KEY] = emb
        return data
