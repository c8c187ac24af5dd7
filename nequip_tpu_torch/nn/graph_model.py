"""GraphModel: the top-level model wrapper.

Port of ``nequip_tpu/nn/graph_model.py``: filters the incoming data down to
the model's input fields, carries the metadata deployment needs (r_max,
type names, dtype), and, when a layer runs the fused kernels, puts the edge
stream into kernel order (``relayout_edge_stream``) unless a caller, such
as the calculator, already did so once per neighbour list.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..data import _keys
from ..ops.kernels.tp_scatter import relayout_edge_stream
from ..utils.dtype import dtype_to_name
from .embedding.utils import cutoff_dict_to_matrix
from .interaction_block import InteractionBlock
from .module import GraphModule

_ALWAYS_INPUT_FIELDS = (
    _keys.POSITIONS_KEY,
    _keys.EDGE_INDEX_KEY,
    _keys.EDGE_CELL_SHIFT_KEY,
    _keys.CELL_KEY,
    _keys.PBC_KEY,
    _keys.BATCH_KEY,
    _keys.NUM_NODES_KEY,
    _keys.ATOM_TYPE_KEY,
    _keys.ATOMIC_NUMBERS_KEY,
    _keys.NODE_MASK_KEY,
    _keys.EDGE_MASK_KEY,
    _keys.FRAME_MASK_KEY,
)


class GraphModel(GraphModule):
    _jax_transparent = ("model",)

    def __init__(
        self,
        model: GraphModule,
        type_names: Optional[List[str]] = None,
        r_max: Optional[float] = None,
        per_edge_type_cutoff: Optional[dict] = None,
    ):
        super().__init__()
        self.model = model
        self.model_config: Dict = {}
        self.type_names = list(type_names) if type_names is not None else None
        self.r_max = r_max
        self.per_edge_type_cutoff = per_edge_type_cutoff
        self._init_irreps(irreps_in=dict(model.irreps_in), irreps_out=dict(model.irreps_out))
        self.input_fields = tuple(dict.fromkeys(list(_ALWAYS_INPUT_FIELDS) + list(model.irreps_in)))
        self.uses_fused_kernels = any(
            isinstance(m, InteractionBlock) and m.tp_scatter.impl == "fused" for m in self.modules()
        )

    @property
    def metadata(self) -> Dict[str, str]:
        md = {"model_dtype": dtype_to_name(self.model_dtype)}
        if self.r_max is not None:
            md["r_max"] = str(self.r_max)
        if self.type_names is not None:
            md["num_types"] = str(len(self.type_names))
            md["type_names"] = " ".join(self.type_names)
        if self.per_edge_type_cutoff is not None:
            mat = cutoff_dict_to_matrix(self.per_edge_type_cutoff, self.type_names, self.r_max)
            md["per_edge_type_cutoff"] = " ".join(str(x) for x in mat.reshape(-1))
        md.update(self.model.metadata())
        return md

    def forward(self, data: dict) -> dict:
        inputs = {k: data[k] for k in self.input_fields if k in data}
        inputs.update({k: v for k, v in data.items() if k.startswith(_keys.EDGE_LAYOUT_KEY_PREFIX)})
        if self.uses_fused_kernels:
            inputs = relayout_edge_stream(inputs)
        return self.model(inputs)
