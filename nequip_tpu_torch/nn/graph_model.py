"""GraphModel: the top-level model wrapper.

Port of ``nequip_tpu/nn/graph_model.py``: filters the incoming data down to
the model's input fields, carries the metadata deployment needs (r_max,
type names, dtype), and, when a layer runs the fused kernels, puts the edge
stream into kernel order (``relayout_edge_stream``) unless a caller, such
as the calculator, already did so once per neighbour list.  Forces on given
edge vectors (``ForceStressOutput``'s edge branch) then come back in the
caller's edge order, as do the caller's per-edge inputs.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..data import _keys
from ..data._key_registry import get_field_type
from ..ops.kernels.tp_scatter import LAYOUT_KEY, kernel_order, relayout_edge_stream, to_caller_order
from ..utils.dtype import dtype_to_name
from .embedding.utils import cutoff_dict_to_matrix
from .interaction_block import InteractionBlock
from .module import GraphModule
from .tp_scatter import KERNEL_IMPLS

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
    _keys.NUM_LOCAL_GHOST_NODES_KEY,
    _keys.EDGE_VECTORS_KEY,
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

    @property
    def uses_fused_kernels(self) -> bool:
        """Whether a layer runs the CUDA kernels (and so needs the edge stream in kernel order)."""
        return any(isinstance(m, InteractionBlock) and m.tp_scatter.impl in KERNEL_IMPLS for m in self.modules())

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

    def _inputs(self, data: dict, order=None) -> dict:
        inputs = {k: data[k] for k in self.input_fields if k in data}
        inputs.update({k: v for k, v in data.items() if k.startswith(_keys.EDGE_LAYOUT_KEY_PREFIX)})
        if self.uses_fused_kernels:
            inputs = relayout_edge_stream(inputs, order)
        return inputs

    def forward(self, data: dict) -> dict:
        # the edge permutation, kept where edge vectors come in and are put into kernel order here
        order = None
        if _keys.EDGE_VECTORS_KEY in data and self.uses_fused_kernels and LAYOUT_KEY not in data:
            order = kernel_order(data)
        inputs = self._inputs(data, order)
        out = self.model(inputs)
        if order is not None:
            out = dict(out)
            for k in inputs:
                if k in data and get_field_type(k, error_on_unregistered=False) == "edge":
                    out[k] = data[k]
            if _keys.EDGE_FORCE_KEY in out:
                out[_keys.EDGE_FORCE_KEY] = to_caller_order(out[_keys.EDGE_FORCE_KEY], order)
        return out

    def loss_surrogate(self, data: dict, cotangents: dict):
        """The fr surrogate of the wrapped ``ForceStressOutput`` on the same
        inputs as ``forward``."""
        return self.model.loss_surrogate(self._inputs(data), cotangents)
