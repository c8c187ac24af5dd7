"""Field-type registry: classify AtomicDataDict fields for batching/padding.

Port of ``nequip_tpu/data/_key_registry.py``: graph fields pad to the frame
capacity, node fields to the node capacity, edge fields to the edge capacity.
``register_fields`` adds fields (a per-frame label, a spin vector) that the
batching, padding and ``to_tensors`` then carry like the built-in ones;
``deregister_fields`` takes them out again.
"""

from typing import Dict, Sequence, Set

from . import _keys

_DEFAULT_LONG_FIELDS: Set[str] = {
    _keys.EDGE_INDEX_KEY,
    _keys.EDGE_TYPE_KEY,
    _keys.ATOMIC_NUMBERS_KEY,
    _keys.ATOM_TYPE_KEY,
    _keys.BATCH_KEY,
    _keys.NUM_NODES_KEY,
    _keys.DATASET_KEY,
    _keys.NUM_LOCAL_GHOST_NODES_KEY,
    _keys.EDGE_TRANSPOSE_PERM_KEY,
    _keys.TOTAL_CHARGE_KEY,
    _keys.TOTAL_SPIN_KEY,
}
_DEFAULT_GRAPH_FIELDS: Set[str] = {
    _keys.TOTAL_ENERGY_KEY,
    _keys.FREE_ENERGY_KEY,
    _keys.STRESS_KEY,
    _keys.VIRIAL_KEY,
    _keys.PBC_KEY,
    _keys.CELL_KEY,
    _keys.NUM_NODES_KEY,
    _keys.TOTAL_MAGMOM_KEY,
    _keys.DIPOLE_KEY,
    _keys.POLARIZATION_KEY,
    _keys.DIELECTRIC_KEY,
    _keys.DATASET_KEY,
    _keys.FRAME_MASK_KEY,
    _keys.TOTAL_CHARGE_KEY,
    _keys.TOTAL_SPIN_KEY,
}
_DEFAULT_NODE_FIELDS: Set[str] = {
    _keys.POSITIONS_KEY,
    _keys.NODE_FEATURES_KEY,
    _keys.NODE_ATTRS_KEY,
    _keys.ATOMIC_NUMBERS_KEY,
    _keys.ATOM_TYPE_KEY,
    _keys.PER_ATOM_ENERGY_KEY,
    _keys.PER_ATOM_STRESS_KEY,
    _keys.CHARGE_KEY,
    _keys.MAGMOM_KEY,
    _keys.FORCE_KEY,
    _keys.PARTIAL_FORCE_KEY,
    _keys.BORN_CHARGE_KEY,
    _keys.BATCH_KEY,
    _keys.FEATURE_NORM_FACTOR_KEY,
    _keys.NODE_MASK_KEY,
}
_DEFAULT_EDGE_FIELDS: Set[str] = {
    _keys.EDGE_CELL_SHIFT_KEY,
    _keys.EDGE_VECTORS_KEY,
    _keys.EDGE_LENGTH_KEY,
    _keys.NORM_LENGTH_KEY,
    _keys.EDGE_ATTRS_KEY,
    _keys.EDGE_EMBEDDING_KEY,
    _keys.EDGE_FEATURES_KEY,
    _keys.EDGE_CUTOFF_KEY,
    _keys.EDGE_ENERGY_KEY,
    _keys.EDGE_FORCE_KEY,
    _keys.EDGE_MASK_KEY,
}
_DEFAULT_CARTESIAN_TENSOR_FIELDS: Dict[str, str] = {
    _keys.STRESS_KEY: "ij=ji",
    _keys.VIRIAL_KEY: "ij=ji",
    _keys.BORN_CHARGE_KEY: "ij",
    _keys.DIELECTRIC_KEY: "ij=ji",
}

_GRAPH_FIELDS: Set[str] = set(_DEFAULT_GRAPH_FIELDS)
_NODE_FIELDS: Set[str] = set(_DEFAULT_NODE_FIELDS)
_EDGE_FIELDS: Set[str] = set(_DEFAULT_EDGE_FIELDS)
_LONG_FIELDS: Set[str] = set(_DEFAULT_LONG_FIELDS)
_CARTESIAN_TENSOR_FIELDS: Dict[str, str] = dict(_DEFAULT_CARTESIAN_TENSOR_FIELDS)


def register_fields(
    graph_fields: Sequence[str] = (),
    node_fields: Sequence[str] = (),
    edge_fields: Sequence[str] = (),
    long_fields: Sequence[str] = (),
    cartesian_tensor_fields: Dict[str, str] = None,
) -> None:
    """Register new fields as graph, node or edge fields (each in one of
    them), integer (``long``) fields, or cartesian tensors with their
    symmetry (``"ij"`` or ``"ij=ji"``)."""
    graph, node, edge = set(graph_fields), set(node_fields), set(edge_fields)
    if len(graph | node | edge) != len(graph) + len(node) + len(edge):
        raise ValueError("a field cannot be in more than one of graph, node and edge")
    for new, others in ((graph, (_NODE_FIELDS, _EDGE_FIELDS)), (node, (_GRAPH_FIELDS, _EDGE_FIELDS)),
                        (edge, (_GRAPH_FIELDS, _NODE_FIELDS))):
        clash = sorted(f for f in new if any(f in o for o in others))
        if clash:
            raise ValueError(f"fields {clash} are already registered in another category")
    _GRAPH_FIELDS.update(graph)
    _NODE_FIELDS.update(node)
    _EDGE_FIELDS.update(edge)
    _LONG_FIELDS.update(long_fields)
    _CARTESIAN_TENSOR_FIELDS.update(cartesian_tensor_fields or {})


def deregister_fields(*fields: str) -> None:
    """Undo ``register_fields`` for these fields; built-in fields raise."""
    defaults = _DEFAULT_GRAPH_FIELDS | _DEFAULT_NODE_FIELDS | _DEFAULT_EDGE_FIELDS
    for f in fields:
        if f in defaults:
            raise ValueError(f"cannot deregister built-in field {f}")
        for registry in (_GRAPH_FIELDS, _NODE_FIELDS, _EDGE_FIELDS, _LONG_FIELDS):
            registry.discard(f)
        _CARTESIAN_TENSOR_FIELDS.pop(f, None)


def _register_field_prefix(prefix: str) -> None:
    """Register every registered field again under ``prefix`` (which ends in
    ``_``, e.g. ``original_dataset_``)."""
    if not prefix.endswith("_"):
        raise ValueError("a field prefix ends in '_'")
    register_fields(
        graph_fields=[prefix + f for f in _GRAPH_FIELDS],
        node_fields=[prefix + f for f in _NODE_FIELDS],
        edge_fields=[prefix + f for f in _EDGE_FIELDS],
        long_fields=[prefix + f for f in _LONG_FIELDS],
        cartesian_tensor_fields={prefix + f: fmt for f, fmt in _CARTESIAN_TENSOR_FIELDS.items()},
    )


def get_field_type(field: str, error_on_unregistered: bool = True) -> str:
    if field in _GRAPH_FIELDS:
        return "graph"
    if field in _NODE_FIELDS:
        return "node"
    if field in _EDGE_FIELDS:
        return "edge"
    if error_on_unregistered:
        raise KeyError(f"field {field!r} is not registered")
    return "other"
