"""Field-type registry: classify AtomicDataDict fields for batching/padding.

Port of ``nequip_tpu/data/_key_registry.py``: graph fields pad to the frame
capacity, node fields to the node capacity, edge fields to the edge capacity.
"""

from typing import Dict, Set

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
