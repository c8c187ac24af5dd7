"""Per-edge-type cutoff dict <-> matrix converters.

Port of ``nequip_tpu/nn/embedding/utils.py``.
``per_edge_type_cutoff`` maps center-type name -> cutoff, or center type ->
{neighbour type -> cutoff}; missing entries default to ``r_max``.
"""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np


def cutoff_dict_to_matrix(
    per_edge_type_cutoff: Dict[str, Union[float, Dict[str, float]]],
    type_names: List[str],
    r_max: float,
) -> np.ndarray:
    """(num_types, num_types) matrix indexed [center/dst, neighbor/src].

    The dict's first level is the *center* (dst) type, matching the
    reference's flat indexing ``edge_type[0] * num_types + edge_type[1]``
    (``_edge.py:73-79``).
    """
    n = len(type_names)
    mat = np.full((n, n), float(r_max))
    for center_name, v in per_edge_type_cutoff.items():
        assert center_name in type_names, f"unknown type {center_name!r}"
        i = type_names.index(center_name)
        if isinstance(v, dict):
            for nbr_name, c in v.items():
                assert nbr_name in type_names, f"unknown type {nbr_name!r}"
                j = type_names.index(nbr_name)
                mat[i, j] = float(c)
        else:
            mat[i, :] = float(v)
    assert (mat <= r_max + 1e-12).all(), "per-edge-type cutoffs must be <= r_max"
    return mat


def cutoff_matrix_to_dict(mat: np.ndarray, type_names: List[str]) -> Dict[str, Dict[str, float]]:
    """The inverse of ``cutoff_dict_to_matrix``: center type -> {neighbour
    type -> cutoff}, every pair written out."""
    return {center: {nbr: float(mat[i, j]) for j, nbr in enumerate(type_names)}
            for i, center in enumerate(type_names)}
