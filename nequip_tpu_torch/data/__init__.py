"""Host-side data path: field names, padding contract, neighbour list."""

from . import _keys
from .atomic_data_dict import (
    batched_from_list,
    from_dict,
    pad_batch,
    round_up,
    to_tensors,
)
from .neighborlist import compute_neighborlist_, neighbor_list

__all__ = [
    "_keys",
    "batched_from_list",
    "compute_neighborlist_",
    "from_dict",
    "neighbor_list",
    "pad_batch",
    "round_up",
    "to_tensors",
]
