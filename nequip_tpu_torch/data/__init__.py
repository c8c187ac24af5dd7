"""Host-side data path: field names, padding contract, neighbour list,
datasets, loaders, statistics and the datamodule."""

from . import _keys
from .atomic_data_dict import (
    batched_from_list,
    frame_from_batched,
    from_dict,
    pad_batch,
    round_up,
    to_tensors,
    without_nodes,
)
from ._key_registry import deregister_fields, register_fields
from .datamodule import ASEDataModule, NequIPDataModule
from .loader import DataLoader
from .modifier import BaseModifier, EdgeLengths, MappedFieldModifier, NumNeighbors, PerAtomModifier
from .neighborlist import compute_neighborlist_, neighbor_list, register_neighborlist_backend
from .stats_manager import CommonDataStatisticsManager, DataStatisticsManager, EnergyOnlyDataStatisticsManager

__all__ = [
    "ASEDataModule",
    "BaseModifier",
    "CommonDataStatisticsManager",
    "DataLoader",
    "DataStatisticsManager",
    "EdgeLengths",
    "EnergyOnlyDataStatisticsManager",
    "MappedFieldModifier",
    "NequIPDataModule",
    "NumNeighbors",
    "PerAtomModifier",
    "_keys",
    "batched_from_list",
    "compute_neighborlist_",
    "deregister_fields",
    "frame_from_batched",
    "from_dict",
    "neighbor_list",
    "pad_batch",
    "register_fields",
    "register_neighborlist_backend",
    "round_up",
    "to_tensors",
    "without_nodes",
]
