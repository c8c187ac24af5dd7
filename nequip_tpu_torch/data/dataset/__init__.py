from .base import AtomicDataset, InMemoryDataset, RandomSplitDataset, SubsetDataset
from .file_datasets import ASEDataset, HDF5Dataset, LMDBDataset, NPZDataset
from .shard import ShardDataset
from .synthetic import LJTestDataset, lj_reference

__all__ = [
    "ASEDataset",
    "AtomicDataset",
    "HDF5Dataset",
    "InMemoryDataset",
    "LJTestDataset",
    "LMDBDataset",
    "NPZDataset",
    "RandomSplitDataset",
    "ShardDataset",
    "SubsetDataset",
    "lj_reference",
]
