from .base import AtomicDataset, RandomSplitDataset, SubsetDataset
from .synthetic import LJTestDataset, lj_reference

__all__ = ["AtomicDataset", "LJTestDataset", "RandomSplitDataset", "SubsetDataset", "lj_reference"]
