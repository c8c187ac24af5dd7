"""Dataset base classes (host-side numpy frames and a transform pipeline).

Port of ``nequip_tpu/data/dataset/base.py``: the same split from the same
seed.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np

from ..atomic_data_dict import from_dict


class AtomicDataset:
    """Indexable dataset of single frames; transforms run on every access."""

    def __init__(self, transforms: Optional[Sequence[Callable]] = None):
        self.transforms = list(transforms or [])

    def __len__(self) -> int:
        raise NotImplementedError

    def get_frame(self, idx: int) -> dict:
        raise NotImplementedError

    def __getitem__(self, idx: int) -> dict:
        data = from_dict(self.get_frame(idx))
        for t in self.transforms:
            data = t(data)
        return data


class InMemoryDataset(AtomicDataset):
    """Frames held in a list (each access returns a shallow copy)."""

    def __init__(self, frames: Sequence[dict], transforms=None):
        super().__init__(transforms)
        self.frames = list(frames)

    def __len__(self) -> int:
        return len(self.frames)

    def get_frame(self, idx: int) -> dict:
        return dict(self.frames[idx])


class SubsetDataset(AtomicDataset):
    def __init__(self, dataset: AtomicDataset, indices: Sequence[int]):
        super().__init__([])
        self.dataset = dataset
        self.indices = [int(i) for i in indices]

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, idx: int) -> dict:
        return self.dataset[self.indices[idx]]

    def get_frame(self, idx: int) -> dict:
        return self.dataset.get_frame(self.indices[idx])


def RandomSplitDataset(dataset: AtomicDataset, split: dict, seed: int = 123) -> Dict[str, SubsetDataset]:
    """Split into named subsets by count (int) or fraction (float), e.g.
    ``{"train": 0.8, "val": 0.2}``; one seeded permutation."""
    n = len(dataset)
    sizes = {k: int(round(v * n)) if isinstance(v, float) else int(v) for k, v in split.items()}
    if sum(sizes.values()) > n:
        raise ValueError(f"split sizes {sizes} exceed dataset size {n}")
    perm = np.random.RandomState(seed).permutation(n)
    out, off = {}, 0
    for k, size in sizes.items():
        out[k] = SubsetDataset(dataset, perm[off : off + size])
        off += size
    return out
