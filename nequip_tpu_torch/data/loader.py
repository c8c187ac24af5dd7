"""Batched, padded data loading.

Port of ``nequip_tpu/data/loader.py``: the same batches in the same order
from the same seed.  Batches are padded (the padding contract of
``atomic_data_dict.pad_batch``), so the kernels see one shape only: every
batch pads to the worst case (max frame size x batch_size), the
JAX loader's ``n_buckets=1`` policy.  Shuffling is keyed by (seed, epoch);
``num_samples_per_epoch`` splits one pass over a large dataset into many
short epochs (``PartialSampler``).  ``state_dict`` holds the epoch
counter and the sampler's, which is what a resumed run restores to
continue at the same data position.  Not ported yet: the capacity-bucket
ladder (``n_buckets>1``), per-process sharding and fixed capacities.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from . import _keys
from ._sampler import PartialSampler
from ..utils.device import resolve_device
from .atomic_data_dict import batched_from_list, pad_batch, round_up, to_tensors


class DataLoader:
    """``device``: where ``__iter__`` puts the padded tensors, the card by
    default (raising without one); None keeps the padded numpy dicts."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        pad_multiple: int = 64,
        drop_last: bool = False,
        device="cuda",
        num_samples_per_epoch: Optional[int] = None,
    ):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = int(seed)
        self.drop_last = drop_last
        self.pad_multiple = int(pad_multiple)
        self.device = None if device is None else resolve_device(device)
        self._epoch = 0
        self._capacity: Optional[Dict[str, int]] = None
        self._real_slots = 0
        self._padded_slots = 0
        self.sampler = (
            None if num_samples_per_epoch is None
            else PartialSampler(len(dataset), num_samples_per_epoch, shuffle=shuffle, seed=seed)
        )

    # --- capacity ------------------------------------------------------
    def _frame_sizes(self) -> Tuple[np.ndarray, np.ndarray]:
        nodes, edges = [], []
        for i in range(len(self.dataset)):
            frame = self.dataset[i]
            nodes.append(frame[_keys.POSITIONS_KEY].shape[0])
            edges.append(frame[_keys.EDGE_INDEX_KEY].shape[1] if _keys.EDGE_INDEX_KEY in frame else 0)
        return np.asarray(nodes), np.asarray(edges)

    @property
    def capacity(self) -> Dict[str, int]:
        """Worst-case capacity: every batch pads to it."""
        if self._capacity is None:
            nodes, edges = self._frame_sizes()
            self._capacity = {
                "n_nodes": round_up(int(nodes.max()) * self.batch_size + 1, self.pad_multiple),
                "n_edges": round_up(max(int(edges.max()) * self.batch_size, 1), self.pad_multiple),
                "n_frames": self.batch_size + 1,
            }
        return self._capacity

    # --- iteration -----------------------------------------------------
    def _order(self) -> np.ndarray:
        if self.sampler is not None:
            return np.fromiter(iter(self.sampler), dtype=np.int64)
        if self.shuffle:
            return np.random.RandomState(self.seed + self._epoch).permutation(len(self.dataset))
        return np.arange(len(self.dataset))

    def __len__(self) -> int:
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def host_batches(self) -> Iterator[dict]:
        """Unpadded numpy batches (for statistics)."""
        order = self._order()
        for start in range(0, len(order), self.batch_size):
            idx = order[start : start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                break
            yield batched_from_list([self.dataset[i] for i in idx])

    def __iter__(self) -> Iterator[dict]:
        for batch in self.host_batches():
            n_real = batch[_keys.POSITIONS_KEY].shape[0]
            e_real = batch[_keys.EDGE_INDEX_KEY].shape[1] if _keys.EDGE_INDEX_KEY in batch else 0
            cap = self.capacity
            self._real_slots += n_real + e_real
            self._padded_slots += (cap["n_nodes"] - n_real) + (cap["n_edges"] - e_real)
            padded = pad_batch(batch, cap["n_nodes"], cap["n_edges"], cap["n_frames"])
            yield padded if self.device is None else to_tensors(padded, self.device)
        self._epoch += 1
        if self.sampler is not None:
            self.sampler.step_epoch()

    def padding_waste(self) -> float:
        """Fraction of processed node+edge slots that were padding."""
        total = self._real_slots + self._padded_slots
        return self._padded_slots / total if total else 0.0

    # --- restartable state ---------------------------------------------
    def state_dict(self) -> dict:
        return {"epoch": self._epoch, "sampler": self.sampler.state_dict() if self.sampler is not None else None}

    def load_state_dict(self, state: dict) -> None:
        self._epoch = int(state["epoch"])
        if state.get("sampler") is not None and self.sampler is not None:
            self.sampler.load_state_dict(state["sampler"])
