"""PartialSampler: deterministic partial epochs over large datasets.

Port of ``nequip_tpu/data/_sampler.py``: a fixed number of frames per
"epoch", advancing deterministically through a full shuffle of the dataset
across epochs (the same order from the same seed as the JAX package).
Its state is the epoch counter, so a resumed run continues at the same
window of the same shuffle.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class PartialSampler:
    def __init__(
        self,
        data_source_len: int,
        num_samples_per_epoch: Optional[int] = None,
        shuffle: bool = True,
        seed: int = 0,
    ):
        self.n = int(data_source_len)
        self.num_samples = int(num_samples_per_epoch) if num_samples_per_epoch else self.n
        if self.num_samples > self.n:
            raise ValueError("num_samples_per_epoch exceeds the dataset size")
        self.shuffle = shuffle
        self.seed = int(seed)
        self._epoch = 0  # full-shuffle cycles are keyed by this

    def step_epoch(self) -> None:
        self._epoch += 1

    def state_dict(self) -> dict:
        return {"epoch": self._epoch}

    def load_state_dict(self, sd: dict) -> None:
        self._epoch = int(sd["epoch"])

    def __len__(self) -> int:
        return self.num_samples

    def _cycle_order(self, cycle: int) -> np.ndarray:
        if self.shuffle:
            return np.random.RandomState(self.seed + cycle).permutation(self.n)
        return np.arange(self.n)

    def __iter__(self):
        pos = (self._epoch * self.num_samples) % self.n
        cycle = (self._epoch * self.num_samples) // self.n
        order = self._cycle_order(cycle)
        idx = []
        for _ in range(self.num_samples):
            if pos >= self.n:  # the window wraps into the next cycle's shuffle
                pos, cycle = 0, cycle + 1
                order = self._cycle_order(cycle)
            idx.append(int(order[pos]))
            pos += 1
        return iter(idx)
