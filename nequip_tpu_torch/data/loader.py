"""Batched, padded data loading.

Port of ``nequip_tpu/data/loader.py``: the same batches in the same order
from the same seed, padded to the same capacities (the padding contract
of ``atomic_data_dict.pad_batch``).

Capacity policy:

* ``n_buckets=1`` (default): every batch pads to the worst case (max
  frame size x batch_size), or to a fixed ``capacity``;
* ``n_buckets>1``: a ladder of capacities (``buckets``) is built from
  simulated batch needs, and each batch pads to the smallest bucket that
  fits.  On a dataset of mixed frame sizes this bounds the padding
  (``padding_waste``), at the cost of one set of kernel shapes per bucket
  (the kernels keep no state per shape: tables per device and dtype,
  carry rows per call).

Shuffling is keyed by (seed, epoch); ``num_samples_per_epoch`` splits one
pass over a large dataset into many short epochs (``PartialSampler``).
``state_dict`` holds the epoch counter and the sampler's, which is what a
resumed run restores to continue at the same data position.  Not ported
yet: per-process sharding (``process_index``/``process_count``).
"""

from __future__ import annotations

import logging
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from . import _keys
from ._sampler import PartialSampler
from ..utils.device import resolve_device
from .atomic_data_dict import batched_from_list, pad_batch, round_up, to_tensors

log = logging.getLogger("nequip_tpu_torch")


class DataLoader:
    """``device``: where ``__iter__`` puts the padded tensors, the card by
    default (raising without one); None keeps the padded numpy dicts."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        capacity: Optional[Dict[str, int]] = None,
        pad_multiple: int = 64,
        drop_last: bool = False,
        device="cuda",
        n_buckets: int = 1,
        num_samples_per_epoch: Optional[int] = None,
    ):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = int(seed)
        self.drop_last = drop_last
        self.pad_multiple = int(pad_multiple)
        self.device = None if device is None else resolve_device(device)
        if int(n_buckets) < 1:
            raise ValueError(f"n_buckets must be >= 1, got {n_buckets}")
        self.n_buckets = int(n_buckets)
        self._epoch = 0
        self._capacity = capacity
        self._buckets: Optional[List[Dict[str, int]]] = None
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
        """Worst-case (top-bucket) capacity, unless a fixed one was given."""
        if self._capacity is None:
            nodes, edges = self._frame_sizes()
            self._capacity = {
                "n_nodes": round_up(int(nodes.max()) * self.batch_size + 1, self.pad_multiple),
                "n_edges": round_up(max(int(edges.max()) * self.batch_size, 1), self.pad_multiple),
                "n_frames": self.batch_size + 1,
            }
        return self._capacity

    def _build_buckets(self) -> List[Dict[str, int]]:
        """The ladder of (n_nodes, n_edges) capacities, ascending.

        The needs of 256 random batches (seeded) are sorted by total size
        and cut into ``n_buckets`` segments by a dynamic program that
        minimises the padded slots (a segment's capacity is its largest
        need).  The top bucket is the worst case, so every batch fits one.
        """
        top = self.capacity
        if self.n_buckets == 1:
            return [dict(top)]
        nodes, edges = self._frame_sizes()
        n = len(nodes)
        rng = np.random.RandomState(self.seed ^ 0x5EED)
        m = 256
        needs = np.empty((m, 2), dtype=np.int64)
        for s in range(m):
            idx = rng.choice(n, size=min(self.batch_size, n), replace=False)
            needs[s] = (nodes[idx].sum() + 1, max(edges[idx].sum(), 1))
        needs = needs[np.argsort(needs.sum(axis=1))]

        # seg_cost[i, j]: batches i..j-1 padded to their largest need
        seg_cost = np.full((m, m + 1), np.inf)
        for i in range(m):
            mx = np.zeros(2, dtype=np.int64)
            for j in range(i + 1, m + 1):
                mx = np.maximum(mx, needs[j - 1])
                seg_cost[i, j] = (j - i) * float(mx.sum())

        k = min(self.n_buckets, m)
        dp = np.full((k + 1, m + 1), np.inf)
        back = np.zeros((k + 1, m + 1), dtype=np.int64)
        dp[0, 0] = 0.0
        for kk in range(1, k + 1):
            for j in range(1, m + 1):
                costs = dp[kk - 1, :j] + seg_cost[:j, j]
                i = int(np.argmin(costs))
                dp[kk, j], back[kk, j] = costs[i], i

        bounds = []
        j = m
        for kk in range(k, 0, -1):
            bounds.append(j)
            j = int(back[kk, j])
        buckets: List[Dict[str, int]] = []
        start = 0
        for j in bounds[::-1]:
            seg = needs[start:j]
            start = j
            if len(seg) == 0:
                continue
            b = {
                "n_nodes": round_up(int(seg[:, 0].max()), self.pad_multiple),
                "n_edges": round_up(int(seg[:, 1].max()), self.pad_multiple),
                "n_frames": self.batch_size + 1,
            }
            if buckets and b["n_nodes"] <= buckets[-1]["n_nodes"] and b["n_edges"] <= buckets[-1]["n_edges"]:
                continue
            buckets.append(b)
        if not buckets or top["n_nodes"] > buckets[-1]["n_nodes"] or top["n_edges"] > buckets[-1]["n_edges"]:
            buckets.append(dict(top))
        return buckets

    @property
    def buckets(self) -> List[Dict[str, int]]:
        if self._buckets is None:
            self._buckets = self._build_buckets()
        return self._buckets

    def _pick_bucket(self, need_nodes: int, need_edges: int) -> Dict[str, int]:
        for b in self.buckets:
            if b["n_nodes"] >= need_nodes and b["n_edges"] >= need_edges:
                return b
        # only a fixed capacity below the data's worst case gets here
        log.warning(f"batch needs ({need_nodes} nodes, {need_edges} edges) exceeds the top bucket "
                    f"{self.buckets[-1]}; padding ad hoc")
        return {
            "n_nodes": round_up(need_nodes, self.pad_multiple),
            "n_edges": round_up(need_edges, self.pad_multiple),
            "n_frames": self.batch_size + 1,
        }

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
            cap = self._pick_bucket(n_real + 1, max(e_real, 1))
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
