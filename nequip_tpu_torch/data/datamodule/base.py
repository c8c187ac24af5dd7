"""Datamodule: datasets, their train/val/test split, loaders and statistics.

Port of ``nequip_tpu/data/datamodule/base.py`` (``NequIPDataModule``).
Datasets and the statistics manager are objects or ``_target_`` configs
(built at ``setup``, as the training CLI hands them over).
``split_dataset`` is a dict (or a list of dicts) ``{"dataset": ...,
"train": n_or_fraction, "val": ..., "test": ..., "seed": optional}``,
split by ``RandomSplitDataset`` with the datamodule's seed, as in the JAX
package.  Its loaders put batches on the card (``device="cuda"``, raising
without one) unless the caller asks for the CPU; statistics read the host
batches.  ``state_dict`` holds every built loader's state.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

from ...utils.config import instantiate
from ...utils.device import resolve_device
from ..dataset.base import AtomicDataset, RandomSplitDataset
from ..loader import DataLoader
from ..stats_manager import DataStatisticsManager

SPLITS = ("train", "val", "test", "predict")


def _build_dataset(cfg) -> AtomicDataset:
    return cfg if isinstance(cfg, AtomicDataset) else instantiate(cfg)


class NequIPDataModule:
    def __init__(
        self,
        seed: int = 0,
        train_dataset: Optional[Union[AtomicDataset, Sequence[AtomicDataset]]] = None,
        val_dataset: Optional[Union[AtomicDataset, Sequence[AtomicDataset]]] = None,
        test_dataset: Optional[Union[AtomicDataset, Sequence[AtomicDataset]]] = None,
        predict_dataset: Optional[Union[AtomicDataset, Sequence[AtomicDataset]]] = None,
        split_dataset: Optional[Union[dict, List[dict]]] = None,
        train_dataloader: Optional[dict] = None,
        val_dataloader: Optional[dict] = None,
        test_dataloader: Optional[dict] = None,
        predict_dataloader: Optional[dict] = None,
        stats_manager: Optional[Union[dict, DataStatisticsManager]] = None,
        device="cuda",
    ):
        self.seed = int(seed)
        self.device = None if device is None else resolve_device(device)
        self._given = dict(zip(SPLITS, (train_dataset, val_dataset, test_dataset, predict_dataset)))
        self._split_config = split_dataset
        self._loader_kwargs = dict(
            zip(SPLITS, (dict(c or {}) for c in (train_dataloader, val_dataloader, test_dataloader,
                                                  predict_dataloader)))
        )
        self.stats_manager = instantiate(stats_manager) if isinstance(stats_manager, dict) else stats_manager
        self.datasets: Dict[str, List[AtomicDataset]] = {}
        self._loaders: Dict[str, List[DataLoader]] = {}

    def setup(self, stage: Optional[str] = None) -> None:
        if self.datasets:
            return
        datasets: Dict[str, List[AtomicDataset]] = {s: [] for s in SPLITS}
        for split, ds in self._given.items():
            if ds is not None:
                datasets[split].extend(_build_dataset(d) for d in (ds if isinstance(ds, (list, tuple)) else [ds]))
        if self._split_config is not None:
            cfgs = self._split_config if isinstance(self._split_config, (list, tuple)) else [self._split_config]
            for sc in cfgs:
                sc = dict(sc)
                base = _build_dataset(sc.pop("dataset"))
                seed = int(sc.pop("seed", self.seed))
                for name, sub in RandomSplitDataset(base, sc, seed=seed).items():
                    datasets[name].append(sub)
        if not any(datasets.values()):
            raise ValueError("the datamodule has no datasets")
        self.datasets = datasets

    def _make_loaders(self, split: str) -> List[DataLoader]:
        if split not in self._loaders:
            kwargs = dict(self._loader_kwargs[split])
            kwargs.setdefault("batch_size", 1)
            if split == "train":
                kwargs.setdefault("shuffle", True)
            kwargs.setdefault("seed", self.seed)
            kwargs.setdefault("device", self.device)
            self._loaders[split] = [DataLoader(ds, **kwargs) for ds in self.datasets.get(split, [])]
        return self._loaders[split]

    def train_dataloader(self) -> DataLoader:
        loaders = self._make_loaders("train")
        if len(loaders) != 1:
            raise ValueError("exactly one train dataset is supported")
        return loaders[0]

    def val_dataloaders(self) -> List[DataLoader]:
        return self._make_loaders("val")

    def test_dataloaders(self) -> List[DataLoader]:
        return self._make_loaders("test")

    def predict_dataloaders(self) -> List[DataLoader]:
        return self._make_loaders("predict")

    def get_statistics(self, dataset: str = "train"):
        """Statistics of the first dataset of a split (host batches)."""
        if self.stats_manager is None:
            raise ValueError("no stats_manager configured")
        self.setup("fit")
        kwargs = dict(self.stats_manager.dataloader_kwargs)
        kwargs.setdefault("batch_size", 8)
        kwargs.setdefault("device", None)
        return self.stats_manager.get_statistics(DataLoader(self.datasets[dataset][0], **kwargs))

    def state_dict(self) -> dict:
        return {"loaders": {split: [ld.state_dict() for ld in lds] for split, lds in self._loaders.items()}}

    def load_state_dict(self, sd: dict) -> None:
        for split, states in sd.get("loaders", {}).items():
            for ld, s in zip(self._make_loaders(split), states):
                ld.load_state_dict(s)
