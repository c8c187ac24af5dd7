"""A data module of extended-XYZ files.

Port of ``nequip_tpu/data/datamodule/ase.py`` (``ASEDataModule``): train,
val and test files (a list makes val0, val1, ... or test0, test1, ...) or
one file split by ``split_dataset``, each read by ``ASEDataset``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

from .base import NequIPDataModule


class ASEDataModule(NequIPDataModule):
    def __init__(
        self,
        seed: int = 0,
        train_file_path: Optional[str] = None,
        val_file_path: Optional[Union[str, List[str]]] = None,
        test_file_path: Optional[Union[str, List[str]]] = None,
        split_dataset: Optional[dict] = None,
        transforms: Sequence = (),
        ase_args: Optional[dict] = None,
        key_mapping: Optional[Dict[str, str]] = None,
        include_keys: Optional[List[str]] = None,
        **kwargs,
    ):
        def ds_cfg(path):
            return {
                "_target_": "nequip_tpu_torch.data.dataset.ASEDataset",
                "file_path": path,
                "ase_args": ase_args,
                "key_mapping": key_mapping,
                "include_keys": include_keys,
                "transforms": list(transforms),
            }

        def many(paths):
            if paths is None:
                return None
            if isinstance(paths, (list, tuple)):
                return [ds_cfg(p) for p in paths]
            return ds_cfg(paths)

        if split_dataset is not None and "file_path" in split_dataset:
            split_dataset = dict(split_dataset)
            split_dataset["dataset"] = ds_cfg(split_dataset.pop("file_path"))

        super().__init__(
            seed=seed,
            train_dataset=many(train_file_path),
            val_dataset=many(val_file_path),
            test_dataset=many(test_file_path),
            split_dataset=split_dataset,
            **kwargs,
        )
