"""Tag every frame with the index of its dataset.

Port of ``nequip_tpu/data/transforms/dataset.py``.
"""

from __future__ import annotations

import numpy as np

from .. import _keys


class DatasetIndexTransform:
    def __init__(self, dataset_index: int):
        self.dataset_index = int(dataset_index)

    def __call__(self, data: dict) -> dict:
        data[_keys.DATASET_KEY] = np.array([[self.dataset_index]], dtype=np.int32)
        return data
