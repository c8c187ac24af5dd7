"""Write the model's test-time predictions to an extended-XYZ file.

Port of ``nequip_tpu/train/callbacks/write_xyz.py``, with its own extxyz
writer (no ``ase``): per frame the atom count, a comment line with the
lattice, the predicted energy and the properties, then one row per atom
of species, position and predicted forces, 8 decimals.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from ...data import _keys, frame_from_batched
from ...data.transforms.type_mapper import CHEMICAL_SYMBOLS
from .base import Callback


def _symbol(z: int) -> str:
    return CHEMICAL_SYMBOLS[z] if 0 < z < len(CHEMICAL_SYMBOLS) else "X"


def write_extxyz_frame(fh, frame: dict) -> None:
    pos = np.asarray(frame[_keys.POSITIONS_KEY])
    n = pos.shape[0]
    comment = []
    if _keys.CELL_KEY in frame:
        cell = np.asarray(frame[_keys.CELL_KEY]).reshape(3, 3)
        comment.append('Lattice="' + " ".join(f"{x:.8f}" for x in cell.reshape(-1)) + '"')
    if _keys.TOTAL_ENERGY_KEY in frame:
        comment.append(f"energy={float(np.asarray(frame[_keys.TOTAL_ENERGY_KEY]).reshape(-1)[0]):.10f}")
    props = "species:S:1:pos:R:3"
    cols = []
    if _keys.FORCE_KEY in frame:
        props += ":forces:R:3"
        cols.append(np.asarray(frame[_keys.FORCE_KEY]))
    comment.append(f"Properties={props}")
    fh.write(f"{n}\n{' '.join(comment)}\n")
    zs = np.asarray(frame.get(_keys.ATOMIC_NUMBERS_KEY, np.zeros(n, dtype=int))).reshape(-1)
    for i in range(n):
        row = f"{_symbol(int(zs[i]))} " + " ".join(f"{x:.8f}" for x in pos[i])
        for c in cols:
            row += " " + " ".join(f"{x:.8f}" for x in c[i])
        fh.write(row + "\n")


def _host(d: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in d.items() if isinstance(v, torch.Tensor)}


class TestTimeXYZFileWriter(Callback):
    def __init__(self, out_file: str, output_fields_from_original_dataset: Optional[List[str]] = None):
        self.out_file = out_file
        self._fh = None

    def on_eval_batch(self, output: dict, batch: dict) -> None:
        if self._fh is None:
            os.makedirs(os.path.dirname(self.out_file) or ".", exist_ok=True)
            self._fh = open(self.out_file, "w")
        host = _host(output)
        batch = _host(batch)
        for k in (_keys.BATCH_KEY, _keys.NUM_NODES_KEY, _keys.ATOMIC_NUMBERS_KEY,
                  _keys.NODE_MASK_KEY, _keys.EDGE_MASK_KEY, _keys.FRAME_MASK_KEY):
            if k in batch and k not in host:
                host[k] = batch[k]
        n_real = (int(batch[_keys.FRAME_MASK_KEY].sum()) if _keys.FRAME_MASK_KEY in batch
                  else host[_keys.NUM_NODES_KEY].shape[0])
        for i in range(n_real):
            write_extxyz_frame(self._fh, frame_from_batched(host, i))
        self._fh.flush()

    def on_test_epoch_end(self, trainer, module, metrics) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
