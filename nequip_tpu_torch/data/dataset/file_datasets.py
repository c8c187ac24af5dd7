"""File-backed datasets: NPZ, HDF5, extxyz (``ASEDataset``) and LMDB.

Port of ``nequip_tpu/data/dataset/file_datasets.py``: the same key maps
and the same frames.  ``h5py`` and ``lmdb`` are imported where they are
used, so the classes that need them raise a clear ``ImportError`` only
when they are built without them.  ``ASEDataset`` reads ``.xyz`` and
``.extxyz`` files with the port's own parser (``data/xyz.py``, the JAX
class's fallback without ``ase``); reading other formats through ``ase``
is not ported.  Every file is read on the host; frames reach the card
through the loader.
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import _keys
from .base import AtomicDataset

# keys that are per-frame scalars/tensors vs per-atom arrays in flat files
_DEFAULT_KEY_MAPPING = {
    "energy": _keys.TOTAL_ENERGY_KEY,
    "E": _keys.TOTAL_ENERGY_KEY,
    "forces": _keys.FORCE_KEY,
    "F": _keys.FORCE_KEY,
    "force": _keys.FORCE_KEY,
    "R": _keys.POSITIONS_KEY,
    "positions": _keys.POSITIONS_KEY,
    "z": _keys.ATOMIC_NUMBERS_KEY,
    "atomic_numbers": _keys.ATOMIC_NUMBERS_KEY,
}


class NPZDataset(AtomicDataset):
    """sGDML-style NPZ: arrays with a leading frame dimension; species shared."""

    def __init__(
        self,
        file_path: str,
        key_mapping: Optional[Dict[str, str]] = None,
        transforms=None,
    ):
        super().__init__(transforms)
        self.file_path = file_path
        mapping = dict(_DEFAULT_KEY_MAPPING)
        mapping.update(key_mapping or {})
        raw = np.load(file_path, allow_pickle=False)
        self._data: Dict[str, np.ndarray] = {}
        for k in raw.files:
            self._data[mapping.get(k, k)] = raw[k]
        pos = self._data[_keys.POSITIONS_KEY]
        assert pos.ndim == 3, "NPZ positions must be (n_frames, n_atoms, 3)"
        self._n = pos.shape[0]
        self._n_atoms = pos.shape[1]
        z = self._data.get(_keys.ATOMIC_NUMBERS_KEY)
        self._shared_z = z is not None and z.ndim == 1

    def __len__(self) -> int:
        return self._n

    def get_frame(self, idx: int) -> dict:
        out = {}
        for k, v in self._data.items():
            if k == _keys.ATOMIC_NUMBERS_KEY and self._shared_z:
                out[k] = v
            elif v.ndim >= 1 and v.shape[0] == self._n:
                out[k] = v[idx]
            else:
                out[k] = v
        return out


class HDF5Dataset(AtomicDataset):
    """HDF5 with one group per frame or flat arrays with a frame axis."""

    def __init__(self, file_path: str, key_mapping=None, transforms=None):
        super().__init__(transforms)
        import h5py

        self.file_path = file_path
        self._mapping = dict(_DEFAULT_KEY_MAPPING)
        self._mapping.update(key_mapping or {})
        self._h5 = None
        with h5py.File(file_path, "r") as f:
            self._frame_keys = sorted(k for k in f.keys())
            self._grouped = all(isinstance(f[k], h5py.Group) for k in self._frame_keys)
            if not self._grouped:
                self._n = f[self._frame_keys[0]].shape[0]

    def _file(self):
        import h5py

        if self._h5 is None:
            self._h5 = h5py.File(self.file_path, "r")
        return self._h5

    def __len__(self) -> int:
        return len(self._frame_keys) if self._grouped else self._n

    def get_frame(self, idx: int) -> dict:
        f = self._file()
        out = {}
        if self._grouped:
            grp = f[self._frame_keys[idx]]
            for k in grp.keys():
                out[self._mapping.get(k, k)] = np.asarray(grp[k])
        else:
            for k in self._frame_keys:
                out[self._mapping.get(k, k)] = np.asarray(f[k][idx])
        return out


class ASEDataset(AtomicDataset):
    """Frames of an extended-XYZ file (``ase_args`` is accepted for the
    JAX class's signature and unused by the built-in parser)."""

    def __init__(
        self,
        file_path: str,
        ase_args: Optional[dict] = None,
        include_keys: Optional[Sequence[str]] = None,
        key_mapping: Optional[Dict[str, str]] = None,
        transforms=None,
    ):
        super().__init__(transforms)
        if not file_path.endswith((".xyz", ".extxyz")):
            try:
                import ase.io  # noqa: F401
            except ImportError:
                raise ImportError(
                    "ASEDataset requires the optional `ase` package for "
                    f"non-xyz files (got {file_path!r})"
                ) from None
            raise NotImplementedError(
                f"ASEDataset reads .xyz/.extxyz files only (got {file_path!r}): reading other formats "
                "through ase (the JAX package's data/ase_adapter.py) is not ported"
            )
        from ..xyz import read_extxyz

        self._frames = read_extxyz(file_path, key_mapping=key_mapping, include_keys=include_keys)

    def __len__(self) -> int:
        return len(self._frames)

    def get_frame(self, idx: int) -> dict:
        return dict(self._frames[idx])


class LMDBDataset(AtomicDataset):
    """Pickled AtomicDataDict frames in an LMDB environment.

    A lazy environment (opened on first use), the ``save_from_iterator``
    writer and the metadata keys of the JAX class.  Requires the optional
    ``lmdb`` package.
    """

    _METADATA_PREFIX = b"__metadata__"

    def __init__(self, file_path: str, transforms=None):
        super().__init__(transforms)
        self.file_path = file_path
        self._env = None
        self._len = None

    def _get_env(self):
        import lmdb

        if self._env is None:
            self._env = lmdb.open(
                self.file_path,
                readonly=True,
                lock=False,
                readahead=False,
                meminit=False,
                subdir=False,
            )
        return self._env

    def __len__(self) -> int:
        if self._len is None:
            with self._get_env().begin() as txn:
                n = txn.get(self._METADATA_PREFIX + b"num_entries")
                self._len = int(n.decode()) if n is not None else 0
        return self._len

    def get_frame(self, idx: int) -> dict:
        with self._get_env().begin() as txn:
            raw = txn.get(str(idx).encode())
        if raw is None:
            raise IndexError(idx)
        return pickle.loads(raw)

    def get_metadata(self, key: str):
        with self._get_env().begin() as txn:
            raw = txn.get(self._METADATA_PREFIX + key.encode())
        return pickle.loads(raw) if raw is not None else None

    @classmethod
    def save_from_iterator(
        cls,
        file_path: str,
        iterator,
        metadata: Optional[dict] = None,
        map_size: int = 1 << 40,
    ) -> None:
        import lmdb

        env = lmdb.open(file_path, map_size=map_size, subdir=False)
        count = 0
        num_atoms_per_entry: List[int] = []
        with env.begin(write=True) as txn:
            for i, frame in enumerate(iterator):
                txn.put(str(i).encode(), pickle.dumps(frame))
                num_atoms_per_entry.append(len(frame[_keys.POSITIONS_KEY]))
                count += 1
            txn.put(cls._METADATA_PREFIX + b"num_entries", str(count).encode())
            txn.put(
                cls._METADATA_PREFIX + b"num_atoms_per_entry",
                pickle.dumps(np.asarray(num_atoms_per_entry)),
            )
            for k, v in (metadata or {}).items():
                txn.put(cls._METADATA_PREFIX + k.encode(), pickle.dumps(v))
        env.close()
