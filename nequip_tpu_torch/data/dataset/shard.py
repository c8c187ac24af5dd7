"""ShardDataset: single-file, mmap-backed, random-access frame storage.

Port of ``nequip_tpu/data/dataset/shard.py``: the same ``NQSHARD1`` file,
byte for byte, so either package reads the other's shards.  The user
contract is an LMDB dataset's (``save_from_iterator`` writer,
``get_metadata``, a lazy open per process, ``num_atoms_per_entry``
metadata), with

* **zero-copy reads**: one ``mmap`` per process; every array of a frame is
  a read-only ``np.frombuffer`` view into the page cache.  The loader
  copies what reaches a tensor (``atomic_data_dict.to_tensors``);
* **O(1) random access**: a flat ``uint64`` offset table maps an entry id
  to its byte span, which shuffled epochs over millions of frames need;
* **one ordinary file**.

File layout (little-endian):

    magic  b"NQSHARD1"
    u64    header_len          # JSON header bytes
    header JSON {version, num_entries, index_offset, metadata_offset}
    entry blobs (back to back)
    metadata blob              # same TLV encoding as an entry
    index: (num_entries + 1) * u64 absolute offsets (entry i = [o[i], o[i+1]))

Entry blob encoding (TLV per field):

    u32 n_fields
    per field: u16 name_len | name utf8 | u8 dtype_code | u8 ndim |
               u64 * ndim shape | raw C-order data (8-byte aligned)
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, List, Optional

import numpy as np

from .. import _keys
from .base import AtomicDataset

_MAGIC = b"NQSHARD1"

# stable on-disk dtype codes (never reorder)
_DTYPES = [
    np.dtype("float64"),
    np.dtype("float32"),
    np.dtype("int64"),
    np.dtype("int32"),
    np.dtype("bool"),
    np.dtype("uint8"),
    np.dtype("float16"),
    np.dtype("int16"),
]
_DTYPE_CODE = {dt: i for i, dt in enumerate(_DTYPES)}


def _align8(n: int) -> int:
    return (n + 7) & ~7


def _encode_entry(frame: Dict[str, np.ndarray]) -> bytes:
    parts = [struct.pack("<I", len(frame))]
    pos = 4
    for name, value in sorted(frame.items()):
        arr = np.ascontiguousarray(value)
        if arr.dtype not in _DTYPE_CODE:
            # canonicalize exotic dtypes (e.g. platform ints, str -> error)
            if np.issubdtype(arr.dtype, np.integer):
                arr = arr.astype(np.int64)
            elif np.issubdtype(arr.dtype, np.floating):
                arr = arr.astype(np.float64)
            else:
                raise TypeError(
                    f"ShardDataset cannot store field {name!r} of dtype {arr.dtype}"
                )
        nb = name.encode()
        head = (
            struct.pack("<H", len(nb))
            + nb
            + struct.pack("<BB", _DTYPE_CODE[arr.dtype], arr.ndim)
            + struct.pack(f"<{arr.ndim}Q", *arr.shape)
        )
        parts.append(head)
        pos += len(head)
        pad = _align8(pos) - pos
        parts.append(b"\x00" * pad)
        pos += pad
        raw = arr.tobytes()
        parts.append(raw)
        pos += len(raw)
    # pad the blob to 8 bytes so every entry starts 8-aligned and the
    # relative alignment used while encoding equals the absolute alignment
    # used while decoding
    parts.append(b"\x00" * (_align8(pos) - pos))
    return b"".join(parts)


def _decode_entry(buf, offset: int, end: int) -> Dict[str, np.ndarray]:
    (n_fields,) = struct.unpack_from("<I", buf, offset)
    pos = offset + 4
    out: Dict[str, np.ndarray] = {}
    for _ in range(n_fields):
        (name_len,) = struct.unpack_from("<H", buf, pos)
        pos += 2
        name = bytes(buf[pos : pos + name_len]).decode()
        pos += name_len
        code, ndim = struct.unpack_from("<BB", buf, pos)
        pos += 2
        shape = struct.unpack_from(f"<{ndim}Q", buf, pos)
        pos += 8 * ndim
        pos = _align8(pos)  # entries are 8-aligned, so absolute == relative
        dt = _DTYPES[code]
        count = int(np.prod(shape)) if ndim else 1
        arr = np.frombuffer(buf, dtype=dt, count=count, offset=pos).reshape(shape)
        pos += count * dt.itemsize
        out[name] = arr
    assert pos <= end, "corrupt shard entry"
    return out


class ShardDataset(AtomicDataset):
    """Frames stored in a single mmap-backed ``.nqs`` shard file.

    ``save_from_iterator`` writer, lazy per-process open (fork-safe for
    dataloader workers), ``get_metadata`` with the ``num_atoms_per_entry``
    convention.
    """

    def __init__(self, file_path: str, transforms=None):
        super().__init__(transforms)
        self.file_path = file_path
        self._mm = None
        self._pid = None
        self._index = None
        self._header = None

    # -- lazy, fork-safe open -------------------------------------------
    def _ensure_open(self):
        pid = os.getpid()
        if self._mm is not None and self._pid == pid:
            return
        f = open(self.file_path, "rb")
        self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        f.close()
        self._pid = pid
        if self._mm[:8] != _MAGIC:
            raise ValueError(f"{self.file_path}: not a NQSHARD1 file")
        (hlen,) = struct.unpack_from("<Q", self._mm, 8)
        self._header = json.loads(bytes(self._mm[16 : 16 + hlen]).decode())
        n = self._header["num_entries"]
        self._index = np.frombuffer(
            self._mm, dtype=np.uint64, count=n + 1,
            offset=self._header["index_offset"],
        )

    def __len__(self) -> int:
        self._ensure_open()
        return self._header["num_entries"]

    def get_frame(self, idx: int) -> dict:
        """Decode entry ``idx`` as a dict of arrays.

        The arrays are zero-copy READ-ONLY views into the mmap (unlike
        LMDB's deserialized copies): transforms that mutate arrays in place
        will raise ``ValueError: assignment destination is read-only`` —
        copy first (``{k: np.array(v) for ...}``) if in-place mutation is
        needed.  All in-repo transforms rebind rather than mutate.
        """
        self._ensure_open()
        n = self._header["num_entries"]
        if not 0 <= idx < n:
            raise IndexError(idx)
        return _decode_entry(
            self._mm, int(self._index[idx]), int(self._index[idx + 1])
        )

    def get_metadata(self, key: str):
        self._ensure_open()
        if key in self._header.get("metadata_json", {}):
            return self._header["metadata_json"][key]
        off = self._header.get("metadata_offset")
        if off is None:
            return None
        meta = _decode_entry(self._mm, off, self._header["index_offset"])
        return meta.get(key)

    # -- writer ----------------------------------------------------------
    @classmethod
    def save_from_iterator(
        cls,
        file_path: str,
        iterator,
        metadata: Optional[dict] = None,
    ) -> None:
        """Stream frames to a shard file (constant memory).

        As an LMDB dataset's ``save_from_iterator``; ``metadata`` values
        must be numpy-encodable arrays/scalars.
        """
        tmp = file_path + ".tmp"
        offsets: List[int] = []
        num_atoms: List[int] = []
        with open(tmp, "wb") as f:
            # placeholder header; rewritten at the end with real offsets
            f.write(_MAGIC)
            f.write(struct.pack("<Q", 0))
            header_reserved = 4080  # entries start at 16 + 4080 = 4096
            f.write(b"\x00" * header_reserved)
            pos = f.tell()
            for frame in iterator:
                offsets.append(pos)
                blob = _encode_entry(
                    {k: np.asarray(v) for k, v in frame.items()}
                )
                f.write(blob)
                pos += len(blob)
                # one entry per frame, ALWAYS: with a mixed iterator the
                # auto metadata would otherwise silently misalign with entry
                # indices (positions-less frames get a -1 sentinel)
                num_atoms.append(
                    len(frame[_keys.POSITIONS_KEY])
                    if _keys.POSITIONS_KEY in frame
                    else -1
                )
            offsets.append(pos)

            # split metadata into array-valued (stored in the TLV blob,
            # zero-copy) and JSON-able (str/int/list -> header)
            meta: Dict[str, np.ndarray] = {}
            meta_json: Dict[str, object] = {}
            for k, v in (metadata or {}).items():
                if isinstance(v, (str, bool, int, float)) or (
                    isinstance(v, (list, tuple))
                    and any(isinstance(x, str) for x in v)
                ):
                    meta_json[k] = list(v) if isinstance(v, tuple) else v
                else:
                    meta[k] = np.asarray(v)
            if num_atoms and "num_atoms_per_entry" not in meta:
                meta["num_atoms_per_entry"] = np.asarray(num_atoms)
            metadata_offset = pos
            mblob = _encode_entry(meta)
            f.write(mblob)
            index_offset = metadata_offset + len(mblob)
            f.write(np.asarray(offsets, dtype=np.uint64).tobytes())

            header = json.dumps(
                {
                    "version": 1,
                    "num_entries": len(offsets) - 1,
                    "index_offset": index_offset,
                    "metadata_offset": metadata_offset,
                    "metadata_json": meta_json,
                }
            ).encode()
            if len(header) > header_reserved:
                raise RuntimeError(
                    "shard header overflow (too much non-array metadata; "
                    "store large values as arrays instead)"
                )
            f.seek(8)
            f.write(struct.pack("<Q", len(header)))
            f.write(header)
        os.replace(tmp, file_path)
