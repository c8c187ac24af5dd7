"""Pure-numpy extended-XYZ reader and writer (no ``ase``).

Port of ``nequip_tpu/data/xyz.py``: the same key map, the same parse and
the same ``%.10f`` text, so the two packages write byte-identical files.
``ASEDataset`` reads ``.xyz``/``.extxyz`` files with it when ``ase`` is
absent.  Format: the libAtoms extended-XYZ spec (as ``ase.io.extxyz``
writes it): a line with the atom count, a comment line of ``key=value``
pairs (``Lattice`` = 9 floats, rows are the cell vectors;
``Properties=name:type:ncols:...`` describes the per-atom columns), then
one row per atom.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import _keys
from .transforms.type_mapper import ATOMIC_NUMBERS, CHEMICAL_SYMBOLS

# key=value tokens; values may be double-quoted (with spaces) or bare
_KV_RE = re.compile(r'(\S+?)=(?:"([^"]*)"|(\S+))')

# default file-key -> canonical-field mapping (matches from_ase conventions)
_DEFAULT_KEY_MAP = {
    "energy": _keys.TOTAL_ENERGY_KEY,
    "free_energy": "free_energy",
    "forces": _keys.FORCE_KEY,
    "force": _keys.FORCE_KEY,
    "stress": _keys.STRESS_KEY,
    "virial": _keys.VIRIAL_KEY,
}

_BOOL = {"T": True, "F": False, "True": True, "False": False}


def _parse_value(s: str):
    parts = s.split()
    if all(p in _BOOL for p in parts):
        vals = [_BOOL[p] for p in parts]
        return vals[0] if len(vals) == 1 else np.asarray(vals)
    try:
        vals = [int(p) for p in parts]
        return vals[0] if len(vals) == 1 else np.asarray(vals)
    except ValueError:
        pass
    try:
        vals = [float(p) for p in parts]
        return vals[0] if len(vals) == 1 else np.asarray(vals, dtype=np.float64)
    except ValueError:
        return s


def _parse_comment(line: str) -> Dict[str, object]:
    out: Dict[str, object] = {}
    for m in _KV_RE.finditer(line):
        key = m.group(1)
        raw = m.group(2) if m.group(2) is not None else m.group(3)
        out[key] = _parse_value(raw)
    return out


def _parse_properties(spec: str):
    """'species:S:1:pos:R:3' -> [(name, kind, ncols), ...]."""
    toks = spec.split(":")
    assert len(toks) % 3 == 0, f"malformed Properties spec {spec!r}"
    return [
        (toks[i], toks[i + 1], int(toks[i + 2])) for i in range(0, len(toks), 3)
    ]


def read_extxyz(
    file_path: str,
    index=":",
    key_mapping: Optional[Dict[str, str]] = None,
    include_keys: Optional[Sequence[str]] = None,
) -> List[dict]:
    """Read extxyz frames into canonical AtomicDataDict-style host dicts."""
    key_map = dict(_DEFAULT_KEY_MAP)
    if key_mapping:
        key_map.update(key_mapping)

    frames: List[dict] = []
    with open(file_path) as f:
        lines = f.read().splitlines()
    i = 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        natoms = int(lines[i].strip())
        info = _parse_comment(lines[i + 1])
        props = _parse_properties(str(info.pop("Properties", "species:S:1:pos:R:3")))
        rows = [lines[i + 2 + a].split() for a in range(natoms)]
        i += 2 + natoms

        frame: dict = {}
        col = 0
        for name, kind, ncols in props:
            block = [r[col : col + ncols] for r in rows]
            col += ncols
            if kind == "S":
                vals = np.asarray(block).reshape(natoms, ncols)
                if name == "species":
                    frame[_keys.ATOMIC_NUMBERS_KEY] = np.asarray(
                        [ATOMIC_NUMBERS[s] for s in vals[:, 0]], dtype=np.int64
                    )
                continue
            dtype = {"R": np.float64, "I": np.int64, "L": bool}[kind]
            if kind == "L":
                arr = np.asarray(
                    [[_BOOL[x] for x in r] for r in block], dtype=bool
                )
            else:
                arr = np.asarray(block, dtype=dtype)
            arr = arr.reshape(natoms, ncols)
            if ncols == 1 and name not in ("pos",):
                arr = arr.reshape(natoms)
            if name == "pos":
                frame[_keys.POSITIONS_KEY] = arr
            elif name == "Z" or name == "numbers":
                frame[_keys.ATOMIC_NUMBERS_KEY] = arr.astype(np.int64)
            else:
                frame[key_map.get(name, name)] = arr

        lattice = info.pop("Lattice", None)
        if lattice is not None:
            frame[_keys.CELL_KEY] = np.asarray(lattice, dtype=np.float64).reshape(3, 3)
        pbc = info.pop("pbc", None)
        if pbc is None:
            pbc = lattice is not None
        frame[_keys.PBC_KEY] = np.broadcast_to(np.asarray(pbc, dtype=bool), (3,)).copy()

        for k, v in info.items():
            name = key_map.get(k, k)
            if name == _keys.TOTAL_ENERGY_KEY:
                v = np.asarray(v, dtype=np.float64).reshape(1, 1)
            elif name in (_keys.STRESS_KEY, _keys.VIRIAL_KEY):
                v = np.asarray(v, dtype=np.float64)
                v = v.reshape(3, 3) if v.size == 9 else v
            frame[name] = v

        if include_keys is not None:
            keep = set(include_keys) | {
                _keys.POSITIONS_KEY,
                _keys.ATOMIC_NUMBERS_KEY,
                _keys.CELL_KEY,
                _keys.PBC_KEY,
                _keys.TOTAL_ENERGY_KEY,
                _keys.FORCE_KEY,
            }
            frame = {k: v for k, v in frame.items() if k in keep}
        frames.append(frame)

    if index == ":" or index is None:
        return frames
    if isinstance(index, int):
        return [frames[index]]
    return frames[index]


def write_extxyz(file_path: str, frames: Sequence[dict], mode: str = "w") -> None:
    """Write canonical host dicts as extxyz (energy/forces when present)."""
    with open(file_path, mode) as f:
        for frame in frames:
            pos = np.asarray(frame[_keys.POSITIONS_KEY], dtype=np.float64)
            n = pos.shape[0]
            numbers = np.asarray(
                frame.get(_keys.ATOMIC_NUMBERS_KEY, np.ones(n, dtype=int))
            ).reshape(-1)
            symbols = [CHEMICAL_SYMBOLS[z] for z in numbers]
            forces = frame.get(_keys.FORCE_KEY)
            props = "species:S:1:pos:R:3" + (":forces:R:3" if forces is not None else "")
            comment = [f"Properties={props}"]
            cell = frame.get(_keys.CELL_KEY)
            if cell is not None:
                cell = np.asarray(cell, dtype=np.float64).reshape(3, 3)
                comment.append(
                    'Lattice="' + " ".join(f"{x:.10f}" for x in cell.reshape(-1)) + '"'
                )
            pbc = frame.get(_keys.PBC_KEY)
            if pbc is not None:
                flags = np.broadcast_to(np.asarray(pbc, dtype=bool), (3,))
                comment.append(
                    'pbc="' + " ".join("T" if b else "F" for b in flags) + '"'
                )
            e = frame.get(_keys.TOTAL_ENERGY_KEY)
            if e is not None:
                comment.append(f"energy={float(np.asarray(e).reshape(-1)[0]):.10f}")
            f.write(f"{n}\n{' '.join(comment)}\n")
            forces = (
                np.asarray(forces, dtype=np.float64) if forces is not None else None
            )
            for a in range(n):
                row = f"{symbols[a]} " + " ".join(f"{x:.10f}" for x in pos[a])
                if forces is not None:
                    row += " " + " ".join(f"{x:.10f}" for x in forces[a])
                f.write(row + "\n")
