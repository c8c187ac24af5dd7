"""Build and load the C++ cell-list neighbour list (``csrc/neighborlist.cpp``).

Counterpart of ``nequip_tpu/data/_cpp_nl.py``.  The source is compiled with
``g++ -O3 -shared -fPIC -std=c++17`` at first use into
``nequip_tpu_torch/_build/``, as a library named by a hash of
the source, so a changed source rebuilds.  No ``-march=native``: the build
directory may travel between machines.  A failed build raises with the
compiler's output; nothing falls back to another backend.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "neighborlist.cpp"
BUILD_DIR = _PKG / "_build"

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile the cell list into ``build_dir`` unless it is there already;
    returns the library's path.  Raises ``RuntimeError`` when the compiler is
    missing or fails."""
    src = SOURCE.read_bytes()
    build_dir = Path(build_dir)
    lib = build_dir / f"libnequip_nl_{hashlib.sha256(src).hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        out = Path(tmp) / lib.name
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(SOURCE), "-o", str(out)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except FileNotFoundError as e:
            raise RuntimeError(f"C++ neighbour list: compiler 'g++' not found ({e})") from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"C++ neighbour list: {' '.join(cmd)} failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(out, lib)  # atomic: concurrent builds each install a whole library
    return lib


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the library, with argtypes set."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.nequip_cell_list_nl
            fn.restype = ctypes.c_int64
            fn.argtypes = [
                ctypes.c_void_p,  # pos [n, 3] float64
                ctypes.c_int64,  # n_atoms
                ctypes.c_void_p,  # cell [3, 3] float64, or NULL for open boundaries
                ctypes.c_void_p,  # pbc [3] int32
                ctypes.c_double,  # cutoff
                ctypes.c_int64,  # max_edges
                ctypes.c_void_p,  # edge_dst [max_edges] int32
                ctypes.c_void_p,  # edge_src [max_edges] int32
                ctypes.c_void_p,  # shifts [max_edges, 3] float64
            ]
            _LIB = lib
        return _LIB


def cpp_cell_list_nl(pos: np.ndarray, r_max: float, cell: Optional[np.ndarray], pbc) -> Tuple[np.ndarray, np.ndarray]:
    """``(edge_index (2, E) int32, edge_cell_shift (E, 3) float64)`` from the
    C++ cell list; the edge buffers start at 64 per atom and grow to what the
    library reports it needs."""
    lib = load_library()
    pos = np.ascontiguousarray(pos, dtype=np.float64)
    n = pos.shape[0]
    pbc_arr = np.ascontiguousarray(np.asarray(pbc, dtype=np.int32).reshape(-1))
    if pbc_arr.size == 1:
        pbc_arr = np.repeat(pbc_arr, 3)
    cell_c = None
    if cell is not None and pbc_arr.any():
        cell_c = np.ascontiguousarray(np.asarray(cell, dtype=np.float64).reshape(9))

    cap = max(64 * n, 1024)
    for _ in range(4):
        dst = np.empty(cap, dtype=np.int32)
        src = np.empty(cap, dtype=np.int32)
        shifts = np.empty((cap, 3), dtype=np.float64)
        ret = lib.nequip_cell_list_nl(
            pos.ctypes.data, n, None if cell_c is None else cell_c.ctypes.data, pbc_arr.ctypes.data,
            float(r_max), cap, dst.ctypes.data, src.ctypes.data, shifts.ctypes.data,
        )
        if ret >= 0:
            return np.stack([dst[:ret], src[:ret]]), shifts[:ret]
        if ret == np.iinfo(np.int64).min:
            raise RuntimeError("C++ neighbour list failed: singular cell")
        cap = int(-ret) + 1024
    raise RuntimeError("C++ neighbour list: edge capacity negotiation failed")
