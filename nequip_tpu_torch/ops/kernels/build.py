"""Build and load the hand-written CUDA kernels.

The sources under ``nequip_tpu_torch/csrc/`` are compiled with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, at first CUDA
use, into ``nequip_tpu_torch/_build/`` (named by a hash of the sources, so a
changed source rebuilds).  Importing this module needs no ``nvcc``.

Each C entry point launches on the stream it is given, allocates nothing,
and returns the ``cudaError_t`` of the launch; the Python wrappers raise if
it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Tuple

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# argument kinds of every exported entry point, in order
_SIGNATURES: Dict[str, List] = {
    "nequip_conv_fwd": [_P] * 12 + [_I] * 7 + [_D, _D, _P],
    "nequip_conv_bwd": [_P] * 19 + [_I] * 8 + [_D, _D, _P],
    "nequip_scatter_rows": [_P] * 4 + [_I, _I, _P],
}

# which source file holds each kernel (reported by chip_smoke.py)
KERNEL_SOURCES = {
    "conv_fwd": "nequip_tpu_torch/csrc/conv_fwd.cu",
    "conv_bwd": "nequip_tpu_torch/csrc/conv_bwd.cu",
    "scatter_rows": "nequip_tpu_torch/csrc/scatter_rows.cu",
}


def _find_nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources() -> Tuple[List[Path], str]:
    files = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256()
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return [f for f in files if f.suffix == ".cu"], h.hexdigest()[:16]


def build() -> Tuple[Path, float]:
    """Compile the kernels if needed; returns (library path, build seconds)."""
    sources, digest = _sources()
    lib_path = BUILD_DIR / f"libnequip_kernels_{digest}.so"
    if lib_path.exists():
        return lib_path, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [
        _find_nvcc(),
        "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        f"-I{CSRC}",
    ]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            cmd + ["-o", tmp] + [str(s) for s in sources],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib_path, time.perf_counter() - t0


@lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with argtypes set."""
    lib_path, _ = build()
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{name}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def entry_point(name: str, dtype) -> ctypes._CFuncPtr:
    """The C function ``name`` instantiated for a torch float dtype."""
    import torch

    suffix = {torch.float32: "f32", torch.float64: "f64"}.get(dtype)
    if suffix is None:
        raise TypeError(f"{name}: kernels are instantiated for float32 and float64, not {dtype}")
    return getattr(load_library(), f"{name}_{suffix}")


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
