"""Build and load the hand-written CUDA kernels.

The sources under ``nequip_tpu_torch/csrc/`` are compiled with ``nvcc`` for
``sm_90a``, one ``nvcc`` process per source, all started together, and
linked into one shared library with a plain C interface, at first CUDA use,
into ``nequip_tpu_torch/_build/`` (named by a hash of the sources, so a
changed source rebuilds).  Importing this module needs no ``nvcc``.

Each C entry point launches on the stream it is given, allocates nothing,
and returns the ``cudaError_t`` of the launch; the Python wrappers raise if
it is not 0.  Every kernel is instantiated for float32 and float64
(suffixes ``f32``, ``f64``); the bfloat16 fast mode's kernels (``BF16``: K1,
K2 in both variants, the dW reduction, K3 and the trilinear kernels
K4/K4-acc, K5, K6 and K7; bf16 storage with float32 sums) also for bfloat16
(``bf16``).  The microbenchmarks (T1-T4) and the neighbour list have float32
and float64 forms only.
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
    "nequip_conv_fwd": [_P] * 13 + [_I] * 9 + [_D, _D, _P],
    "nequip_conv_fwd_tile": [_I] * 6,
    "nequip_conv_bwd": [_P] * 19 + [_I] * 8 + [_D, _D, _P],
    "nequip_conv_bwd_train": [_P] * 22 + [_I] * 8 + [_D, _D, _P],
    "nequip_dw_reduce": [_P] * 4 + [_I] * 5 + [_D, _P],
    "nequip_scatter_rows": [_P] * 4 + [_I, _I, _P],
    "nequip_tri_fwd": [_P] * 11 + [_I] * 7 + [_P],
    "nequip_tri_fwd_acc": [_P] * 11 + [_I] * 7 + [_P],
    "nequip_tri_fwd_tile": [_I] * 4,
    "nequip_tri_bwd": [_P] * 16 + [_I] * 6 + [_P],
    "nequip_jvp_fwd": [_P] * 15 + [_I] * 7 + [_P],
    "nequip_jvp_fwd_acc": [_P] * 15 + [_I] * 7 + [_P],
    "nequip_jvp_fwd_tile": [_I] * 4,
    "nequip_jvp_bwd": [_P] * 23 + [_I] * 6 + [_P],
    "nequip_mb_fwd": [_P] * 12 + [_I] * 14 + [_P],
    "nequip_mb_fwd_blocks": [_I] * 3,
    "nequip_mb_bwd": [_P] * 14 + [_I] * 10 + [_P],
    "nequip_mb_bwd_blocks": [_I] * 2,
    "nequip_device_nl": [_P] * 3 + [_I] * 4 + [_D] + [_I] * 2 + [_P] * 11 + [_I] * 2 + [_P] * 5,
}
# the entry points that are instantiated for bfloat16 too; ``entry_point``
# refuses bfloat16 for every other name before the library loads
BF16 = ("nequip_conv_fwd", "nequip_conv_fwd_tile", "nequip_conv_bwd", "nequip_conv_bwd_train", "nequip_dw_reduce",
        "nequip_scatter_rows", "nequip_tri_fwd", "nequip_tri_fwd_acc", "nequip_tri_fwd_tile", "nequip_tri_bwd",
        "nequip_jvp_fwd", "nequip_jvp_fwd_acc", "nequip_jvp_fwd_tile", "nequip_jvp_bwd")
# bfloat16 forms whose C signature is not the float32 and float64 forms': K3's
# bf16 kernel takes its launch geometry from the host (tp_scatter.scatter_rows_geometry)
_BF16_SIGNATURES: Dict[str, List] = {
    "nequip_scatter_rows": [_P] * 4 + [_I] * 5 + [_P],
}
# dtype-free entry points (a copy moves bytes), registered under their own names
_BYTE_SIGNATURES: Dict[str, List] = {
    "nequip_row_gather_bytes": [_P] * 3 + [_I] * 4 + [_P],
}

# which source file holds each kernel (reported by chip_smoke.py)
KERNEL_SOURCES = {
    "conv_fwd": "nequip_tpu_torch/csrc/conv_fwd.cu",
    "conv_bwd": "nequip_tpu_torch/csrc/conv_bwd.cu",
    "conv_bwd_train": "nequip_tpu_torch/csrc/conv_bwd.cu",
    "dw_reduce": "nequip_tpu_torch/csrc/dw_reduce.cu",
    "scatter_rows": "nequip_tpu_torch/csrc/scatter_rows.cu",
    "tri_fwd": "nequip_tpu_torch/csrc/tri_fwd.cu",
    "tri_fwd_acc": "nequip_tpu_torch/csrc/tri_fwd.cu",
    "tri_bwd": "nequip_tpu_torch/csrc/tri_bwd.cu",
    "jvp_fwd": "nequip_tpu_torch/csrc/jvp_fwd.cu",
    "jvp_bwd": "nequip_tpu_torch/csrc/jvp_bwd.cu",
    "mb_fwd": "nequip_tpu_torch/csrc/microbench_fwd.cu",
    "mb_fwd_t": "nequip_tpu_torch/csrc/microbench_fwd.cu",
    "mb_bwd": "nequip_tpu_torch/csrc/microbench_bwd.cu",
    "mb_bwd_t": "nequip_tpu_torch/csrc/microbench_bwd.cu",
    "row_gather": "nequip_tpu_torch/csrc/row_gather.cu",
    "device_nl": "nequip_tpu_torch/csrc/device_nl.cu",
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
    nvcc = _find_nvcc()
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources]
        procs = [
            subprocess.Popen(
                [nvcc, *flags, f"-I{CSRC}", "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(sources, objs)
        ]
        failed = []
        for src, proc in zip(sources, procs):
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode}):\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        lib_tmp = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, "-shared", *map(str, objs), "-o", str(lib_tmp)], capture_output=True, text=True
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}\n{link.stderr}")
        os.replace(lib_tmp, lib_path)
    return lib_path, time.perf_counter() - t0


@lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with argtypes set."""
    lib_path, _ = build()
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        for suffix in ("f32", "f64") + (("bf16",) if name in BF16 else ()):
            fn = getattr(lib, f"{name}_{suffix}")
            fn.argtypes = _BF16_SIGNATURES.get(name, argtypes) if suffix == "bf16" else argtypes
            fn.restype = ctypes.c_int
    for name, argtypes in _BYTE_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def byte_entry_point(name: str) -> ctypes._CFuncPtr:
    """The dtype-free C function ``name`` (see ``_BYTE_SIGNATURES``)."""
    if name not in _BYTE_SIGNATURES:
        raise KeyError(f"{name} is not a dtype-free entry point")
    return getattr(load_library(), name)


def entry_point(name: str, dtype) -> ctypes._CFuncPtr:
    """The C function ``name`` instantiated for a torch float dtype: float32
    and float64 for every kernel, bfloat16 for the names in ``BF16``."""
    import torch

    if dtype == torch.bfloat16 and name not in BF16:
        raise TypeError(
            f"{name}: no bfloat16 kernel; the bfloat16 fast mode's kernels are {', '.join(BF16)}; the "
            "microbenchmarks run in float32 only, as the JAX tools do, and the neighbour list in float32 or "
            "float64"
        )
    suffix = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}.get(dtype)
    if suffix is None:
        raise TypeError(f"{name}: kernels are instantiated for float32, float64 and bfloat16, not {dtype}")
    return getattr(load_library(), f"{name}_{suffix}")


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
