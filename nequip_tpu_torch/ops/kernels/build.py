"""Build and load the hand-written CUDA kernels.

The sources under ``nequip_tpu_torch/csrc/`` are compiled with ``nvcc`` for
``sm_90a``, one ``nvcc`` process per source, all started together, and
linked into one shared library with a plain C interface, at first CUDA use,
into ``nequip_tpu_torch/_build/`` (named by a hash of the sources, so a
changed source rebuilds).  Importing this module needs no ``nvcc``.

In the same step, beside them, the host compiler builds ``csrc/torch_ops.cpp``
(the registered ops ``nequip_torch::{conv_fwd, conv_bwd, scatter_rows,
tri_fwd, tri_bwd}`` in C++, against ``torch/library.h``, with the header
path and ``_GLIBCXX_USE_CXX11_ABI`` value of the installed ``torch``), and
links it with the objects of the five kernels it launches into the ops
library ``libnequip_ops_<hash>.so``, against ``torch``'s libraries (its
hash also covers the binding, the torch version and the ABI value): a
compiled artifact carries it so that a process that does not import the
package can run the artifact's programs (``model/inference_models.py``).
The package itself never loads it: its ops are registered in Python, and a
binding that fails to build leaves the kernel library usable.

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
from typing import Dict, List, NamedTuple, Optional, Tuple

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


# the registered ops' C++ binding (with the header it includes), and the
# kernels it launches (K1, K2, K3, K4, K5)
OPS_BINDING = CSRC / "torch_ops.cpp"
OPS_HEADERS = (CSRC / "scatter_geometry.h",)
OPS_KERNELS = ("conv_fwd", "conv_bwd", "scatter_rows", "tri_fwd", "tri_bwd")
OPS_ARCH = "sm_90a"


class Built(NamedTuple):
    """What ``build`` made: the kernel library (plain C, for ``ctypes``), the
    ops library (None if its binding failed to compile or link, with the
    report in ``ops_error``: the kernel library does not depend on it), the
    wall seconds of the whole build (0 when both existed), and of the ops
    library's own steps: the binding's compile (run beside the ``nvcc``
    processes) and its link."""

    kernels: Path
    ops: Optional[Path]
    seconds: float
    binding_seconds: float
    ops_link_seconds: float
    ops_error: str = ""


def _digest(files: List[Path], extra: str = "") -> str:
    h = hashlib.sha256(extra.encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _sources() -> Tuple[List[Path], str, str]:
    """The kernel sources, the kernel library's digest (the .cu and .cuh
    files) and the ops library's: those files, the binding, and the torch
    version and C++ ABI it compiles and links against, so that another
    torch builds another library."""
    import torch

    files = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    torch_abi = f"torch {torch.__version__} _GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}"
    return ([f for f in files if f.suffix == ".cu"], _digest(files),
            _digest(files + [OPS_BINDING, *OPS_HEADERS], torch_abi))


def _torch_build_flags() -> Tuple[List[str], List[str]]:
    """(compile, link) flags of a host object that uses torch's C++ API: its
    headers, the C++ standard and ABI it was built with, its libraries."""
    import torch

    root = Path(torch.__file__).resolve().parent
    lib = root / "lib"
    compile_flags = ["-std=c++20", "-O2", "-fPIC", f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
                     f"-I{root / 'include'}"]
    link_flags = [f"-L{lib}", "-lc10", "-lc10_cuda", "-ltorch_cpu", "-ltorch", "-Xlinker", f"-rpath={lib}"]
    return compile_flags, link_flags


def _finish(name: str, proc: subprocess.Popen) -> str:
    """Wait for a compile; its error report, or "" if it succeeded."""
    out, _ = proc.communicate()
    return f"{name} ({proc.returncode}):\n{out}" if proc.returncode != 0 else ""


def _link(cmd: List[str]) -> str:
    """Run a link; its error report, or "" if it succeeded."""
    link = subprocess.run(cmd, capture_output=True, text=True)
    return f"link failed ({link.returncode}): {' '.join(cmd)}\n{link.stdout}\n{link.stderr}" if link.returncode else ""


def build() -> Built:
    """Compile the kernels and the ops library if needed.  A kernel that
    fails to compile raises; a binding that fails leaves the kernel library
    built and the ops library None (``ops_library`` raises with the report)."""
    sources, digest, ops_digest = _sources()
    lib_path = BUILD_DIR / f"libnequip_kernels_{digest}.so"
    ops_path = BUILD_DIR / f"libnequip_ops_{ops_digest}.so"
    need_kernels, need_ops = not lib_path.exists(), not ops_path.exists()
    if not (need_kernels or need_ops):
        return Built(lib_path, ops_path, 0.0, 0.0, 0.0)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _find_nvcc()
    flags = ["-gencode", f"arch=compute_90a,code={OPS_ARCH}", "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    cxx = os.environ.get("CXX", "c++")
    if not need_kernels:  # the ops library alone needs the objects of the kernels it launches
        sources = [src for src in sources if src.stem in OPS_KERNELS]
    binding_s = link_s = 0.0
    ops_error = ""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = {src.stem: Path(tmp) / f"{src.stem}.o" for src in sources}
        binding_obj = Path(tmp) / "torch_ops.o"
        binding = None
        if need_ops:
            torch_compile, torch_link = _torch_build_flags()
            binding = subprocess.Popen(
                [cxx, *torch_compile, f"-I{Path(nvcc).resolve().parents[1] / 'include'}", "-c", str(OPS_BINDING),
                 "-o", str(binding_obj)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
        procs = [
            (src.name, subprocess.Popen(
                [nvcc, *flags, f"-I{CSRC}", "-c", str(src), "-o", str(objs[src.stem])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
            for src in sources
        ]
        if binding is not None:
            ops_error = _finish(OPS_BINDING.name, binding)
            binding_s = time.perf_counter() - t0
        failed = [_finish(name, proc) for name, proc in procs]  # every process ends before a failure raises
        if any(failed):
            raise RuntimeError("nvcc failed:\n" + "\n".join(f for f in failed if f))
        if need_kernels:
            lib_tmp = Path(tmp) / lib_path.name
            failed = _link([nvcc, "-shared", *map(str, objs.values()), "-o", str(lib_tmp)])
            if failed:
                raise RuntimeError(failed)
            os.replace(lib_tmp, lib_path)
        if need_ops and not ops_error:
            ops_tmp = Path(tmp) / ops_path.name
            t1 = time.perf_counter()
            ops_error = _link([nvcc, "-shared", str(binding_obj), *(str(objs[k]) for k in OPS_KERNELS), "-o",
                               str(ops_tmp), *torch_link])
            link_s = time.perf_counter() - t1
            if not ops_error:
                os.replace(ops_tmp, ops_path)
    return Built(lib_path, None if ops_error else ops_path, time.perf_counter() - t0, binding_s, link_s,
                 ops_error and f"the ops library did not build ({OPS_BINDING.name}):\n{ops_error}")


def ops_library() -> Path:
    """Build (if needed) the ops library; its path, or RuntimeError with the
    compile or link report."""
    built = build()
    if built.ops is None:
        raise RuntimeError(built.ops_error)
    return built.ops


@lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with argtypes set."""
    lib = ctypes.CDLL(str(build().kernels))
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
