#!/usr/bin/env python3
"""What the bf16 dW reduction's tiles cost, on one NVIDIA GPU.

    python3 chip_dw_profile.py [--edges N] [--one-wave] [VARIANT ...]   (default: every variant)

``dw_reduce``'s bf16 pass 1 (``nequip_tpu_torch/csrc/dw_reduce.cu``,
``mma_partial_kernel``) is built at other tile configurations in one library
under ``nequip_tpu_torch/_build/`` (a source that includes ``dw_reduce.cu``
and instantiates ``launch_mma_partials`` at each; pass 2 is the kernel's own),
and timed at the flagship's dW shapes, dW1 (8, 128) and dW2 (128, 96) and
(128, 352), and at preset M's widest dW2 (128, 768), on N edges (default
the 23k-atom frame's 419,904) of random bf16 rows.  Beside them: the port's
``dw_reduce`` in bf16 and in f32 on the same values, and ``torch.mm`` on the
bf16 operands.  Times are CUDA-event medians of ten calls back to back (the
host's cost per call hides), per call, over three rounds in which the
functions take turns.  Each variant's chunks follow the port's bf16 rule
(``_dw_chunks``: one wave, or whole waves of chunks of at most 4,096 edges;
with ``--one-wave``, one wave whatever the chunks' length), and its largest
difference from the plain version is printed beside phase 2's f32 gate
(rtol 1e-4, atol 1e-5 max|ref|).  ``torch.profiler`` splits the port's
bf16 call into pass 1 and pass 2, and pass 1's rate is the bf16 bytes of a
and b over its time.  With ``--edges 60000`` the operands stay in the 50 MB
L2: the rate at which the SMs take in data, without HBM.  Variants:

  narrow        dW1 as the port runs it: out^T, 8 warps of one m16 x n8 tile,
                64-edge slabs, 8 stages, one block an SM;
  narrow_4w     4 warps of two m16 tiles;
  narrow_2sm    4 stages and two blocks an SM (twice the chunks);
  nt<K>         dW2 tiles of 32 x 8K a warp, 16 warps as 4 x 4, 32-edge
                slabs, 6 stages, one block an SM: columns 32 K a tile (the
                port takes K = 3 at 96 columns, 11 at 352, 8 at 768);
  nt<K>_8w      the same with 8 warps as 4 x 2 (columns 16 K a tile);
  nt<K>_bk64    64-edge slabs.
"""

from __future__ import annotations

import ctypes
import hashlib
import re
import subprocess
import sys
import time

import numpy as np

import chip_smoke as CS

SHAPES = {(8, 128): "dW1", (128, 96): "dW2 layers 0, 2", (128, 352): "dW2 layer 1", (128, 768): "preset M dW2"}
FLAGSHIP_COUNT = {(8, 128): 3, (128, 96): 2, (128, 352): 1}  # calls a set of the flagship's 3 layers makes
DEFAULT = ["narrow", "narrow_4w", "narrow_2sm", "nt3", "nt6_8w", "nt3_bk64", "nt6", "nt8", "nt11", "nt12"]


def spec(name: str):
    """(template arguments of launch_mma_partials, (rows, columns, blocks an
    SM) of the tile for the split, narrow?) of a variant."""
    if name == "narrow":
        return "1, 1, 8, 1, 64, 8, true, true", (8, 128, 1), True
    if name == "narrow_4w":
        return "2, 1, 4, 1, 64, 8, true, true", (8, 128, 1), True
    if name == "narrow_2sm":
        return "1, 1, 8, 1, 64, 4, true, true", (8, 128, 2), True
    m = re.fullmatch(r"nt(\d+)(_8w|_bk64)?", name)
    if not m or not 1 <= int(m.group(1)) <= 24:
        raise SystemExit(f"unknown variant {name!r}: narrow, narrow_4w, narrow_2sm, nt<K>, nt<K>_8w, nt<K>_bk64")
    nt, kind = int(m.group(1)), m.group(2) or ""
    warps_n, bk = (2, 32) if kind == "_8w" else (4, 64 if kind == "_bk64" else 32)
    return f"2, {nt}, 4, {warps_n}, {bk}, 6, false, true", (128, 8 * nt * warps_n, 1), False


def source(names) -> str:
    lines = ['#include "dw_reduce.cu"', "", "namespace nequip {", "namespace {",
             "template <int MT, int NT, int WM, int WN, int BK, int ST, bool TOUT, bool VEC>",
             "int run_variant(const void* a, const void* b, void* partial, void* out, int n, int P, int Q, int chunk,",
             "                int n_chunks, double scale, void* stream) {",
             "  using bf = __nv_bfloat16;",
             "  cudaStream_t s = static_cast<cudaStream_t>(stream);",
             "  const bf* x = static_cast<const bf*>(TOUT ? b : a);",
             "  const bf* y = static_cast<const bf*>(TOUT ? a : b);",
             "  cudaError_t err = launch_mma_partials<MT, NT, WM, WN, BK, ST, TOUT, VEC>(",
             "      x, y, static_cast<float*>(partial), n, TOUT ? Q : P, TOUT ? P : Q, chunk, n_chunks, s);",
             "  if (err != cudaSuccess) return static_cast<int>(err);",
             "  const int pq = P * Q;",
             "  sum_partials_kernel<float><<<(pq + 127) / 128, 128, 0, s>>>(static_cast<const float*>(partial),",
             "      static_cast<float*>(out), n_chunks, pq, static_cast<float>(scale));",
             "  return static_cast<int>(cudaGetLastError());",
             "}", "}  // namespace", "}  // namespace nequip", ""]
    for name in names:
        lines.append(f'extern "C" int dw_{name}(const void* a, const void* b, void* p, void* o, int n, int P, int Q, '
                     f"int c, int s, double sc, void* st) {{ return nequip::run_variant<{spec(name)[0]}>(a, b, p, o, "
                     f"n, P, Q, c, s, sc, st); }}")
    return "\n".join(lines) + "\n"


def build_variants(names):
    from nequip_tpu_torch.ops.kernels import build

    src = source(names)
    digest = hashlib.sha256((src + (build.CSRC / "dw_reduce.cu").read_text()).encode()).hexdigest()[:16]
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, lib = build.BUILD_DIR / f"dw_variants_{digest}.cu", build.BUILD_DIR / f"libdw_variants_{digest}.so"
    cu.write_text(src)
    t0 = time.perf_counter()
    r = subprocess.run([build._find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-Xcompiler", "-fPIC", "-shared", f"-I{build.CSRC}", "-Xptxas=-v", str(cu), "-o", str(lib)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed\n{r.stderr[-3000:]}")
    report = (r.stdout + r.stderr).splitlines()
    print(f"built {len(names)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    for i, line in enumerate(report):
        m = re.search(r"Compiling entry function '[^']*mma_partial_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)"
                      r"ELi(\d+)ELb(\d)ELb(\d)", line)
        if m:
            info = [x.split(":", 1)[-1].strip() for x in report[i + 1:i + 4] if "Used" in x or "spill" in x]
            print(f"ptxas mma_partial_kernel<{', '.join(m.groups())}>: {'; '.join(info)}", flush=True)
    dll = ctypes.CDLL(str(lib))
    fns = {}
    for name in names:
        fn = getattr(dll, f"dw_{name}")
        fn.argtypes, fn.restype = build._SIGNATURES["nequip_dw_reduce"], ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_dw_profile.py needs an NVIDIA GPU")
    from torch.profiler import ProfilerActivity, profile

    from nequip_tpu_torch.ops.kernels import tp_scatter as K

    args = sys.argv[1:]
    n = 419_904
    one_wave = "--one-wave" in args
    args = [x for x in args if x != "--one-wave"]
    if "--edges" in args:
        i = args.index("--edges")
        n = int(args[i + 1])
        del args[i:i + 2]
    names = args or DEFAULT
    print(f"card: {CS.phase0_device()}, {n} edges{', one wave' if one_wave else ''}", flush=True)
    fns = build_variants(names)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    totals = {}
    for (P, Q), label in SHAPES.items():
        a = torch.randn(n, P, generator=gen, device=dev).bfloat16()
        b = torch.randn(n, Q, generator=gen, device=dev).bfloat16()
        a32, b32 = a.float(), b.float()
        want = K.dw_reduce_plain(a, b, 0.5, n)
        limit = 1e-4 * want.abs() + 1e-5 * float(want.abs().max())
        errs = []
        calls = {"port bf16": lambda: K.dw_reduce(a, b, 0.5, n), "port f32": lambda: K.dw_reduce(a32, b32, 0.5, n),
                 "torch.mm bf16": lambda: torch.mm(a.t(), b)}
        for name in names:
            _, (rows, cols, per_sm), narrow = spec(name)
            if narrow != (P <= 8):
                continue
            tiles = K._cdiv(P, rows) * K._cdiv(Q, cols)
            S, chunk = K._dw_chunks(n, tiles, per_sm, K._DW_BF16_SLAB, None if one_wave else K._DW_BF16_MAX_CHUNK)
            partial, out = torch.empty(S, P, Q, device=dev), torch.empty(P, Q, device=dev)

            def call(fn=fns[name], partial=partial, out=out, chunk=chunk, S=S):
                err = fn(a.data_ptr(), b.data_ptr(), partial.data_ptr(), out.data_ptr(), n, P, Q, chunk, S, 0.5,
                         stream())
                if err:
                    raise RuntimeError(f"cudaError {err}")
                return out

            diff = (call() - want).abs()
            errs.append(f"{name} {float(diff.max()):.3e} over {chunk}-edge chunks "
                        f"({'within' if bool((diff <= limit).all()) else 'OVER'} the gate)")
            calls[name] = call
        rounds = [CS._ten_back_to_back(list(calls.values()), 10) for _ in range(3)]
        times = dict(zip(calls, np.median(rounds, axis=0)))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                calls["port bf16"]()
            torch.cuda.synchronize()
        kern = {("pass 1" if "mma_partial" in e.key else "pass 2"): e.device_time_total / e.count / 1e3
                for e in prof.key_averages() if e.count and ("mma_partial" in e.key or "sum_partials" in e.key)}
        nbytes = 2 * n * (P + Q)
        bound = (nbytes + 4 * P * Q) / CS.HBM_BYTES_S * 1e3
        print(f"({P}, {Q}) {label}: bound {bound:.4f} ms; ms per call, ten back to back: "
              + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
              + f"; port bf16 by torch.profiler: pass 1 {kern.get('pass 1', float('nan')):.4f} ms "
              f"({nbytes / kern.get('pass 1', float('nan')) / 1e9:.3f} TB/s of a and b), pass 2 "
              f"{kern.get('pass 2', float('nan')):.4f} ms; max abs err (max|ref| {float(want.abs().max()):.4e}): "
              + ", ".join(errs), flush=True)
        for k in ("port bf16", "port f32", "torch.mm bf16"):
            totals[k] = totals.get(k, 0.0) + FLAGSHIP_COUNT.get((P, Q), 0) * times[k]
        del a, b, a32, b32, want, limit, calls
        torch.cuda.empty_cache()
    print("the flagship's 3 layers, both shapes, ms per set (ten back to back): "
          + ", ".join(f"{k} {v:.4f}" for k, v in totals.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
