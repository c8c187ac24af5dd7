#!/usr/bin/env python3
"""Where the conv-block microbenchmarks spend their time, and what variants
of their design cost, on one NVIDIA GPU: T1 and T3 (the forward,
``csrc/microbench_fwd.cu``) or, with ``--bwd``, T2 and T4 (the CG-VJP,
``csrc/microbench_bwd.cu``).

    python3 chip_mb_profile.py [VARIANT ...]          (default: base clocks split3)
    python3 chip_mb_profile.py --bwd [VARIANT ...]    (default: base clocks tc4 g_l1)

Each variant is built once, from a patched copy of the source in its own
library under ``nequip_tpu_torch/_build/``, and timed (CUDA events, median
of 3 x 10 calls, the variants in turns) at the tool's defaults (f32, 128
rows, 256 edges a chunk, G = 2048) on the variants of T1 and T3 it
applies to; each result is held against the plain version (1e-4 of
max|ref|: TF32 routes against the TF32-rounded plain, the others against
plain f32).  Variants:

  base    the kernels as they are;
  clocks  clock64 marks: cycles per tile of thread 0 in each phase of
          PHASES (the CG product and slice adds, the row sort, issuing the
          copies, the waits, the MLP's products, c * y), summed over the
          blocks;
  split3  the DEFAULT route with each TF32 product split in three
          (hi.hi + hi.lo + lo.hi, operands stored unrounded), timed on the
          MLP variants and held against plain f32: the f32-accurate
          tensor-core form of K1's W2 product;
  ring5   HIGHEST with five stages in K1's W2 ring instead of three (the
          MLP variants).

With ``--bwd`` T2 (``cgvjp``) and T4 (``cgvjp_t``) are timed at G and at
G / 2 (each variant held at phase 8a's gates: 1e-4 of max|ref| against the
plain f32 step, the G / (G / 2) time ratio in [1.7, 2.3]).  Variants:

  base    the kernel as it is;
  clocks  clock64 marks: cycles of thread 0 in each phase of BWD_PHASES,
          per block (staging, the result copy) or per tile-step (the
          CG-VJP's phases), summed over the blocks;
  tc4     CG-VJP items of 4 edges instead of 8 (18 items a step);
  g_l1    g rows read through L1 from device memory instead of staged in
          shared memory, as K2 reads its g rows, which leaves room and
          registers for four blocks an SM instead of three (T2 only: T4's
          g is feature-major).
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

import chip_smoke as CS
from nequip_tpu_torch.ops.kernels import build
from nequip_tpu_torch.ops.kernels import microbench as MB
from nequip_tpu_torch.tools.kernel_microbench import make_inputs, to_tensors

SOURCE = build.CSRC / "microbench_fwd.cu"
BWD_SOURCE = build.CSRC / "microbench_bwd.cu"
CASES = [("dot", "HIGHEST"), ("mlp", "HIGHEST"), ("mlp", "DEFAULT"), ("cg", "HIGHEST"), ("full", "HIGHEST"),
         ("full", "DEFAULT"), ("xpose", "DEFAULT"), ("cg_t", "DEFAULT"), ("full_t", "DEFAULT"),
         ("full_t_pre", "DEFAULT")]

MARKS = """
__device__ unsigned long long mb_clk[16];
extern "C" int mb_read_clk(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, mb_clk, sizeof(mb_clk)));
}
extern "C" int mb_zero_clk() {
  const unsigned long long z[16] = {};
  return static_cast<int>(cudaMemcpyToSymbol(mb_clk, z, sizeof(z)));
}
#define MB_MARK(i) if (tid == 0) { const long long t_ = clock64(); mb_acc[i] += t_ - mb_t; mb_t = t_; }
"""
# what each mark closes, in the order thread 0 passes them in a tile
PHASES = ("CG product and slice adds (previous tile) + barrier", "issue emb, x0 copies", "issue x, y copies",
          "sort the next tile (warp 0)", "wait for emb (+ TF32 rounding)", "TF32 first product + barrier",
          "second product (HIGHEST: hidden layer + tile_gemm)", "wait for x, y", "c * y")


def _once(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"patch anchor not found once: {old[:60]!r}")
    return src.replace(old, new)


def clocks(src: str) -> str:
    marks = [
        ("namespace nequip {\nnamespace mb {\n", MARKS, ""),
        ("  const int tid = threadIdx.x;\n  const int32_t* itab = a.itab;\n", "",
         "  long long mb_t = clock64(), mb_acc[16] = {};\n"),
        ("      const int32_t* perm = has_scatter(V) ? rows : nullptr;\n", "", "      MB_MARK(0)\n"),
        ("      // this tile's x (the group's chunks)", "      MB_MARK(1)\n", ""),
        ("      if (has_scatter(V) && tid < 32) {  // warp 0: the next tile's row order", "      MB_MARK(2)\n", ""),
        ("(base + 2 * TILE) % be + lane) : 0;\n      }\n", "", "      MB_MARK(3)\n"),
        ("            for (int j = 0; j < w; ++j) s_emb[e * lde + c + j] = tf32_stage(s_emb[e * lde + c + j]);\n"
         "          }\n        }\n        __syncthreads();\n", "", "        MB_MARK(4)\n"),
        ("            mma_smem(s_w1, ldw1, s_emb, lde, hidden, TILE, n_emb,\n"
         "                     [&](int m, int n, float v) { s_h[n * ldh + m] = tf32_stage(silu(v)); });\n"
         "          __syncthreads();\n", "", "          MB_MARK(5)\n"),
        ("      cp_async_wait<0>();\n      __syncthreads();  // every copy has landed, and w is complete\n",
         "      MB_MARK(6)\n", "      MB_MARK(7)\n"),
        ("          cgf::scale_y<T, TILE, kNT>(tab, s_y, sh_dim, s_cy, tid);\n        __syncthreads();\n", "",
         "        MB_MARK(8)\n"),
        ("  // the block's sums into partial[range]", "  __syncthreads();\n  MB_MARK(0)\n  if (tid == 0) {\n"
         "    for (int i = 0; i < 9; ++i) atomicAdd(&mb_clk[i], static_cast<unsigned long long>(mb_acc[i]));\n"
         "    atomicAdd(&mb_clk[15], static_cast<unsigned long long>(tt));\n  }\n", ""),
    ]
    for anchor, before, after in marks:
        src = _once(src, anchor, before + anchor + after)
    return src


SPLIT3 = """
__device__ __forceinline__ float tf32_stage(float v) { return v; }

__device__ __forceinline__ uint32_t tf32_bits(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void mma_one(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b with f32 operands as three TF32 products (the small ones first)
__device__ __forceinline__ void mma_frag(float (&c)[4], const float (&a)[4], const float (&b)[2]) {
  uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ah[i] = tf32_bits(a[i]);
    al[i] = tf32_bits(a[i] - __uint_as_float(ah[i]));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    bh[i] = tf32_bits(b[i]);
    bl[i] = tf32_bits(b[i] - __uint_as_float(bh[i]));
  }
  mma_one(c, al, bh);
  mma_one(c, ah, bl);
  mma_one(c, ah, bh);
}
"""


def split3(src: str) -> str:
    start = src.index("// A TF32 operand as it is stored in shared memory")
    end = src.index("// C [M][N] = A [M][K] . B^T")
    return src[:start] + SPLIT3 + "\n" + src[end:]


def ring5(src: str) -> str:
    return _once(src, "constexpr int kBK = 16, kStages = 3;", "constexpr int kBK = 16, kStages = 5;")


PATCHES = {"base": lambda src: src, "clocks": clocks, "split3": split3, "ring5": ring5}
RING_BYTES = {"ring5": 5 * 16 * 512}  # the host's layout of a patched ring (microbench._RING)


# what each mark of the T2/T4 kernel closes, in the order thread 0 passes them
BWD_PHASES = ("staging (a block)", "dx_items + barrier", "dw_items + barrier", "path_sum",
              "restore w, zero partials + barrier", "result copy (a writing block)")


def bwd_clocks(src: str) -> str:
    marks = [
        ("namespace nequip {\nnamespace mb {\n", MARKS, ""),
        ("  const int tid = threadIdx.x;\n", "", "  long long mb_t = clock64(), mb_acc[8] = {};\n"),
        ("  cp_async_wait<0>();\n  __syncthreads();\n", "", "  MB_MARK(0)\n"),
        ("    __syncthreads();  // dx has read w\n", "", "    MB_MARK(1)\n"),
        ("part, nullptr, wn);\n    __syncthreads();\n", "", "    MB_MARK(2)\n"),
        ("    cg::path_sum<T, NT>(a.tab, part, cnt, sh_dim, s_dy);\n", "", "    MB_MARK(3)\n"),
        ("    store_tile<T, kT, TILE, NT>(a.dw, s_w, base, cnt, wn, be, tid);\n  }\n", "",
         "  __syncthreads();\n  MB_MARK(5)\n  if (tid == 0) {\n"
         "    for (int i = 0; i < 6; ++i) atomicAdd(&mb_clk[i], static_cast<unsigned long long>(mb_acc[i]));\n"
         "    atomicAdd(&mb_clk[13], range == a.n_ranges - 1 ? 1ull : 0ull);\n"
         "    atomicAdd(&mb_clk[14], static_cast<unsigned long long>(step1 - step0));\n"
         "    atomicAdd(&mb_clk[15], 1ull);\n  }\n"),
    ]
    for anchor, before, after in marks:
        src = _once(src, anchor, before + anchor + after)
    return _once(src, "    __syncthreads();\n  }\n  if (range == a.n_ranges - 1) {",
                 "    __syncthreads();\n    MB_MARK(4)\n  }\n  if (range == a.n_ranges - 1) {")


def tc4(src: str) -> str:
    return _once(src, "constexpr int kBwdEdges = 8;", "constexpr int kBwdEdges = 4;")


def g_l1(src: str) -> str:
    src = _once(src, "sizeof(T) == 4 ? 3 : 1;", "sizeof(T) == 4 ? 4 : 1;")
    src = _once(src, "L.o_w0 = L.o_g + up(tile * mid_dim + V - 1);", "L.o_w0 = L.o_g;")
    src = _once(src, "const int ph_g = stage_tile<T, kT, TILE, NT>(sm + L.o_g, a.g, base, cnt, mid_dim, be, tid);",
                "const int ph_g = 0;")
    return _once(src, "const cg::GRows<T, true> gr{sm + L.o_g + ph_g, 0, mid_dim};",
                 "const cg::GRows<T, false> gr{a.g + static_cast<int64_t>(base) * mid_dim, 0, mid_dim};")


BWD_PATCHES = {"base": lambda src: src, "clocks": bwd_clocks, "tc4": tc4, "g_l1": g_l1}


def g_l1_smem(plan, itemsize: int, bwd_smem) -> int:
    """The g_l1 kernel's shared memory: bwd_smem without the g rows."""
    V = 16 // itemsize
    return bwd_smem(plan, itemsize) - itemsize * MB._ru(MB.BWD_TILE * plan.mid_dim + V - 1, V)


def build_variant(name: str, root: str, bwd: bool = False) -> str:
    os.makedirs(root, exist_ok=True)
    cu = os.path.join(root, f"mb_{name}.cu")
    source, patches = (BWD_SOURCE, BWD_PATCHES) if bwd else (SOURCE, PATCHES)
    with open(cu, "w") as f:
        f.write(patches[name](source.read_text()))
    lib = os.path.join(root, f"libmb_{name}.so")
    cmd = [build._find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler",
           "-fPIC", f"-I{build.CSRC}", "-Xptxas=-v", "-shared", cu, "-o", lib]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {name} failed:\n{proc.stdout}\n{proc.stderr}")
    if bwd:  # registers and spills of each instantiation
        for ln in proc.stderr.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"ptxas {name}: {ln.strip()}", flush=True)
    return lib


def load(path: str, bwd: bool = False) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for sfx in ("f32", "f64"):
        for name in ("nequip_mb_bwd", "nequip_mb_bwd_blocks") if bwd else ("nequip_mb_fwd", "nequip_mb_fwd_blocks"):
            fn = getattr(lib, f"{name}_{sfx}")
            fn.argtypes, fn.restype = build._SIGNATURES[name], ctypes.c_int
    return lib


def build_all(names, bwd: bool = False) -> dict:
    root = os.path.join(build.BUILD_DIR, "mb_profile")
    os.makedirs(root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root) as tmp, ThreadPoolExecutor(len(names)) as ex:
        paths = list(ex.map(lambda n: build_variant(n, os.path.join(tmp, n), bwd), names))
        return {n: load(p, bwd) for n, p in zip(names, paths)}


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


@contextlib.contextmanager
def host_tile(name: str):
    """The host's T2/T4 shared memory set to a patched kernel's."""
    saved = MB.bwd_smem
    if name == "g_l1":
        MB.bwd_smem = lambda plan, itemsize: g_l1_smem(plan, itemsize, saved)
    try:
        yield
    finally:
        MB.bwd_smem = saved


def main_bwd(names) -> int:
    CS.phase0_device()
    be, G = 256, 2048
    plan, arrays = make_inputs(128, be)
    ops = to_tensors(arrays, "cuda")
    libs = build_all(names, bwd=True)
    card = smi()
    for variant, layout in (("cgvjp", "r"), ("cgvjp_t", "t")):
        runs = {n: lib for n, lib in libs.items() if not (n == "g_l1" and layout == "t")}
        ref = MB.chunk_bwd_plain(plan, ops, layout)
        fns = {}
        for name, lib in runs.items():
            with host_tile(name):
                shape = MB.bwd_launch_shape(plan, ops, G, layout, lib)
                got = MB.launch_bwd(plan, ops, G, layout, lib)  # caches the shape at this tile
                MB.launch_bwd(plan, ops, G // 2, layout, lib)
            errs = [float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(got, ref)]
            ok = all(bool(a.isfinite().all()) for a in got) and max(errs) <= 1e-4
            print(f"{variant} {name}: {shape['tile']}-edge tiles, {shape['n_ranges']} step ranges, "
                  f"{shape['n_blocks']} blocks, {shape['smem']} bytes a block, {shape['per_sm']} blocks an SM; "
                  f"max |diff| / max|ref| (dx, dy, dw) {', '.join(f'{e:.2e}' for e in errs)} "
                  f"{'ok' if ok else 'FAILS the 1e-4 gate'}", flush=True)
            if not ok:
                return 1
            for g in (G, G // 2):
                fns[(name, g)] = lambda lib=lib, g=g, name=name: _launch(name, plan, ops, g, layout, lib)
        times = dict(zip(fns, CS.interleaved_median_ms(list(fns.values()), reps=10)))
        for name in runs:
            ms, half = times[(name, G)], times[(name, G // 2)]
            ratio = ms / half
            print(f"{variant} {name} ({card}): {ms:.3f} ms ({ms / G * 1e3:.3f} us/chunk), at G/2 {half:.3f} ms, "
                  f"ratio {ratio:.3f}{'' if 1.7 <= ratio <= 2.3 else ' OUTSIDE [1.7, 2.3]'}", flush=True)
            if not 1.7 <= ratio <= 2.3:
                return 1
        if "clocks" in libs:
            lib = libs["clocks"]
            clk = (ctypes.c_ulonglong * 16)()
            lib.mb_zero_clk()
            MB.launch_bwd(plan, ops, G, layout, lib)
            torch.cuda.synchronize()
            lib.mb_read_clk(clk)
            per = [max(1, clk[15])] + [max(1, clk[14])] * 4 + [max(1, clk[13])]  # blocks, tile-steps, writers
            print(f"{variant} clocks, cycles of thread 0 ({clk[15]} blocks, {clk[14]} tile-steps): " + "; ".join(
                f"{p} {clk[i] / n:.0f}" for i, (p, n) in enumerate(zip(BWD_PHASES, per))), flush=True)
    return 0


def _launch(name: str, plan, ops: dict, G: int, layout: str, lib):
    with host_tile(name):
        return MB.launch_bwd(plan, ops, G, layout, lib)


def main(argv) -> int:
    if argv[:1] == ["--bwd"]:
        return main_bwd(argv[1:] or ["base", "clocks", "tc4", "g_l1"])
    names = argv or ["base", "clocks", "split3"]
    CS.phase0_device()
    rows, be, G = 128, 256, 2048
    plan, arrays = make_inputs(rows, be)
    ops = to_tensors(arrays, "cuda")
    libs = build_all(names)
    card = smi()
    for variant, prec in CASES:
        runs = {}
        for name, lib in libs.items():
            if name in ("split3", "ring5") and variant not in MB.MLP_VARIANTS or name == "ring5" and prec != "HIGHEST":
                continue
            tf32 = (prec == "DEFAULT" and variant in MB.MLP_VARIANTS) or name == "split3"
            runs[name] = (lambda lib=lib, tf32=tf32: MB.launch_fwd(plan, variant, ops, rows, G, tf32, lib), tf32)
        for name, (fn, tf32) in runs.items():
            ring, MB._RING = MB._RING, RING_BYTES.get(name, MB._RING)
            try:
                got = fn()  # the first call lays out (and caches) the launch
            finally:
                MB._RING = ring
            ref = MB.chunk_fwd_plain(plan, variant, ops, rows, G, tf32=tf32 and name != "split3")
            scale, err = float(ref.abs().max()), float((got - ref).abs().max())
            ok = bool(got.isfinite().all()) and err <= 1e-4 * scale
            print(f"{variant} {prec} {name}: max_abs_err {err:.3e} ({err / scale:.2e} of max|ref|) "
                  f"{'ok' if ok else 'FAILS the 1e-4 gate'}", flush=True)
            if not ok:
                return 1
        times = CS.interleaved_median_ms([fn for fn, _ in runs.values()], reps=10)
        for name, ms in zip(runs, times):
            print(f"{variant} {prec} {name} ({card}): {ms:.3f} ms ({ms / G * 1e3:.3f} us/chunk)", flush=True)
        if "clocks" in libs:
            lib = libs["clocks"]
            clk = (ctypes.c_ulonglong * 16)()
            lib.mb_zero_clk()
            runs["clocks"][0]()
            torch.cuda.synchronize()
            lib.mb_read_clk(clk)
            tiles = max(1, clk[15])
            print(f"{variant} {prec} clocks, cycles a tile of thread 0 ({tiles} tiles): " + "; ".join(
                f"{p} {clk[i] / tiles:.0f}" for i, p in enumerate(PHASES)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
