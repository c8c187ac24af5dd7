#!/usr/bin/env python3
"""Where the conv kernels on dense edge tiles spend their time, and what
their variants cost, on one NVIDIA GPU.

    python3 chip_cg_profile.py [--fwd | --k1 | --k2] [--dtype bf16] [--parent DIR] [VARIANT ...]  (default: base clocks)

The kernels (K5 ``csrc/tri_bwd.cu`` and K7 ``csrc/jvp_bwd.cu``; with
``--fwd`` K4 and K4-acc ``csrc/tri_fwd.cu`` and K6 ``csrc/jvp_fwd.cu``) are
built once per variant, each from a patched copy of its source in its own
library under ``nequip_tpu_torch/_build/``, and timed (CUDA events, median
of 3 x 10 calls, the variants in turns) at the shapes phase 2 of
``chip_smoke.py`` gives them: K5 and K4 on the whole 23k-atom stream, K7,
K4-acc and K6 on the second of 4 edge slices, at each of the flagship's 3
conv layers.  Each result is checked against the plain version: f32 at
rtol 1e-4 with atol 1e-5 max|ref|; with ``--dtype bf16`` the bf16 entry
points on bf16 operands, each output within phase 16a's gate of the bf16
twin (8e-3 of max|ref|).  ``--parent DIR`` builds every variant a second
time from DIR's ``nequip_tpu_torch/csrc`` (another commit unpacked by
``git archive``, whose kernels take the same C arguments), keyed
``<variant>@parent``, and times both in turns in the same process; each
output of K5 and K7 is then also compared with the same variant's from the
parent build (``same_as_parent``; the run fails if one differs).  A
variant name may join variants with ``+`` (``tile32x1x4+part8``).
Variants of K5 and K7:

  base          the kernels as they are;
  clocks        clock64 marks: cycles per tile of thread 0 in each phase
                (staging and destinations, dx, dW and dy partials, dy sum,
                per-edge stores), summed over the blocks;
  shuffle_sums  each m2 run's dy partial summed edge by edge (5 shuffles an
                edge) instead of by a reduce-scatter;
  edges<N>      N edges an item (8 in K5, 4 in K7);
  g_rows0       no g rows staged in shared memory (K5; K7 stages none);
  tile<T>x<S>x<B>[t<N>]  the launch shape forced: T edges, S stages, B
                blocks an SM, N threads a block (256 unless given);
  prefetch      the next tile's weight rows prefetched into L2;
  unroll4       the term loops unrolled by 4 instead of 2.

With ``--k2`` the kernel is K2's training variant (``csrc/conv_bwd.cu``,
``nequip_conv_bwd_train``) on the whole 23k-atom stream, its dx, dsh and
demb checked against ``conv_bwd_plain`` (f32 or bf16 as above); variants:

  base          the kernel as it is;
  clocks        clock64 marks: cycles per tile of thread 0 in each phase
                (staging and destinations, hidden layer, w product, dx,
                dW and dsh partials, dsh sum, dh product, demb);
  mma<BK>x<S>   bf16: tile_mma's ring of S slabs of BK rows.

With ``--k1`` the kernel is K1 (``csrc/conv_fwd.cu``, ``nequip_conv_fwd``)
on the whole 23k-atom stream at the flagship's 3 conv layers and at preset
M's layer 1, its output checked against ``conv_fwd_plain`` (f32 or bf16 as
above) and bitwise against a repeat call; with ``--parent`` the share of
outputs that differ from the parent build's is printed (K1's bf16 w
product may round otherwise; the run does not fail on it).  Variants:

  base          the kernel as it is;
  clocks        clock64 marks: cycles per tile of thread 0 in each phase
                (destinations and staging, hidden layer, w product, x
                staging with c * y, CG walk; a mark just before a phase that
                starts at a barrier counts that wait in the phase), and the
                finish (the second launch) in ms by CUDA events;
  mma<BK>x<S>   bf16: tile_mma's ring of S slabs of BK rows;
  tile<T>x<B>   the launch shape forced: T-edge tiles at B blocks an SM (and
                the register cap of B blocks);
  part<P>       bf16: the walk forms P edges' products at a time (kWalkPart).

With ``--fwd`` the kernels are K4, K4-acc (``csrc/tri_fwd.cu``), K6 and
K6-acc (``csrc/jvp_fwd.cu``), each entry point on the whole 23k-atom stream
and on the second of 4 edge slices (phase 2 times K4 on the first, the
others on the second), at the flagship's 3 conv layers and at preset M's
layer 1 (its widest: dim_in 480, WN 768, mid_dim 2368) on the same graph.
With ``--parent`` each output of a variant is also compared with the same
variant's from the parent build: ``same_as_parent`` in its record, and the
run fails if any differs.  Variants:

  base          the kernels as they are (destinations split across tiles
                as K1 sums them: carry rows and a second launch);
  clocks        clock64 marks: cycles per tile of thread 0 in each phase
                (the barrier that waits for the other warps' sums; staging,
                destinations and y; c * y with x and w; the CG product and
                sums, split into the product and the walk: the column's
                sums, the stores and the column's table lookups);
  tile<T>x1x<B>[t<N>]  the launch shape forced: T edges, B blocks an SM
                (and the register cap of B blocks), N threads a block;
  part<P>       bf16: the walk forms P edges' products at a time (kWalkPart);
  unroll_parts  bf16: the walk's loop over the parts unrolled.
Every build prints its kernels' registers and spills (ptxas -v).
"""

from __future__ import annotations

import ctypes
import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import chip_ptxas
import chip_smoke as CS
from nequip_tpu_torch.ops.kernels import build
from nequip_tpu_torch.ops.kernels import tp_scatter as K

KERNELS = ("tri_bwd", "jvp_bwd")
FWD_KERNELS = ("tri_fwd", "jvp_fwd")  # K4-acc is timed from tri_fwd's library

MARKS = """
__device__ unsigned long long cg_clk[16];
extern "C" int cg_read_clk(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, cg_clk, sizeof(cg_clk)));
}
extern "C" int cg_zero_clk() {
  const unsigned long long z[16] = {};
  return static_cast<int>(cudaMemcpyToSymbol(cg_clk, z, sizeof(z)));
}
#define CG_MARK(i) if (tid == 0) { const long long t_ = clock64(); cg_acc[i] += t_ - cg_t; cg_t = t_; }
"""
PHASES = ("staging", "dx", "dW and dy partials", "dy sum", "stores")
K1_PHASES = ("destinations and staging", "hidden layer", "w product", "x staging with c * y", "CG walk")
FINISH_TIMER = """
static float cg_finish_ms_ = 0.f;
extern "C" float cg_read_finish_ms() { return cg_finish_ms_; }
extern "C" void cg_zero_finish_ms() { cg_finish_ms_ = 0.f; }
"""


def _once(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"source anchor not found once: {old!r}")
    return src.replace(old, new)


def clocks(src: str) -> str:
    src = _once(src, '#include "dense_tiles.cuh"\n', '#include "dense_tiles.cuh"\n' + MARKS)
    src = _once(src, "  if (STAGES == 2) stage(blockIdx.x, 0);\n",
                "  if (STAGES == 2) stage(blockIdx.x, 0);\n"
                "  long long cg_acc[5] = {0, 0, 0, 0, 0}, cg_t = clock64();\n  int cg_n = 0;\n")
    src = _once(src, "    if (STAGES == 1) cp_async_wait<0>();\n    __syncthreads();\n",
                "    if (STAGES == 1) cp_async_wait<0>();\n    __syncthreads();\n    CG_MARK(0);\n    ++cg_n;\n")
    src = re.sub(r"(\n\s+__syncthreads\(\);  // dx[^\n]*\n)", r"\1      CG_MARK(1);\n", src, count=1)
    src = _once(src, "    __syncthreads();\n    cg::path_sum",
                "    __syncthreads();\n    CG_MARK(2);\n    cg::path_sum")
    lines = src.split("\n")
    lines.insert(max(j for j, ln in enumerate(lines) if re.search(r"store_flat<\w, NT>\(", ln)) + 1, "    CG_MARK(4);")
    lines.insert(max(j for j, ln in enumerate(lines) if "cg::path_sum<T, NT>(" in ln) + 1, "    CG_MARK(3);")
    src = "\n".join(lines)
    launcher = re.search(r"template <typename \w+, int TILE, int STAGES, int MIN_BLOCKS[^>]*>\ncudaError_t launch_tile",
                         src).start()
    end = src.rindex("}\n", 0, launcher)  # the kernel's last line
    return src[:end] + (
        "  if (tid == 0) {\n"
        "    for (int i = 0; i < 5; ++i) atomicAdd(&cg_clk[i], static_cast<unsigned long long>(cg_acc[i]));\n"
        "    atomicAdd(&cg_clk[15], static_cast<unsigned long long>(cg_n));\n  }\n") + src[end:]


K2_PHASES = ("staging", "hidden layer", "w product", "dx", "dW and dsh partials", "dsh sum", "dh product", "demb")


def clocks_k2(src: str) -> str:
    """clocks for K2: cycles per tile of thread 0 between the marks (a mark
    just before a phase that starts at a barrier counts that phase's wait in
    the next phase)."""
    src = _once(src, '#include "radial_mlp.cuh"\n', '#include "radial_mlp.cuh"\n' + MARKS)
    src = _once(src, "  cg::order_paths(tab, s_order);\n",
                "  cg::order_paths(tab, s_order);\n  long long cg_acc[8] = {}, cg_t = clock64();\n  int cg_n = 0;\n")
    src = _once(src, "    __syncthreads();  // s_w1 is staged; the previous tile's readers are done\n",
                "    __syncthreads();  // s_w1 is staged; the previous tile's readers are done\n"
                "    if (tid == 0) cg_t = clock64();\n    ++cg_n;\n")
    src = _once(src, " : T(0);\n    __syncthreads();\n\n", " : T(0);\n    __syncthreads();\n    CG_MARK(0);\n\n")
    src = re.sub(r"\n(\s+)// w = alpha1 \* h \. W2", r"\n\1CG_MARK(1);\n\1// w = alpha1 * h . W2", src)
    src = _once(src, "    // the CG-VJP (cg_vjp.cuh)", "    CG_MARK(2);\n    // the CG-VJP (cg_vjp.cuh)")
    src = _once(src, "    __syncthreads();  // dx has read w; the dsh partials are zero\n",
                "    __syncthreads();  // dx has read w; the dsh partials are zero\n    CG_MARK(3);\n")
    src = _once(src, "    __syncthreads();\n    cg::path_sum",
                "    __syncthreads();\n    CG_MARK(4);\n    cg::path_sum")
    for i, anchor in ((5, "    // dh_pre = alpha1 * (dW_e . W2^T)"), (6, "    // demb = alpha0 * dh_pre . W1^T")):
        src = _once(src, anchor, f"    CG_MARK({i});\n{anchor}")
    src = _once(src, "narrow<S>(a.alpha0 * acc);\n    }\n", "narrow<S>(a.alpha0 * acc);\n    }\n    CG_MARK(7);\n")
    launcher = re.search(r"template <typename S, int TILE, int MIN_BLOCKS>\ncudaError_t launch_tile", src).start()
    end = src.rindex("}\n", 0, launcher)  # the kernel's last line
    return src[:end] + (
        "  if (tid == 0) {\n"
        "    for (int i = 0; i < 8; ++i) atomicAdd(&cg_clk[i], static_cast<unsigned long long>(cg_acc[i]));\n"
        "    atomicAdd(&cg_clk[15], static_cast<unsigned long long>(cg_n));\n  }\n") + src[end:]


def clocks_k1(src: str) -> str:
    """clocks for K1 (each of its paths, f32/f64 and bf16, or the one path of
    an earlier tree): cycles per tile of thread 0 between the marks, and,
    where the launcher marks its second launch, that launch's time by CUDA
    events (cg_read_finish_ms; cg_finish_timed says whether it is)."""
    src = _once(src, '#include "radial_mlp.cuh"\n', '#include "radial_mlp.cuh"\n' + MARKS + FINISH_TIMER)
    src = _once(src, "  extern __shared__ __align__(16) unsigned char smem_raw[];\n",
                "  extern __shared__ __align__(16) unsigned char smem_raw[];\n"
                "  long long cg_acc[5] = {}, cg_t = 0;\n  int cg_n = 0;\n")

    def each(pattern: str, repl: str, flags=0) -> None:
        nonlocal src
        src, n = re.subn(pattern, repl, src, flags=flags)
        if n not in (1, 2):
            raise RuntimeError(f"K1 clocks: {n} matches of {pattern!r}, not one a path")

    each(r"(\n(\s+)__syncthreads\(\);  // s_w1 is staged; the previous tile's readers are done\n)",
         r"\1\2if (tid == 0) cg_t = clock64();\n\2++cg_n;\n")
    for i, anchor in enumerate(("// hidden layer", "// w = alpha1 * h . W2", "// x[src] rows", "// CG product")):
        each(r"\n([ \t]+)" + re.escape(anchor), r"\n\1CG_MARK(%d);\n\1%s" % (i, anchor))
    each(r"(\n([ \t]+)cgf::cg_forward(?:_compensated)?<.*?\n\s*\}\);\n)", r"\1\2CG_MARK(4);\n", re.S)
    launcher = src.index("// shared memory of one block")
    end = src.rindex("}\n", 0, launcher)  # the kernel's last line
    src = src[:end] + (
        "  if (threadIdx.x == 0) {\n"
        "    for (int i = 0; i < 5; ++i) atomicAdd(&cg_clk[i], static_cast<unsigned long long>(cg_acc[i]));\n"
        "    atomicAdd(&cg_clk[15], static_cast<unsigned long long>(cg_n));\n  }\n") + src[end:]
    if "  // the second launch" not in src:
        return src + 'extern "C" int cg_finish_timed() { return 0; }\n'
    src += 'extern "C" int cg_finish_timed() { return 1; }\n'
    i = src.index("  // the second launch")
    j = src.index("  return static_cast<int>(err);\n", i)
    return (src[:i] + "  cudaEvent_t cg_e0, cg_e1;\n  cudaEventCreate(&cg_e0);\n  cudaEventCreate(&cg_e1);\n"
            "  cudaEventRecord(cg_e0, s);\n" + src[i:j] +
            "  cudaEventRecord(cg_e1, s);\n  cudaEventSynchronize(cg_e1);\n  float cg_ms = 0.f;\n"
            "  cudaEventElapsedTime(&cg_ms, cg_e0, cg_e1);\n  cg_finish_ms_ += cg_ms;\n"
            "  cudaEventDestroy(cg_e0);\n  cudaEventDestroy(cg_e1);\n" + src[j:])


def force_k1(tile: int, blocks: int):
    """K1's launch shape forced: pick_shape (which the tile query and the
    launcher take) returns it, launch_shape launches it."""
    def patch(src: str) -> str:
        for fn, body in (("Shape pick_shape(", f"  return {{{tile}, {blocks}}};\n"),
                         ("cudaError_t launch_shape(", f"  return launch_tile<S, {tile}, {blocks}>(a, dev, smem, s);\n")):
            i = src.index("{\n", src.index(fn)) + 2
            src = src[:i] + body + src[src.index("\n}\n", i) + 1:]
        return src
    return patch


FWD_PHASES = ("barrier (the other warps' sums)", "staging, destinations, y", "c * y, x and w",
              "CG product and sums", "of which the CG product", "of which the walk")
SPLIT = """
#define CGF_SPLIT(i) { const long long t_ = clock64(); cgf_acc[i] += t_ - cgf_t; cgf_t = t_; }
"""


def clocks_fwd(src: str) -> str:
    """clocks for K4 and K6: cycles per tile of thread 0 (warp 0, which also
    finds the destinations) in each phase between the barriers of a tile
    (the marks' definitions come with clocks_fwd_header)."""
    src = _once(src, "  const int n_tiles = (n_real + TILE - 1) / TILE;\n",
                "  const int n_tiles = (n_real + TILE - 1) / TILE;\n"
                "  long long cg_acc[5] = {0, 0, 0, 0, 0}, cg_t = clock64();\n  int cg_n = 0;\n")
    src = _once(src, "readers are done\n", "readers are done\n    CG_MARK(0);\n    ++cg_n;\n")
    src = re.sub(r"(cp_async_wait<1>\(\);[^\n]*\n    __syncthreads\(\);\n)", r"\1    CG_MARK(1);\n", src, count=1)
    src = _once(src, "    cp_async_wait<0>();\n    __syncthreads();\n",
                "    cp_async_wait<0>();\n    __syncthreads();\n    CG_MARK(2);\n")
    launcher = re.search(r"template <typename \w+, int TILE, bool kAcc, int MIN_BLOCKS>\ncudaError_t launch_tile",
                         src).start()
    end = src.rindex("  }\n}\n", 0, launcher)  # the end of the tile loop
    return src[:end] + (
        "    CG_MARK(3);\n  }\n  if (tid == 0) {\n"
        "    for (int i = 0; i < 4; ++i) atomicAdd(&cg_clk[i], static_cast<unsigned long long>(cg_acc[i]));\n"
        "    atomicAdd(&cg_clk[15], static_cast<unsigned long long>(cg_n));\n  }\n}\n") + src[end + len("  }\n}\n"):]


def clocks_fwd_header(src: str) -> str:
    """The marks' definitions in cg_fwd.cuh, and the split of each column
    walk's cycles (thread 0, summed over its calls) into the CG product
    (cg_clk[4]) and the rest of the column loop (cg_clk[5]: the walk's sums
    and stores, and the column's table lookups)."""
    if "namespace cgf" not in src:  # the other headers
        return src
    src = _once(src, '#include "dense_tiles.cuh"\n', '#include "dense_tiles.cuh"\n' + MARKS + SPLIT)
    for fn in ("cg_forward", "cg_forward_compensated", "cg_forward_jvp", "cg_forward_jvp_compensated"):
        start = src.index("{\n", re.search(rf"void {fn}\(", src).end()) + 2
        end = src.index("\n}\n", start)
        body, n = re.subn(r"(\n\s*)(product(?:_jvp)?<[^;]*;)", r"\1CGF_SPLIT(5);\1\2\1CGF_SPLIT(4);", src[start:end])
        if n != 1:
            raise RuntimeError(f"{fn}: {n} product calls")
        src = (src[:start] + "  long long cgf_acc[6] = {}, cgf_t = clock64();\n" + body +
               "\n  CGF_SPLIT(5);\n  if (threadIdx.x == 0) {\n"
               "    atomicAdd(&cg_clk[4], static_cast<unsigned long long>(cgf_acc[4]));\n"
               "    atomicAdd(&cg_clk[5], static_cast<unsigned long long>(cgf_acc[5]));\n  }" + src[end:])
    return src


def force(tile: int, stages: int, blocks: int, threads: int = 256):
    def patch(src: str) -> str:
        if "pick_shape" in src:  # K4, K6: the shape their launcher and tile query take
            if stages != 1:
                raise SystemExit("K4 and K6 have one stage: tile<T>x1x<B>")
            if "cudaError_t launch_shape(" not in src:
                raise SystemExit("tile<T>x1x<B> of K4 and K6 patches their launch_shape, which these sources lack")
            src = re.sub(r"pick_shape<S>\([^;]*\)", f"Shape{{{tile}, {blocks}}}", src)
            i = src.index("{\n", src.index("cudaError_t launch_shape(")) + 2  # B blocks' register cap
            launch = f"  return launch_tile<S, {tile}, kAcc, {blocks}>(a, dev, smem, s);"
            src = src[:i] + launch + src[src.index("\n}\n", i):]
            return src if threads == 256 else re.sub(r"\bkThreads\b", str(threads), src)
        i = src.index("  cudaError_t e;\n")
        if "  if constexpr (std::is_same<S, T>::value) {\n    if (fits(" in src:  # K5's f32/f64 first shape
            i = src.index("  if constexpr (std::is_same<S, T>::value) {\n    if (fits(")
        j = src.index("  return static_cast<int>(e);\n", i)
        if "auto fits = " in src:  # K5: fits() picks the staged g rows and sets smem
            check, smem = f"fits({tile}, {stages}, {blocks})", "smem"
        else:
            check, smem = f"lim.fit(smem({tile}, {stages}), {blocks})", f"smem({tile}, {stages})"
        launch = f"launch_tile<S, {tile}, {stages}, {blocks}>(a, lim.dev, {smem}, s)"
        forced = f"  if (!({check})) return 999;  // no such shape here\n  const cudaError_t e = {launch};\n"
        src = src[:i] + forced + src[j:]
        return src if threads == 256 else re.sub(r"\bkThreads\b", str(threads), src)  # the kernel's block size
    return patch


def prefetch(src: str) -> str:
    rows = ("a.w", "a.dw") if "a.cdw" in src else ("a.w",)
    body = "".join(
        f"        for (int i = tid * 128; i < nbytes; i += NT * 128)\n"
        f"          asm volatile(\"prefetch.global.L2 [%0];\" ::\"l\"(reinterpret_cast<const char*>({r} + "
        f"static_cast<int64_t>(nb) * wn) + i));\n" for r in rows)
    return _once(src, "    if (STAGES == 1) cp_async_wait<0>();\n    __syncthreads();\n",
                 "    if (STAGES == 1) cp_async_wait<0>();\n    __syncthreads();\n"
                 "    {\n      const int nb = (tile + static_cast<int>(gridDim.x)) * TILE;\n"
                 "      if (nb < n_real) {\n"
                 "        const int nbytes = min(TILE, n_real - nb) * wn * static_cast<int>(sizeof(T));\n"
                 + body + "      }\n    }\n")


# cg::add_run summing each edge's partial over the lanes on its own
SHUFFLE_SUMS = ("""  const T s = reduce_scatter<T, TC>(v, lane);
  if ((lane & (32 / TC - 1)) == 0) part[((e0 + edge_of<TC>(lane)) * n_paths + p) * kMaxYDim + m] += s;
""", """  for (int i = 0; i < TC; ++i) {
    T s = v[i];
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) part[((e0 + i) * n_paths + p) * kMaxYDim + m] += s;
  }
""")


def _sub(pattern: str, repl: str):
    return lambda src: re.sub(pattern, repl, src)


# variant -> (patch of a kernel's .cu, patch of the headers)
VARIANTS = {
    "base": (None, None),
    "clocks": (clocks, None),
    "shuffle_sums": (None, lambda src: src.replace(*SHUFFLE_SUMS)),
    "g_rows0": (_sub(r"constexpr int kGRows = \d+;", "constexpr int kGRows = 0;"), None),
    "prefetch": (prefetch, None),
    "unroll4": (None, _sub(r"#pragma unroll 2", "#pragma unroll 4")),
    "unroll_parts": (None, _sub(r"#pragma unroll 1\n(\s+for \(int e0 = 0; e0 < TILE; e0 \+= PART\))",
                                r"#pragma unroll\n\1")),
}


def variant(name: str, kernel: str = ""):
    if "+" in name:  # variants joined: each one's patches in turn
        parts = [variant(n, kernel) for n in name.split("+")]
        return tuple((lambda src, fs=[q[i] for q in parts if q[i]]: functools.reduce(lambda t, f: f(t), fs, src))
                     for i in (0, 1))
    m = re.fullmatch(r"part(\d+)", name)
    if m:
        return _sub(r"constexpr int kWalkPart = \d+;", f"constexpr int kWalkPart = {m.group(1)};"), None
    m = re.fullmatch(r"tile(\d+)x(\d+)", name)
    if m and kernel == "conv_fwd":
        return force_k1(*(int(v) for v in m.groups())), None
    m = re.fullmatch(r"tile(\d+)x(\d+)x(\d+)(?:t(\d+))?", name)
    if m:
        return force(*(int(v) for v in m.groups() if v is not None)), None
    m = re.fullmatch(r"edges(\d+)", name)
    if m:
        return _sub(r"constexpr int kCgEdges = \d+;", f"constexpr int kCgEdges = {m.group(1)};"), None
    m = re.fullmatch(r"mma(\d+)x(\d+)", name)
    if m:
        bk, st = m.groups()
        return (lambda src: re.sub(r"constexpr int kMmaStages = \d+;", f"constexpr int kMmaStages = {st};",
                                   re.sub(r"constexpr int kMmaBK = \d+;", f"constexpr int kMmaBK = {bk};", src))), None
    if name == "clocks" and kernel in FWD_KERNELS:
        return clocks_fwd, clocks_fwd_header
    if name == "clocks" and kernel == "conv_bwd":
        return clocks_k2, None
    if name == "clocks" and kernel == "conv_fwd":
        return clocks_k1, None
    if name not in VARIANTS:
        raise SystemExit(f"unknown variant {name!r}: {', '.join(VARIANTS)}, edges<N>, part<P>, mma<BK>x<S> "
                         "or tile<T>x<S>x<B>[t<N>]")
    return VARIANTS[name]


def build_variant(name: str, kernel: str, root: str, csrc=build.CSRC) -> str:
    cu_patch, h_patch = variant(name, kernel)
    d = os.path.join(root, f"{name}_{kernel}")
    os.makedirs(d)
    for f in os.listdir(csrc):
        if f.endswith(".cuh") or f == f"{kernel}.cu":
            src = (Path(csrc) / f).read_text()
            patch = h_patch if f.endswith(".cuh") else cu_patch
            with open(os.path.join(d, f), "w") as out:
                out.write(patch(src) if patch else src)
    lib = os.path.join(d, f"lib{kernel}.so")
    r = subprocess.run([build._find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-Xcompiler", "-fPIC", "-shared", "-Xptxas=-v", f"-I{d}", os.path.join(d, f"{kernel}.cu"),
                        "-o", lib], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"{name} {kernel}: nvcc failed\n{r.stderr[-3000:]}")
    return lib, r.stdout + r.stderr


def print_registers(key: str, ptxas: str, dtype) -> None:
    """One line a kernel of the build's dtype: registers and spill bytes."""
    recs = chip_ptxas.kernels(ptxas)
    names = chip_ptxas.demangle(list(recs))
    want = {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]
    for mangled, rec in sorted(recs.items(), key=lambda kv: names[kv[0]]):
        name = chip_ptxas.normal(names[mangled])
        if chip_ptxas.precision(name) == want and "_kernel<" in name:
            print(f"{key}: {name.split('(')[0]}: {rec.get('registers')} registers, spill "
                  f"{rec.get('spill_stores')} / {rec.get('spill_loads')} bytes", flush=True)


def flagship_inputs(seed=0):
    """The 23k-atom graph, its second of 4 edge slices (boundaries 7 edges into
    a segment, as chip_smoke.py's phase 2) and the flagship's conv plans."""
    from nequip_tpu_torch.model import NequIPGNNModel
    from nequip_tpu_torch.nn.interaction_block import InteractionBlock

    dev = torch.device("cuda")
    data, _, _ = CS.graph(23000, dev)
    layout = data[K.LAYOUT_KEY]
    n_real = layout.n_real
    bounds = [0] + [s * n_real // CS.N_CHUNKS + 7 for s in range(1, CS.N_CHUNKS)] + [n_real]
    sl = K.edge_slices(layout, CS.N_CHUNKS, bounds)[1]
    model = NequIPGNNModel(seed=0, model_dtype="float32", tp_impl="fused", **CS.FLAGSHIP)
    blocks = [m for m in model.modules() if isinstance(m, InteractionBlock)]
    return data, layout, sl, blocks, np.random.RandomState(seed)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_cg_profile.py needs an NVIDIA GPU")
    args = sys.argv[1:]
    fwd = "--fwd" in args
    k1 = "--k1" in args
    k2 = "--k2" in args
    args = [a for a in args if a not in ("--k1", "--k2")]
    dtype = torch.float32
    if "--dtype" in args:
        i = args.index("--dtype")
        dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[args[i + 1]]
        del args[i:i + 2]
    parent = None
    if "--parent" in args:
        i = args.index("--parent")
        parent = Path(args[i + 1]) / "nequip_tpu_torch" / "csrc"
        del args[i:i + 2]
    names = [a for a in args if a != "--fwd"] or ["base", "clocks"]
    if parent is not None:
        names = [n for name in names for n in (name, f"{name}@parent")]
    kernels = FWD_KERNELS if fwd else ("conv_fwd",) if k1 else ("conv_bwd",) if k2 else KERNELS
    keys = [f"{n}#{i}" if names.count(n) > 1 else n for i, n in enumerate(names)]  # a variant may repeat
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as root, ThreadPoolExecutor(os.cpu_count()) as ex:
        futs = {(k, kern): ex.submit(build_variant, k.split("#")[0].split("@")[0], kern,
                                     os.path.join(root, k.replace("#", "_").replace("@", "_")),
                                     parent if "@parent" in k else build.CSRC)
                for k in keys for kern in kernels}
        built = {key: f.result() for key, f in futs.items()}
        print(f"built {len(built)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)
        for (k, kern), (_, ptxas) in built.items():
            print_registers(f"{k} {kern}", ptxas, dtype)
        libs = {key: ctypes.CDLL(lib) for key, (lib, _) in built.items()}
        for (k, kern), lib in libs.items():
            entries = ([kern + "_train"] if k2 else [kern, kern + "_tile"] if k1 else
                       [kern] + ([kern + "_acc", kern + "_tile"] if fwd else []))
            for entry in entries:
                fn = getattr(lib, f"nequip_{entry}_{SUFFIX[dtype]}")
                fn.argtypes, fn.restype = build._SIGNATURES[f"nequip_{entry}"], ctypes.c_int
        if fwd:
            run_fwd(keys, libs, dtype)
        elif k1:
            run_k1(keys, libs, dtype)
        elif k2:
            run_k2(keys, libs, dtype)
        else:
            run(keys, libs, dtype)
    return 0


SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def agrees(outs, refs, dtype) -> bool:
    """f32: rtol 1e-4 with atol 1e-5 max|ref|; bf16: phase 16a's gate,
    max|out - ref| <= 8e-3 max|ref| for each output."""
    if dtype == torch.bfloat16:
        return all(float((a.float() - b.float()).abs().max()) <= CS.BF16_KERNEL_TOL * float(b.float().abs().max())
                   for a, b in zip(outs, refs))
    return all(bool(((a - b).abs() <= 1e-4 * b.abs() + 1e-5 * float(b.abs().max())).all()) for a, b in zip(outs, refs))


def run(keys, libs, dtype=torch.float32) -> None:
    dev = torch.device("cuda")
    data, layout, sl, blocks, rng = flagship_inputs()
    N, E = data["pos"].shape[0], data["edge_index"].shape[1]
    lay_s, rows = sl.layout, slice(sl.start, sl.stop)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    sums, bad, differ = {}, [], []
    for li, blk in enumerate(blocks):
        plan = blk.tp_scatter.plan
        t = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=dtype, device=dev)  # noqa: E731
        x, sh, g, w = t(N, plan.dim_in), t(E, plan.sh_dim), t(N, plan.mid_dim), t(E, plan.weight_numel)
        tx, tsh, dw, gt = t(N, plan.dim_in), t(E, plan.sh_dim), t(E, plan.weight_numel), t(N, plan.mid_dim)
        tab = plan.device_tables(dev, K.acc_dtype(dtype))
        tabs = [tab[k].data_ptr() for k in ("dx_groups", "dx_terms", "dx_coef", "dx_col", "paths", "path_terms",
                                            "path_coef")]
        widths = {"tri_bwd": (plan.dim_in, plan.sh_dim, plan.weight_numel),
                  "jvp_bwd": (plan.dim_in, plan.dim_in, plan.sh_dim, plan.sh_dim, plan.weight_numel,
                              plan.weight_numel)}
        refs = {"tri_bwd": K.tri_bwd_plain(plan, x, sh, w, layout, g),
                "jvp_bwd": K.jvp_bwd_plain(plan, x, tx, sh[rows], tsh[rows], w[rows], dw[rows], lay_s, g, gt)}

        def call(kern, lib, outs):
            if kern == "tri_bwd":
                ops = [x, sh, w, layout.edge_src, layout.dst_ptr, g]
                n_nodes = layout.num_nodes
            else:
                ops = [x, tx, sh[rows], tsh[rows], w[rows], dw[rows], lay_s.edge_src, lay_s.dst_ptr, g, gt]
                n_nodes = lay_s.num_nodes
            err = getattr(lib, f"nequip_{kern}_{SUFFIX[dtype]}")(
                *(o.data_ptr() for o in ops), *tabs, *(o.data_ptr() for o in outs), len(plan.paths), n_nodes,
                plan.dim_in, plan.sh_dim, plan.weight_numel, plan.mid_dim, stream())
            if err:
                raise RuntimeError(f"{kern}: cudaError {err}")

        first = {}  # (variant, kernel) -> the first call's outputs, for the parent's comparison
        for (k, kern), lib in libs.items():
            rows_out = E if kern == "tri_bwd" else sl.stop - sl.start
            outs = tuple(torch.zeros(rows_out, wd, dtype=dtype, device=dev) for wd in widths[kern])
            rec = dict(variant=k, kernel=kern, layer=li)
            try:
                clk = "clocks" in k.split("@")[0].split("#")[0].split("+")
                if clk:
                    lib.cg_zero_clk()
                call(kern, lib, outs)
                torch.cuda.synchronize()
                rec["ok"] = agrees(outs, refs[kern], dtype)
                name = k.split("@")[0]
                if "@parent" in k and (name, kern) in first:
                    rec["same_as_parent"] = all(torch.equal(a, b) for a, b in zip(outs, first[name, kern]))
                    if not rec["same_as_parent"]:
                        differ.append((k, kern, li))
                elif "@parent" not in k:
                    first[name, kern] = tuple(o.clone() for o in outs)
                if clk:
                    buf = (ctypes.c_ulonglong * 16)()
                    lib.cg_read_clk(buf)
                    rec["cycles_per_tile"] = {p: buf[i] / buf[15] for i, p in enumerate(PHASES)}
                rec["ms"] = float(np.median([CS.cuda_median_ms(lambda: call(kern, lib, outs), 10) for _ in range(3)]))
            except RuntimeError as exc:  # a forced shape that does not fit
                rec.update(ok=False, ms=float("nan"), error=str(exc))
            sums.setdefault((k, kern), []).append(rec["ms"])
            if not rec["ok"] and "error" not in rec:
                bad.append((k, kern, li))
            print(json.dumps(rec), flush=True)
        del refs, first
        torch.cuda.empty_cache()
    for (k, kern), ms in sums.items():
        print(f"{kern} {k} {SUFFIX[dtype]}, sum of 3 layers: {sum(ms):.3f} ms ({', '.join(f'{m:.3f}' for m in ms)})",
              flush=True)
    if any("@parent" in k for k, _ in libs):
        print(f"outputs that differ from the parent build's: {differ}" if differ else
              "every output of every variant with a parent build is bitwise equal to the parent's", flush=True)
    if bad or differ:
        raise SystemExit(f"disagree with plain: {bad}; differ from the parent: {differ}")


def run_k2(keys, libs, dtype) -> None:
    """K2's training variant on the whole stream, per variant and layer."""
    dev = torch.device("cuda")
    data, layout, _, blocks, rng = flagship_inputs()
    N, E = data["pos"].shape[0], data["edge_index"].shape[1]
    n_real = layout.n_real
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    sums, bad = {}, []
    for li, blk in enumerate(blocks):
        plan = blk.tp_scatter.plan
        a0, a1 = blk.edge_mlp.alphas
        n_emb, hidden = blk.edge_mlp.w0.shape
        t = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=dtype, device=dev)  # noqa: E731
        x, sh, emb, w1, w2, g = (t(N, plan.dim_in), t(E, plan.sh_dim), t(E, n_emb), t(n_emb, hidden),
                                 t(hidden, plan.weight_numel), t(N, plan.mid_dim))
        w2t = w2.t().contiguous()
        tab = plan.device_tables(dev, K.acc_dtype(dtype))
        tabs = [tab[k].data_ptr() for k in ("dx_groups", "dx_terms", "dx_coef", "dx_col", "paths", "path_terms",
                                            "path_coef")]
        ref = K.conv_bwd_plain(plan, x, sh, emb, w1, w2, a0, a1, layout, g)
        outs = (torch.zeros_like(ref[0]), torch.zeros_like(sh), torch.zeros_like(emb))
        per_edge = tuple(torch.empty(n_real, wd, dtype=dtype, device=dev) for wd in (plan.weight_numel, hidden, hidden))

        def call(lib):
            err = getattr(lib, f"nequip_conv_bwd_train_{SUFFIX[dtype]}")(
                *(o.data_ptr() for o in (x, sh, emb, w1, w2, w2t, layout.edge_src, layout.dst_ptr, g)), *tabs,
                *(o.data_ptr() for o in outs + per_edge), len(plan.paths), layout.num_nodes, plan.dim_in,
                plan.sh_dim, n_emb, hidden, plan.weight_numel, plan.mid_dim, a0, a1, stream())
            if err:
                raise RuntimeError(f"conv_bwd_train: cudaError {err}")

        for (k, kern), lib in libs.items():
            rec = dict(variant=k, kernel="conv_bwd_train", layer=li)
            clk = "clocks" in k.split("@")[0].split("#")[0].split("+")
            if clk:
                lib.cg_zero_clk()
            call(lib)
            torch.cuda.synchronize()
            rec["ok"] = agrees(outs, ref, dtype)
            if clk:
                buf = (ctypes.c_ulonglong * 16)()
                lib.cg_read_clk(buf)
                rec["cycles_per_tile"] = {p: buf[i] / buf[15] for i, p in enumerate(K2_PHASES)}
            rec["ms"] = float(np.median([CS.cuda_median_ms(lambda: call(lib), 10) for _ in range(3)]))
            sums.setdefault(k, []).append(rec["ms"])
            if not rec["ok"]:
                bad.append((k, li))
            print(json.dumps(rec), flush=True)
        del ref, outs, per_edge
        torch.cuda.empty_cache()
    for k, ms in sums.items():
        print(f"conv_bwd_train {k} {SUFFIX[dtype]}, sum of 3 layers: {sum(ms):.3f} ms "
              f"({', '.join(f'{m:.3f}' for m in ms)})", flush=True)
    if bad:
        raise SystemExit(f"disagree with plain: {bad}")


def fwd_layers(blocks):
    """(label, conv block) of the flagship's 3 conv layers and of preset M's layer 1."""
    from nequip_tpu_torch.model import PresetNequIPGNNModel
    from nequip_tpu_torch.nn.interaction_block import InteractionBlock

    preset_m = PresetNequIPGNNModel(seed=0, model_dtype="float32", tp_impl="fused", type_names=["Cu"], r_max=4.0,
                                    preset="M", avg_num_neighbors=18.0)
    widest = [m for m in preset_m.modules() if isinstance(m, InteractionBlock)][1]
    return [(f"flagship {i}", b) for i, b in enumerate(blocks)] + [("preset M 1", widest)]


def run_k1(keys, libs, dtype) -> None:
    """K1 on the whole stream at the flagship's 3 layers and preset M's
    layer 1, per variant; with --parent the share of outputs that differ
    from the parent build's."""
    dev = torch.device("cuda")
    acc_dt = K.acc_dtype(dtype)
    data, layout, _, blocks, rng = flagship_inputs()
    N, E = data["pos"].shape[0], data["edge_index"].shape[1]
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    sums, bad = {}, []
    for label, blk in fwd_layers(blocks):
        plan = blk.tp_scatter.plan
        a0, a1 = blk.edge_mlp.alphas
        n_emb, hidden = blk.edge_mlp.w0.shape
        t = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=dtype, device=dev)  # noqa: E731
        x, sh, emb, w1, w2 = (t(N, plan.dim_in), t(E, plan.sh_dim), t(E, n_emb), t(n_emb, hidden),
                              t(hidden, plan.weight_numel))
        tab = plan.device_tables(dev, acc_dt)
        tabs = [tab[k].data_ptr() for k in ("fwd_groups", "fwd_terms", "fwd_coef", "fwd_col")]
        n_terms = tab["fwd_coef"].shape[0]
        ref = K.conv_fwd_plain(plan, x, sh, emb, w1, w2, a0, a1, layout)
        first = {}  # variant -> its output, for the parent's comparison
        for (k, kern), lib in libs.items():
            tile = getattr(lib, f"nequip_conv_fwd_tile_{SUFFIX[dtype]}")(plan.dim_in, plan.sh_dim, n_emb, hidden,
                                                                         plan.weight_numel, n_terms)
            carry = torch.empty(K.conv_fwd_carry_rows(E, max(tile, 1), dtype), plan.mid_dim, dtype=acc_dt, device=dev)
            out = torch.empty(N, plan.mid_dim, dtype=dtype, device=dev)

            def call(out=out, carry=carry, lib=lib, tile=tile):
                err = getattr(lib, f"nequip_conv_fwd_{SUFFIX[dtype]}")(
                    *(o.data_ptr() for o in (x, sh, emb, w1, w2, layout.edge_src, layout.dst_ptr)), *tabs,
                    out.data_ptr(), carry.data_ptr(), layout.num_nodes, plan.dim_in, plan.sh_dim, n_emb, hidden,
                    plan.weight_numel, plan.mid_dim, n_terms, tile, a0, a1, stream())
                if err:
                    raise RuntimeError(f"conv_fwd: cudaError {err}")

            rec = dict(variant=k, kernel="conv_fwd", layer=label, tile=tile)
            try:
                clk = "clocks" in k.split("@")[0].split("#")[0].split("+")
                if clk:
                    lib.cg_zero_clk()
                    lib.cg_zero_finish_ms()
                call()
                torch.cuda.synchronize()
                if clk:
                    buf = (ctypes.c_ulonglong * 16)()
                    lib.cg_read_clk(buf)
                    rec["cycles_per_tile"] = {p: buf[i] / buf[15] for i, p in enumerate(K1_PHASES)}
                    if lib.cg_finish_timed():
                        lib.cg_read_finish_ms.restype = ctypes.c_float
                        rec["finish_ms"] = lib.cg_read_finish_ms()
                got = out.clone()
                rec["ok"] = agrees((got,), (ref,), dtype)
                call()
                torch.cuda.synchronize()
                rec["repeat_equal"] = torch.equal(out, got)
                rec["ok"] = rec["ok"] and rec["repeat_equal"]
                name = k.split("@")[0]
                if "@parent" in k and name in first:
                    rec["share_differing_from_parent"] = float((got != first[name]).float().mean())
                elif "@parent" not in k:
                    first[name] = got
                rec["ms"] = float(np.median([CS.cuda_median_ms(call, 10) for _ in range(3)]))
            except RuntimeError as exc:  # a forced shape that does not fit
                rec.update(ok=False, ms=float("nan"), error=str(exc))
            sums.setdefault(k, []).append(rec["ms"])
            if not rec["ok"] and "error" not in rec:
                bad.append((k, label))
            print(json.dumps(rec), flush=True)
        del ref, first
        torch.cuda.empty_cache()
    for k, ms in sums.items():
        print(f"conv_fwd {k} {SUFFIX[dtype]}: flagship's 3 layers {sum(ms[:3]):.3f} ms "
              f"({', '.join(f'{m:.3f}' for m in ms[:3])}), preset M layer 1 {ms[3]:.3f} ms", flush=True)
    if bad:
        raise SystemExit(f"disagree with plain or with a repeat call: {bad}")


FWD_ENTRIES = ("tri_fwd", "tri_fwd_acc", "jvp_fwd", "jvp_fwd_acc")


def run_fwd(keys, libs, dtype) -> None:
    """K4, K4-acc, K6 and K6-acc on the whole stream and on the second of 4
    slices, per variant and layer; with --parent each output against the
    same variant's from the parent build, bitwise."""
    dev = torch.device("cuda")
    acc_dt = K.acc_dtype(dtype)
    data, layout, sl, blocks, rng = flagship_inputs()
    N, E = data["pos"].shape[0], data["edge_index"].shape[1]
    rows = slice(sl.start, sl.stop)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    sums, bad, differ = {}, [], []
    for label, blk in fwd_layers(blocks):
        plan = blk.tp_scatter.plan
        t = lambda *s, dt=dtype: torch.as_tensor(rng.standard_normal(s), dtype=dt, device=dev)  # noqa: E731
        x, sh, w, tx, tsh, dw = (t(N, plan.dim_in), t(E, plan.sh_dim), t(E, plan.weight_numel), t(N, plan.dim_in),
                                 t(E, plan.sh_dim), t(E, plan.weight_numel))
        acc = (t(N, plan.mid_dim, dt=acc_dt), t(N, plan.mid_dim, dt=acc_dt))
        tab = plan.device_tables(dev, acc_dt)
        tabs = [tab[k].data_ptr() for k in ("fwd_groups", "fwd_terms", "fwd_coef", "fwd_col")]
        n_terms = tab["fwd_coef"].shape[0]
        dims = (n_terms, N, plan.dim_in, plan.sh_dim, plan.weight_numel, plan.mid_dim)
        ops = {"stream": (x, tx, sh, tsh, w, dw, layout), "slice": (x, tx, sh[rows], tsh[rows], w[rows], dw[rows],
                                                                     sl.layout)}
        fresh = lambda entry: tuple(a.clone() for a in acc[:2 if entry == "jvp_fwd_acc" else 1])  # noqa: E731

        def plain(entry, on):
            x_, tx_, y, ty, w_, dw_, lay = ops[on]
            if entry.startswith("tri_fwd"):
                return (K.tri_fwd_plain(plan, x_, y, w_, lay, fresh(entry)[0] if entry.endswith("_acc") else None),)
            return K.jvp_fwd_plain(plan, x_, tx_, y, ty, w_, dw_, lay, fresh(entry) if entry.endswith("_acc") else None)

        def call(entry, on, lib, outs, carry, tile):
            x_, tx_, y, ty, w_, dw_, lay = ops[on]
            ins = [x_, tx_, y, ty, w_, dw_] if entry.startswith("jvp_fwd") else [x_, y, w_]
            err = getattr(lib, f"nequip_{entry}_{SUFFIX[dtype]}")(
                *(o.data_ptr() for o in ins + [lay.edge_src, lay.dst_ptr]), *tabs, *(o.data_ptr() for o in outs),
                carry.data_ptr(), *dims, tile, stream())
            if err:
                raise RuntimeError(f"{entry}: cudaError {err}")

        first = {}  # (variant, entry, on) -> the first call's outputs, for the parent's comparison
        for entry in FWD_ENTRIES:
            for on in ("stream", "slice"):
                ref = plain(entry, on)
                for (k, kern), lib in libs.items():
                    if not entry.startswith(kern):
                        continue
                    tile = getattr(lib, f"nequip_{kern}_tile_{SUFFIX[dtype]}")(plan.dim_in, plan.sh_dim,
                                                                              plan.weight_numel, n_terms)
                    n_edges = ops[on][-1].n_real
                    carry = torch.empty(K.conv_fwd_carry_rows(n_edges, max(tile, 1), dtype),
                                        (2 if kern == "jvp_fwd" else 1) * plan.mid_dim, dtype=acc_dt, device=dev)
                    outs = (fresh(entry) if entry.endswith("_acc") else
                            tuple(torch.empty(N, plan.mid_dim, dtype=dtype, device=dev)
                                  for _ in range(2 if kern == "jvp_fwd" else 1)))
                    rec = dict(variant=k, kernel=entry, on=on, layer=label, tile=tile)
                    try:
                        clk = "clocks" in k.split("@")[0].split("#")[0].split("+")
                        if clk:
                            lib.cg_zero_clk()
                        call(entry, on, lib, outs, carry, tile)
                        torch.cuda.synchronize()
                        if clk:
                            buf = (ctypes.c_ulonglong * 16)()
                            lib.cg_read_clk(buf)
                            rec["cycles_per_tile"] = {p: buf[i] / buf[15] for i, p in enumerate(FWD_PHASES)}
                        rec["ok"] = agrees(outs, ref, dtype)
                        name = k.split("@")[0]
                        if "@parent" in k and (name, entry, on) in first:
                            rec["same_as_parent"] = all(torch.equal(a, b) for a, b in zip(outs, first[name, entry, on]))
                            if not rec["same_as_parent"]:
                                differ.append((k, entry, on, label))
                        elif "@parent" not in k:
                            first[name, entry, on] = tuple(o.clone() for o in outs)
                        rec["ms"] = float(np.median([CS.cuda_median_ms(lambda: call(entry, on, lib, outs, carry, tile),
                                                                       10) for _ in range(3)]))
                    except RuntimeError as exc:  # a forced shape that does not fit
                        rec.update(ok=False, ms=float("nan"), error=str(exc))
                    sums.setdefault((k, entry, on), []).append(rec["ms"])
                    if not rec["ok"] and "error" not in rec:
                        bad.append((k, entry, on, label))
                    print(json.dumps(rec), flush=True)
                del ref
                first = {key: v for key, v in first.items() if key[1:] != (entry, on)}
        del ops, acc
        torch.cuda.empty_cache()
    for (k, entry, on), ms in sums.items():
        print(f"{entry} on the {on} {k} {SUFFIX[dtype]}: flagship's 3 layers {sum(ms[:3]):.3f} ms "
              f"({', '.join(f'{m:.3f}' for m in ms[:3])}), preset M layer 1 {ms[3]:.3f} ms", flush=True)
    if differ:
        print(f"outputs that differ from the parent build's: {differ}", flush=True)
    else:
        print("every output of every variant with a parent build is bitwise equal to the parent's"
              if any("@parent" in k for k, _ in libs) else "", flush=True)
    if bad or differ:
        raise SystemExit(f"disagree with plain: {bad}; differ from the parent: {differ}")


if __name__ == "__main__":
    sys.exit(main())
