#!/usr/bin/env python3
"""Where the conv kernels on dense edge tiles spend their time, and what
their variants cost, on one NVIDIA GPU.

    python3 chip_cg_profile.py [VARIANT ...]        (default: base clocks)
    python3 chip_cg_profile.py --fwd [VARIANT ...]  (default: base owner)

The kernels (K5 ``csrc/tri_bwd.cu`` and K7 ``csrc/jvp_bwd.cu``; with
``--fwd`` K4 and K4-acc ``csrc/tri_fwd.cu`` and K6 ``csrc/jvp_fwd.cu``) are
built once per variant, each from a patched copy of its source in its own
library under ``nequip_tpu_torch/_build/``, and timed (CUDA events, median
of 3 x 10 calls, the variants in turns) at the f32 shapes phase 2 of
``chip_smoke.py`` gives them: K5 and K4 on the whole 23k-atom stream, K7,
K4-acc and K6 on the second of 4 edge slices, at each of the flagship's 3
conv layers.  Each result is checked against the plain version (f32, rtol
1e-4 with atol 1e-5 max|ref|).  Variants of K5 and K7:

  base          the kernels as they are;
  clocks        clock64 marks: cycles per tile of thread 0 in each phase
                (staging and destinations, dx, dW and dy partials, dy sum,
                per-edge stores), summed over the blocks;
  shuffle_sums  each m2 run's dy partial summed edge by edge (5 shuffles an
                edge) instead of by a reduce-scatter;
  edges<N>      N edges an item (8 in K5, 4 in K7);
  g_rows0       no g rows staged in shared memory (K5; K7 stages none);
  tile<T>x<S>x<B>  the launch shape forced: T edges, S stages, B blocks an SM;
  prefetch      the next tile's weight rows prefetched into L2;
  unroll4       the term loops unrolled by 4 instead of 2.

Variants of K4 and K6 (``--fwd``):

  base          the kernels as they are (destinations split across tiles
                as K1 sums them: carry rows and a second launch);
  owner         owner-computes instead: a tile owns the nodes whose first
                edge lies in it and walks their edges in chunks of TILE, a
                running sum parked in the node's output row between chunks;
                no carry rows, no second launch;
  clocks        clock64 marks: cycles per tile of thread 0 in each phase
                (the barrier that waits for the other warps' sums; staging,
                destinations and y; c * y with x and w; the CG product and
                sums);
  cy_rows       c * y edge-major, one 4- or 8-byte load an edge, as before
                the term-major 16-byte loads (K1 shares the header);
  tile<T>x1x<B> the launch shape forced: T edges, B blocks an SM (and the
                register cap of B blocks).
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import chip_smoke as CS
from nequip_tpu_torch.ops.kernels import build
from nequip_tpu_torch.ops.kernels import tp_scatter as K

KERNELS = ("tri_bwd", "jvp_bwd")
FWD_KERNELS = ("tri_fwd", "jvp_fwd")  # K4-acc is timed from tri_fwd's library

MARKS = """
__device__ unsigned long long cg_clk[8];
extern "C" int cg_read_clk(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, cg_clk, sizeof(cg_clk)));
}
extern "C" int cg_zero_clk() {
  const unsigned long long z[8] = {};
  return static_cast<int>(cudaMemcpyToSymbol(cg_clk, z, sizeof(z)));
}
#define CG_MARK(i) if (tid == 0) { const long long t_ = clock64(); cg_acc[i] += t_ - cg_t; cg_t = t_; }
"""
PHASES = ("staging", "dx", "dW and dy partials", "dy sum", "stores")


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
    lines.insert(max(j for j, ln in enumerate(lines) if "store_flat<T, NT>(" in ln) + 1, "    CG_MARK(4);")
    lines.insert(max(j for j, ln in enumerate(lines) if "cg::path_sum<T, NT>(" in ln) + 1, "    CG_MARK(3);")
    src = "\n".join(lines)
    launcher = src.index("template <typename T, int TILE, int STAGES, int MIN_BLOCKS>\ncudaError_t launch_tile")
    end = src.rindex("}\n", 0, launcher)  # the kernel's last line
    return src[:end] + (
        "  if (tid == 0) {\n"
        "    for (int i = 0; i < 5; ++i) atomicAdd(&cg_clk[i], static_cast<unsigned long long>(cg_acc[i]));\n"
        "    atomicAdd(&cg_clk[5], static_cast<unsigned long long>(cg_n));\n  }\n") + src[end:]


FWD_PHASES = ("barrier (the other warps' sums)", "staging, destinations, y", "c * y, x and w",
              "CG product and sums")


def clocks_fwd(src: str) -> str:
    """clocks for K4 and K6: cycles per tile of thread 0 (warp 0, which also
    finds the destinations) in each phase between the barriers of a tile."""
    src = _once(src, '#include "dense_tiles.cuh"\n', '#include "dense_tiles.cuh"\n' + MARKS)
    src = _once(src, "  const int n_tiles = (n_real + TILE - 1) / TILE;\n",
                "  const int n_tiles = (n_real + TILE - 1) / TILE;\n"
                "  long long cg_acc[5] = {0, 0, 0, 0, 0}, cg_t = clock64();\n  int cg_n = 0;\n")
    src = _once(src, "readers are done\n", "readers are done\n    CG_MARK(0);\n    ++cg_n;\n")
    src = re.sub(r"(cp_async_wait<1>\(\);[^\n]*\n    __syncthreads\(\);\n)", r"\1    CG_MARK(1);\n", src, count=1)
    src = _once(src, "    cp_async_wait<0>();\n    __syncthreads();\n",
                "    cp_async_wait<0>();\n    __syncthreads();\n    CG_MARK(2);\n")
    launcher = src.index("template <typename T, int TILE, bool kAcc, int MIN_BLOCKS>\ncudaError_t launch_tile")
    end = src.rindex("  }\n}\n", 0, launcher)  # the end of the tile loop
    return src[:end] + (
        "    CG_MARK(3);\n  }\n  if (tid == 0) {\n"
        "    for (int i = 0; i < 4; ++i) atomicAdd(&cg_clk[i], static_cast<unsigned long long>(cg_acc[i]));\n"
        "    atomicAdd(&cg_clk[5], static_cast<unsigned long long>(cg_n));\n  }\n}\n") + src[end + len("  }\n}\n"):]


def force(tile: int, stages: int, blocks: int):
    def patch(src: str) -> str:
        if "pick_shape" in src:  # K4, K6: the shape their launcher and tile query take
            if stages != 1:
                raise SystemExit("K4 and K6 have one stage: tile<T>x1x<B>")
            src = re.sub(rf"launch_tile<T, ({tile}|kTopTile<T>), kAcc, 2>", f"launch_tile<T, {tile}, kAcc, {blocks}>",
                         src)  # the register cap for B blocks an SM
            return re.sub(r"pick_shape<T>\([^;]*\)", f"Shape{{{tile}, {blocks}}}", src)
        i = src.index("  cudaError_t e;\n")
        j = src.index("  return static_cast<int>(e);\n", i)
        if "auto fits = " in src:  # K5: fits() picks the staged g rows and sets smem
            check, smem = f"fits({tile}, {stages}, {blocks})", "smem"
        else:
            check, smem = f"lim.fit(smem({tile}, {stages}), {blocks})", f"smem({tile}, {stages})"
        launch = f"launch_tile<T, {tile}, {stages}, {blocks}>(a, lim.dev, {smem}, s)"
        forced = f"  if (!{check}) return 999;  // no such shape here\n  const cudaError_t e = {launch};\n"
        return src[:i] + forced + src[j:]
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


# Owner-computes in K4 and K6, the alternative to their carry rows: a tile
# owns the nodes whose first edge lies in it and walks their edges [lo, hi)
# in chunks of TILE; a chunk writes the part of a segment that continues
# past it to the node's output row, and the next chunk adds its part onto
# the row; without accumulators the blocks zero the rows of nodes without
# edges first.  No carry rows and no second launch.
OWNER_DEFS = r"""
__device__ __forceinline__ int2 owned_edges(const int32_t* __restrict__ dst_ptr, int n_nodes, int base, int cnt) {
  const int d = tile_dst(dst_ptr, n_nodes, base, cnt);
  const int d0 = __shfl_sync(0xffffffffu, d, 0), d1 = __shfl_sync(0xffffffffu, d, cnt - 1);
  const int lo = __ldg(dst_ptr + d0) == base ? base : __ldg(dst_ptr + d0 + 1);
  return lo < base + cnt ? make_int2(lo, __ldg(dst_ptr + d1 + 1)) : make_int2(lo, lo);
}

template <int TILE>
__device__ __forceinline__ unsigned chunk_ends(const int32_t* __restrict__ dst_ptr, int n_nodes, int cb, int ccnt,
                                               int32_t* s_dst, bool& cont) {
  const int lane = threadIdx.x & 31;
  const int d = tile_dst(dst_ptr, n_nodes, cb, ccnt);
  const bool real = lane < ccnt;
  if (lane < TILE) s_dst[lane] = real ? d : 0;
  cont = __ldg(dst_ptr + __shfl_sync(0xffffffffu, d, 0)) < cb;
  return __ballot_sync(0xffffffffu, real && __ldg(dst_ptr + d + 1) == cb + lane + 1);
}

template <typename T>
__device__ __forceinline__ void zero_empty_rows(const int32_t* __restrict__ dst_ptr, T* __restrict__ out,
                                                int n_nodes, int mid_dim) {
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int n = blockIdx.x * warps + (threadIdx.x >> 5); n < n_nodes; n += gridDim.x * warps) {
    if (__ldg(dst_ptr + n) != __ldg(dst_ptr + n + 1)) continue;
    T* row = out + static_cast<int64_t>(n) * mid_dim;
    for (int c = lane; c < mid_dim; c += 32) row[c] = T(0);
  }
}

"""
OWNER_LOOPS = {
    "tri_fwd": r"""  if (!kAcc) zero_empty_rows(a.dst_ptr, a.out, a.n_nodes, mid_dim);
  const int n_tiles = (n_real + TILE - 1) / TILE;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int base = tile * TILE;
    __syncthreads();  // the previous tile's readers are done
    if (warp == 0) {
      const int2 r = owned_edges(a.dst_ptr, a.n_nodes, base, min(TILE, n_real - base));
      if (tid == 0) s_range[0] = r.x, s_range[1] = r.y;
    }
    __syncthreads();
    const int lo = s_range[0], hi = s_range[1];
    for (int cb = lo; cb < hi; cb += TILE) {
      const int ccnt = min(TILE, hi - cb);
      if (cb != lo) __syncthreads();  // the previous chunk's readers are done
      const int64_t oy = static_cast<int64_t>(cb) * sh_dim, ow = static_cast<int64_t>(cb) * wn;
      stage_flat<T, NT>(base_t + L.o_y, a.y + oy, ccnt * sh_dim, TILE * sh_dim, tid);
      cp_async_commit();
      stage_flat<T, NT>(base_t, a.w + ow, ccnt * wn, TILE * wn, tid);
      stage_rows<T, TILE, NT>(s_x, a.x, a.edge_src + cb, ccnt, dim_in, tid);
      cp_async_commit();
      if (warp == 0) {
        bool cont;
        const unsigned ends = chunk_ends<TILE>(a.dst_ptr, a.n_nodes, cb, ccnt, s_dst, cont);
        if (tid == 0) s_cont[0] = cont, s_cont[1] = static_cast<int32_t>(ends);
      }
      cp_async_wait<1>();  // y has landed
      __syncthreads();
      const T* s_y = base_t + L.o_y + phase16(a.y + oy);
      cgf::scale_y<T, TILE, NT>(a.tab, s_y, sh_dim, s_cy, tid);  // while x and w land
      cp_async_wait<0>();
      __syncthreads();

      const bool cont_in = s_cont[0];
      // the node ends, and the chunk's last edge, where a continuing segment's part goes to its row
      const unsigned ends = static_cast<unsigned>(s_cont[1]) | (1u << (ccnt - 1));
      const int first = __ffs(ends) - 1;  // where the chunk's first segment ends
      cgf::cg_forward<T, TILE, NT>(
          a.tab, s_cy, s_x, dim_in, base_t + phase16(a.w + ow), wn, mid_dim, ends, [&](int o, int e, T v) {
            T* r = a.out + static_cast<int64_t>(s_dst[e]) * mid_dim + o;
            if (kAcc || (cont_in && e == first))  // onto the accumulator, or onto the previous chunk's part
              *r += v;
            else
              *r = v;
          });
    }
  }
""",
    "jvp_fwd": r"""  if (!kAcc) {
    zero_empty_rows(a.dst_ptr, a.out, a.n_nodes, mid_dim);
    zero_empty_rows(a.dst_ptr, a.tout, a.n_nodes, mid_dim);
  }
  const int n_tiles = (n_real + TILE - 1) / TILE;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int base = tile * TILE;
    __syncthreads();  // the previous tile's readers are done
    if (warp == 0) {
      const int2 r = owned_edges(a.dst_ptr, a.n_nodes, base, min(TILE, n_real - base));
      if (tid == 0) s_range[0] = r.x, s_range[1] = r.y;
    }
    __syncthreads();
    const int lo = s_range[0], hi = s_range[1];
    for (int cb = lo; cb < hi; cb += TILE) {
      const int ccnt = min(TILE, hi - cb);
      if (cb != lo) __syncthreads();  // the previous chunk's readers are done
      const int64_t oy = static_cast<int64_t>(cb) * sh_dim, ow = static_cast<int64_t>(cb) * wn;
      stage_flat<T, NT>(base_t + L.o_y, a.y + oy, ccnt * sh_dim, TILE * sh_dim, tid);
      stage_flat<T, NT>(base_t + L.o_ty, a.ty + oy, ccnt * sh_dim, TILE * sh_dim, tid);
      cp_async_commit();
      stage_flat<T, NT>(base_t, a.w + ow, ccnt * wn, TILE * wn, tid);
      stage_flat<T, NT>(base_t + L.o_dw, a.dw + ow, ccnt * wn, TILE * wn, tid);
      stage_rows<T, TILE, NT>(s_x, a.x, a.edge_src + cb, ccnt, dim_in, tid);
      stage_rows<T, TILE, NT>(s_tx, a.tx, a.edge_src + cb, ccnt, dim_in, tid);
      cp_async_commit();
      if (warp == 0) {
        bool cont;
        const unsigned ends = chunk_ends<TILE>(a.dst_ptr, a.n_nodes, cb, ccnt, s_dst, cont);
        if (tid == 0) s_cont[0] = cont, s_cont[1] = static_cast<int32_t>(ends);
      }
      cp_async_wait<1>();  // y and ty have landed
      __syncthreads();
      cgf::scale_y<T, TILE, NT>(a.tab, base_t + L.o_y + phase16(a.y + oy), sh_dim, s_cy, tid);
      cgf::scale_y<T, TILE, NT>(a.tab, base_t + L.o_ty + phase16(a.ty + oy), sh_dim, s_cty, tid);
      cp_async_wait<0>();
      __syncthreads();

      const bool cont_in = s_cont[0];
      // the node ends, and the chunk's last edge, where a continuing segment's part goes to its row
      const unsigned ends = static_cast<unsigned>(s_cont[1]) | (1u << (ccnt - 1));
      const int first = __ffs(ends) - 1;  // where the chunk's first segment ends
      cgf::cg_forward_jvp<T, TILE, NT>(
          a.tab, s_cy, s_cty, s_x, s_tx, dim_in, base_t + phase16(a.w + ow),
          base_t + L.o_dw + phase16(a.dw + ow), wn, mid_dim, ends, [&](int o, int e, T v, T tv) {
            const int64_t at = static_cast<int64_t>(s_dst[e]) * mid_dim + o;
            if (kAcc || (cont_in && e == first)) {  // onto the accumulator, or onto the previous chunk's part
              a.out[at] += v;
              a.tout[at] += tv;
            } else {
              a.out[at] = v;
              a.tout[at] = tv;
            }
          });
    }
  }
""",
}


def owner(src: str) -> str:
    kern = "jvp_fwd" if "tout" in src else "tri_fwd"
    src = _once(src, "sizeof(int32_t) * (tile + 2);", "sizeof(int32_t) * (tile + 4);")
    i = src.index("  const int n_tiles = (n_real + TILE - 1) / TILE;\n")
    j = src.index("\n}\n\ntemplate <typename T, int TILE, bool kAcc, int MIN_BLOCKS>\ncudaError_t launch_tile")
    src = (src[:i] + "  const int warp = tid >> 5;\n  int32_t* s_range = s_flags;  // the tile's owned edges [lo, hi)\n"
           "  int32_t* s_cont = s_flags + 2;  // [0]: the chunk continues a segment; [1]: the chunk's ends\n"
           + OWNER_LOOPS[kern] + src[j:])
    src = _once(src, "template <typename T, int TILE, bool kAcc, int MIN_BLOCKS>\n__global__",
                OWNER_DEFS + "\ntemplate <typename T, int TILE, bool kAcc, int MIN_BLOCKS>\n__global__")
    return re.sub(r"  return static_cast<int>\(cgf::launch_finish<[^;]*;\n", "  return 0;  // no second launch\n", src)


# c * y edge-major, [TILE][n_terms], read one edge at a time (the layout before
# the 16-byte term-major loads of cg_fwd.cuh): (new text, old text) pairs
CY_ROWS = (
    (r"""    const int k = i / TILE, e = i - k * TILE;
""",
     r"""    const int e = i / tab.n_terms, k = i - e * tab.n_terms;
"""),
    (r"""    const int xr = __ldg(tab.terms + 2 * k) + c.u;
#pragma unroll
    for (int e0 = 0; e0 < TILE; e0 += V) {
      T cv[V];
      load16(cv, cy + k * TILE + e0);
#pragma unroll
      for (int j = 0; j < V; ++j) m[e0 + j] += cv[j] * x[(e0 + j) * ldx + xr];
    }
""",
     r"""    const int xr = __ldg(tab.terms + 2 * k) + c.u;
#pragma unroll
    for (int e = 0; e < TILE; ++e) m[e] += cy[e * tab.n_terms + k] * x[e * ldx + xr];
"""),
    (r"""      const int xr = __ldg(tab.terms + 2 * k) + c.u;
#pragma unroll
      for (int e0 = 0; e0 < TILE; e0 += V) {
        T cv[V], ctv[V];
        load16(cv, cy + k * TILE + e0);
        load16(ctv, cty + k * TILE + e0);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const int e = e0 + j;
          const T xa = x[e * ldx + xr];
          m[e] += cv[j] * xa;
          tm[e] += ctv[j] * xa + cv[j] * tx[e * ldx + xr];
        }
      }
    }
""",
     r"""      const int xr = __ldg(tab.terms + 2 * k) + c.u;
#pragma unroll
      for (int e = 0; e < TILE; ++e) {
        const T a = cy[e * tab.n_terms + k], xa = x[e * ldx + xr];
        m[e] += a * xa;
        tm[e] += cty[e * tab.n_terms + k] * xa + a * tx[e * ldx + xr];
      }
    }
"""),
)


def cy_rows(src: str) -> str:
    if "namespace cgf" not in src:  # the other headers
        return src
    for new, old in CY_ROWS:
        src = _once(src, new, old)
    return src


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
    "owner": (owner, None),
    "cy_rows": (None, cy_rows),
}


def variant(name: str, kernel: str = ""):
    m = re.fullmatch(r"tile(\d+)x(\d+)x(\d+)", name)
    if m:
        return force(*map(int, m.groups())), None
    m = re.fullmatch(r"edges(\d+)", name)
    if m:
        return _sub(r"constexpr int kCgEdges = \d+;", f"constexpr int kCgEdges = {m.group(1)};"), None
    if name == "clocks" and kernel in FWD_KERNELS:
        return clocks_fwd, None
    if name not in VARIANTS:
        raise SystemExit(f"unknown variant {name!r}: {', '.join(VARIANTS)}, edges<N> or tile<T>x<S>x<B>")
    return VARIANTS[name]


def build_variant(name: str, kernel: str, root: str) -> str:
    cu_patch, h_patch = variant(name, kernel)
    d = os.path.join(root, f"{name}_{kernel}")
    os.makedirs(d)
    for f in os.listdir(build.CSRC):
        if f.endswith(".cuh") or f == f"{kernel}.cu":
            src = (build.CSRC / f).read_text()
            patch = h_patch if f.endswith(".cuh") else cu_patch
            with open(os.path.join(d, f), "w") as out:
                out.write(patch(src) if patch else src)
    lib = os.path.join(d, f"lib{kernel}.so")
    r = subprocess.run([build._find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-Xcompiler", "-fPIC", "-shared", f"-I{d}", os.path.join(d, f"{kernel}.cu"), "-o", lib],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"{name} {kernel}: nvcc failed\n{r.stderr[-3000:]}")
    return lib


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
    names = [a for a in args if a != "--fwd"] or (["base", "owner"] if fwd else ["base", "clocks"])
    kernels = FWD_KERNELS if fwd else KERNELS
    keys = [f"{n}#{i}" if names.count(n) > 1 else n for i, n in enumerate(names)]  # a variant may repeat
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as root, ThreadPoolExecutor(os.cpu_count()) as ex:
        futs = {(k, kern): ex.submit(build_variant, k.split("#")[0], kern, os.path.join(root, k.replace("#", "_")))
                for k in keys for kern in kernels}
        libs = {key: ctypes.CDLL(f.result()) for key, f in futs.items()}
        print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)
        for (k, kern), lib in libs.items():
            for entry in [kern] + ([kern + "_acc", kern + "_tile"] if fwd else []):
                fn = getattr(lib, f"nequip_{entry}_f32")
                fn.argtypes, fn.restype = build._SIGNATURES[f"nequip_{entry}"], ctypes.c_int
        (run_fwd if fwd else run)(keys, libs)
    return 0


def run(keys, libs) -> None:
    dev = torch.device("cuda")
    dtype = torch.float32
    data, layout, sl, blocks, rng = flagship_inputs()
    N, E = data["pos"].shape[0], data["edge_index"].shape[1]
    lay_s, rows = sl.layout, slice(sl.start, sl.stop)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    sums = {}
    for li, blk in enumerate(blocks):
        plan = blk.tp_scatter.plan
        t = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=dtype, device=dev)  # noqa: E731
        x, sh, g, w = t(N, plan.dim_in), t(E, plan.sh_dim), t(N, plan.mid_dim), t(E, plan.weight_numel)
        tx, tsh, dw, gt = t(N, plan.dim_in), t(E, plan.sh_dim), t(E, plan.weight_numel), t(N, plan.mid_dim)
        tab = plan.device_tables(dev, dtype)
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
            err = getattr(lib, f"nequip_{kern}_f32")(
                *(o.data_ptr() for o in ops), *tabs, *(o.data_ptr() for o in outs), len(plan.paths), n_nodes,
                plan.dim_in, plan.sh_dim, plan.weight_numel, plan.mid_dim, stream())
            if err:
                raise RuntimeError(f"{kern}: cudaError {err}")

        for (k, kern), lib in libs.items():
            rows_out = E if kern == "tri_bwd" else sl.stop - sl.start
            outs = tuple(torch.zeros(rows_out, wd, dtype=dtype, device=dev) for wd in widths[kern])
            rec = dict(variant=k, kernel=kern, layer=li)
            try:
                clk = k.startswith("clocks")
                if clk:
                    lib.cg_zero_clk()
                call(kern, lib, outs)
                torch.cuda.synchronize()
                rec["ok"] = all(bool(((a - b).abs() <= 1e-4 * b.abs() + 1e-5 * float(b.abs().max())).all())
                                for a, b in zip(outs, refs[kern]))
                if clk:
                    buf = (ctypes.c_ulonglong * 8)()
                    lib.cg_read_clk(buf)
                    rec["cycles_per_tile"] = {p: buf[i] / buf[5] for i, p in enumerate(PHASES)}
                rec["ms"] = float(np.median([CS.cuda_median_ms(lambda: call(kern, lib, outs), 10) for _ in range(3)]))
            except RuntimeError as exc:  # a forced shape that does not fit
                rec.update(ok=False, ms=float("nan"), error=str(exc))
            sums.setdefault((k, kern), []).append(rec["ms"])
            print(json.dumps(rec), flush=True)
        del refs
        torch.cuda.empty_cache()
    for (k, kern), ms in sums.items():
        print(f"{kern} {k} f32, sum of 3 layers: {sum(ms):.3f} ms ({', '.join(f'{m:.3f}' for m in ms)})",
              flush=True)


def run_fwd(keys, libs) -> None:
    """K4 on the whole stream, K4-acc and K6 on the second of 4 slices, per
    variant and layer."""
    dev = torch.device("cuda")
    dtype = torch.float32
    data, layout, sl, blocks, rng = flagship_inputs()
    N, E = data["pos"].shape[0], data["edge_index"].shape[1]
    lay_s, rows = sl.layout, slice(sl.start, sl.stop)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    sums, bad = {}, []
    for li, blk in enumerate(blocks):
        plan = blk.tp_scatter.plan
        t = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=dtype, device=dev)  # noqa: E731
        x, sh, w, tx, tsh, dw = (t(N, plan.dim_in), t(E, plan.sh_dim), t(E, plan.weight_numel), t(N, plan.dim_in),
                                 t(E, plan.sh_dim), t(E, plan.weight_numel))
        acc, tacc = t(N, plan.mid_dim), t(N, plan.mid_dim)
        tab = plan.device_tables(dev, dtype)
        tabs = [tab[k].data_ptr() for k in ("fwd_groups", "fwd_terms", "fwd_coef", "fwd_col")]
        n_terms = tab["fwd_coef"].shape[0]
        dims = (n_terms, N, plan.dim_in, plan.sh_dim, plan.weight_numel, plan.mid_dim)
        s_ops = (x, tx, sh[rows], tsh[rows], w[rows], dw[rows], lay_s)
        refs = {"tri_fwd": (K.tri_fwd_plain(plan, x, sh, w, layout),),
                "tri_fwd_acc": (K.tri_fwd_plain(plan, x, sh[rows], w[rows], lay_s, acc.clone()),),
                "jvp_fwd": K.jvp_fwd_plain(plan, *s_ops)}

        def call(entry, lib, outs, carry, tile):
            if entry == "jvp_fwd":
                ops = [x, tx, sh[rows], tsh[rows], w[rows], dw[rows], lay_s.edge_src, lay_s.dst_ptr]
            elif entry == "tri_fwd_acc":
                ops = [x, sh[rows], w[rows], lay_s.edge_src, lay_s.dst_ptr]
            else:
                ops = [x, sh, w, layout.edge_src, layout.dst_ptr]
            err = getattr(lib, f"nequip_{entry}_f32")(
                *(o.data_ptr() for o in ops), *tabs, *(o.data_ptr() for o in outs), carry.data_ptr(), *dims, tile,
                stream())
            if err:
                raise RuntimeError(f"{entry}: cudaError {err}")

        for (k, kern), lib in libs.items():
            tile = getattr(lib, f"nequip_{kern}_tile_f32")(plan.dim_in, plan.sh_dim, plan.weight_numel, n_terms)
            for entry in (("tri_fwd", "tri_fwd_acc") if kern == "tri_fwd" else (kern,)):
                n_carry = K.conv_fwd_carry_rows(layout.n_real if entry == "tri_fwd" else lay_s.n_real, tile)
                carry = torch.empty(n_carry, (2 if kern == "jvp_fwd" else 1) * plan.mid_dim, dtype=dtype, device=dev)
                outs = (tuple(torch.empty(N, plan.mid_dim, dtype=dtype, device=dev) for _ in range(2))
                        if entry == "jvp_fwd" else (acc.clone() if entry == "tri_fwd_acc" else torch.empty_like(acc),))
                rec = dict(variant=k, kernel=entry, layer=li, tile=tile)
                try:
                    clk = k.startswith("clocks")
                    if clk:
                        lib.cg_zero_clk()
                    call(entry, lib, outs, carry, tile)
                    torch.cuda.synchronize()
                    if clk:
                        buf = (ctypes.c_ulonglong * 8)()
                        lib.cg_read_clk(buf)
                        rec["cycles_per_tile"] = {p: buf[i] / buf[5] for i, p in enumerate(FWD_PHASES)}
                    rec["ok"] = all(bool(((a - b).abs() <= 1e-4 * b.abs() + 1e-5 * float(b.abs().max())).all())
                                    for a, b in zip(outs, refs[entry]))
                    rec["ms"] = float(np.median([CS.cuda_median_ms(lambda: call(entry, lib, outs, carry, tile), 10)
                                                 for _ in range(3)]))
                except RuntimeError as exc:  # a forced shape that does not fit
                    rec.update(ok=False, ms=float("nan"), error=str(exc))
                sums.setdefault((k, entry), []).append(rec["ms"])
                if not rec["ok"] and "error" not in rec:
                    bad.append((k, entry, li))
                print(json.dumps(rec), flush=True)
        del refs
        torch.cuda.empty_cache()
    for (k, entry), ms in sums.items():
        print(f"{entry} {k} f32, sum of 3 layers: {sum(ms):.3f} ms ({', '.join(f'{m:.3f}' for m in ms)})",
              flush=True)
    if bad:
        raise SystemExit(f"disagree with plain: {bad}")


if __name__ == "__main__":
    sys.exit(main())
