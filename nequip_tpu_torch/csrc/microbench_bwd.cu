// T2 and T4: the conv-block microbenchmark backward, the CG-VJP of one
// constant chunk of `be` edges computed `grid` times.
//
// Replaces the TPU kernels tools/kernel_microbench.py, make_bwd (T2, row
// layout, pallas_call at :189, block _compute_tp_bwd_block) and make_bwd_t
// (T4, feature-major layout, :313, block _compute_tp_bwd_block_T).  For the
// cotangent g of msg = TP(x, y, w), per edge e:
//   dx_e[x_row + u]  = sum_terms w_e[w_off + u] * c * y_e[yi] * g_e[out_row + u]
//   A[p, m2, u]      = sum_terms of path p with m2  c * x_e[x_row + u] * g_e[out_row + u]
//   dw_e[w_off + u]  = sum_m2 y_e[y_off + m2] * A[p, m2, u]
//   dy_e[y_off + m2] = sum_{p, u} w_e[w_off + u] * A[p, m2, u]
// Every step recomputes (dx, dy, dw) of the whole chunk, as each TPU step
// zeroes and rewrites its dx/dy outputs and its dw scratch.  Row layout:
// operands and results [be, width]; feature-major: [width, be].
//
// What bounds it on an H100: operations; at the tool's defaults 2048 steps
// x 256 edges x (7 x 2784 + 4 x 1056) ~ 12.4 GFLOP, 0.19 ms at 67 TFLOP/s
// f32 (the chunk is read once and the results written once).  Below that
// lies a shared-memory floor: the CG-VJP reads ~5 operands from shared
// memory (or L1) per term, channel and edge, ~590 warp-wide loads an edge
// and step with the term tables, ~1.3 ms at one load a clock on each of
// 132 SMs.  The first design took 13.7 ms (row) and 14.7 ms (feature-major):
// 8-edge tiles re-staged every step, per-edge loops with a 9-way select per
// term, and 1.2 GB of per-step results written to device memory.
// Design (K5's CG-VJP on a resident tile):
// - A grid of (step range, edge tile) blocks, block b taking tile b %
//   n_tiles and range b / n_tiles: the ranges split the `grid` steps into
//   n_ranges runs of consecutive steps, as many as fill the card's resident
//   blocks (ops/kernels/microbench.py, bwd_ranges;
//   tests/test_torch_port_microbench_bwd.py models this map).
// - A block stages its tile's x, y, g and w rows once by cp.async (16-byte
//   copies for the row layout, element copies that transpose a feature
//   row's run of the tile's edges as they land for the feature-major one)
//   and keeps them for all its steps.  The term tables stay in L1, read as
//   cg_vjp.cuh reads them.
// - Each step runs cg_vjp.cuh's CG-VJP, the code of K2, K5 and K7:
//   dx_items into a dx tile, then dw_items (paths dealt heaviest first)
//   into the dy partials, then path_sum into a dy tile.  Every edge has its
//   own g row, so an item takes the many-destination form.  dw_items writes
//   dW_e over its w rows, so the block works on a copy of w that it
//   restores from the kept rows after each step; dW_e is that copy at a
//   step's end.  The partials alternate between two buffers, so a step
//   takes three barriers.
// - dx, dy and dW_e of a step stay in shared memory, where the next step
//   overwrites them; the block of a tile's last step range writes them out
//   once (transposed for the feature-major layout).
// - Every sum runs in a fixed order, so two calls are bitwise equal.
// - Blocks of four warps, three an SM (12 step ranges, 384 blocks at the
//   tool's defaults): a step's 9 dx and 9 dW items (one 8-edge group each,
//   paths of 1 to 25 terms) leave warps idle at each barrier, and more
//   blocks of fewer warps fill those gaps (eight warps, two an SM: 3.0 ms).
// Shared memory (f32, 8-edge tile, the tool's widths): x 9.2 KB, g 31.7,
// w and its copy 18.4, y 0.3, dx 9.2, dy 0.3, partials 5.2: 74.5 KB.
// Registers (nvcc -Xptxas -v): f32 168 (row) and 128 (feature-major), no
// spills; f64 (one block an SM) 234 and 190.
// Measured (H100 80GB HBM3, 700 W; chip_smoke.py phase 8a and
// chip_mb_profile.py --bwd; PERF.md, T2/T4): 2.7 ms row-major and
// feature-major, 1.33 us a chunk (the first design: 6.8).  Clock marks,
// cycles a tile-step of thread 0 with three blocks an SM: dx_items 9.3K,
// dw_items 15.0K (its 25-term path on one warp), path_sum 3.6K (one warp's
// threads), restoring w 0.7K; staging 18.5K (T4: 33K) once a block.
// 4-edge items (3.56 ms) and g read through L1 at four blocks an SM (3.19)
// were slower.
#include "cg_vjp.cuh"
#include "dense_tiles.cuh"

namespace nequip {
namespace mb {

constexpr int kBwdTile = 8;      // edges a tile (microbench.py's BWD_TILE)
constexpr int kBwdEdges = 8;     // edges of one CG-VJP item
constexpr int kBwdThreads = 128; // threads a block: four warps
template <typename T>
constexpr int kBwdMinBlocks = sizeof(T) == 4 ? 3 : 1;  // resident blocks an SM the registers are sized for

template <typename T>
struct BwdArgs {
  const T *x, *y, *g, *w;
  cg::Tables<T> tab;
  T *dx, *dy, *dw;
  int be, dim_in, sh_dim, wn, mid_dim, grid, n_ranges;
};

// The shared-memory carve-up in elements of T (microbench.py's bwd_smem
// mirrors it), every region 16-byte aligned: the staged x rows (from 0), g
// rows, the kept w rows, the working copy of w and the y rows, each with
// room for a 16-byte phase; the dx and dy tiles; two buffers of dy partials
// [TILE][n_paths][kMaxYDim]; then int32 [TILE + n_paths], each edge's g row
// and the paths' order.
struct BwdSmem {
  int o_g, o_w0, o_w, o_y, o_dx, o_dy, o_part, part, o_int;
  size_t bytes;
};

template <typename T>
__host__ __device__ inline BwdSmem bwd_smem(int tile, int dim_in, int sh_dim, int wn, int mid_dim, int n_paths) {
  constexpr int V = 16 / sizeof(T);
  auto up = [](int a) { return (a + V - 1) / V * V; };
  BwdSmem L;
  L.o_g = up(tile * dim_in + V - 1);
  L.o_w0 = L.o_g + up(tile * mid_dim + V - 1);
  L.o_w = L.o_w0 + up(tile * wn + V - 1);
  L.o_y = L.o_w + up(tile * wn + V - 1);
  L.o_dx = L.o_y + up(tile * sh_dim + V - 1);
  L.o_dy = L.o_dx + up(tile * dim_in);
  L.o_part = L.o_dy + up(tile * sh_dim);
  L.part = up(tile * n_paths * kMaxYDim);
  L.o_int = L.o_part + 2 * L.part;
  L.bytes = static_cast<size_t>(L.o_int) * sizeof(T) + sizeof(int32_t) * (tile + n_paths);
  return L;
}

// Starts the copies of the edges base .. base + cnt of a [be, width] (row
// layout) or [width, be] (feature-major) operand into the rows dst
// [TILE][width], zero past cnt; returns the phase at which the rows land.
template <typename T, bool kT, int TILE, int NT>
__device__ __forceinline__ int stage_tile(T* dst, const T* __restrict__ src, int base, int cnt, int width, int be,
                                          int tid) {
  if constexpr (!kT) {
    const T* rows = src + static_cast<int64_t>(base) * width;
    stage_flat<T, NT>(dst, rows, cnt * width, TILE * width, tid);
    return phase16(rows);
  } else {
    for (int i = tid; i < TILE * width; i += NT) {  // TILE lanes read one feature's run of edges
      const int c = i / TILE, e = i - c * TILE;
      const bool ok = e < cnt;
      cp_async_elem<sizeof(T)>(dst + e * width + c, src + (ok ? static_cast<int64_t>(c) * be + base + e : 0), ok);
    }
    return 0;
  }
}

// The rows src [TILE][width] of the edges base .. base + cnt into a [be,
// width] or [width, be] output.
template <typename T, bool kT, int TILE, int NT>
__device__ __forceinline__ void store_tile(T* __restrict__ dst, const T* src, int base, int cnt, int width, int be,
                                           int tid) {
  if constexpr (!kT) {
    store_flat<T, NT>(dst + static_cast<int64_t>(base) * width, src, cnt * width, tid);
  } else {
    for (int i = tid; i < TILE * width; i += NT) {
      const int c = i / TILE, e = i - c * TILE;
      if (e < cnt) dst[static_cast<int64_t>(c) * be + base + e] = src[e * width + c];
    }
  }
}

template <typename T, bool kT>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks<T>) mb_bwd_kernel(const BwdArgs<T> a) {
  constexpr int NT = kBwdThreads, NW = NT / 32, TILE = kBwdTile, TC = kBwdEdges, V = 16 / sizeof(T);
  static_assert(TILE % TC == 0 && TILE <= NT, "whole CG-VJP items");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dim_in = a.dim_in, sh_dim = a.sh_dim, wn = a.wn, mid_dim = a.mid_dim, be = a.be;
  const BwdSmem L = bwd_smem<T>(TILE, dim_in, sh_dim, wn, mid_dim, a.tab.n_paths);
  T* sm = reinterpret_cast<T*>(smem_raw);
  int32_t* s_dst = reinterpret_cast<int32_t*>(sm + L.o_int);  // [TILE]: edge e reads g row e
  int32_t* s_order = s_dst + TILE;                             // [n_paths], heaviest first (cg::order_paths)
  const int tid = threadIdx.x;
  const int n_tiles = (be + TILE - 1) / TILE;
  const int tile = blockIdx.x % n_tiles, range = blockIdx.x / n_tiles;
  const int base = tile * TILE, cnt = min(TILE, be - base);
  const int step0 = static_cast<int>(static_cast<int64_t>(range) * a.grid / a.n_ranges);
  const int step1 = static_cast<int>(static_cast<int64_t>(range + 1) * a.grid / a.n_ranges);

  // the tile, once: w twice (the kept rows and the first step's copy)
  const int ph_x = stage_tile<T, kT, TILE, NT>(sm, a.x, base, cnt, dim_in, be, tid);
  const int ph_g = stage_tile<T, kT, TILE, NT>(sm + L.o_g, a.g, base, cnt, mid_dim, be, tid);
  const int ph_w = stage_tile<T, kT, TILE, NT>(sm + L.o_w0, a.w, base, cnt, wn, be, tid);
  stage_tile<T, kT, TILE, NT>(sm + L.o_w, a.w, base, cnt, wn, be, tid);
  const int ph_y = stage_tile<T, kT, TILE, NT>(sm + L.o_y, a.y, base, cnt, sh_dim, be, tid);
  cp_async_commit();
  if (tid < TILE) s_dst[tid] = tid;
  cg::order_paths(a.tab, s_order);
  T* s_part = sm + L.o_part;
  for (int i = tid; i < L.part; i += NT) s_part[i] = T(0);
  cp_async_wait<0>();
  __syncthreads();

  const cg::XRows<T, true> xr{sm + ph_x, nullptr, dim_in};
  const cg::GRows<T, true> gr{sm + L.o_g + ph_g, 0, mid_dim};
  const T* s_y = sm + L.o_y + ph_y;
  T* s_w = sm + L.o_w + ph_w;  // w at a step's start, dW_e at its end
  T* s_dx = sm + L.o_dx;
  T* s_dy = sm + L.o_dy;
  for (int step = step0; step < step1; ++step) {
    T* part = s_part + ((step - step0) & 1) * L.part;
    cg::dx_items<T, TILE, TC, NW>(a.tab, gr, s_dst, s_y, sh_dim, s_w, wn, cnt, dim_in, s_dx);
    __syncthreads();  // dx has read w
    cg::dw_items<T, TILE, TC, NW>(a.tab, s_order, xr, gr, s_dst, s_y, sh_dim, s_w, wn, cnt, part, nullptr, wn);
    __syncthreads();
    cg::path_sum<T, NT>(a.tab, part, cnt, sh_dim, s_dy);
    if (step + 1 < step1) {  // the next step's w and zero partials (the other buffer, read a step ago)
      T* next = s_part + ((step + 1 - step0) & 1) * L.part;
      for (int i = tid; i < L.part; i += NT) next[i] = T(0);
      for (int j = tid * V; j < L.o_y - L.o_w; j += NT * V) {  // whole regions, 16-byte aligned
        T v[V];
        load16(v, sm + L.o_w0 + j);
        store16(sm + L.o_w + j, v);
      }
    }
    __syncthreads();
  }
  if (range == a.n_ranges - 1) {  // the tile's last step: its results, once
    store_tile<T, kT, TILE, NT>(a.dx, s_dx, base, cnt, dim_in, be, tid);
    store_tile<T, kT, TILE, NT>(a.dy, s_dy, base, cnt, sh_dim, be, tid);
    store_tile<T, kT, TILE, NT>(a.dw, s_w, base, cnt, wn, be, tid);
  }
}

// Blocks of the layout's kernel at `smem` bytes resident on one SM at once
// (the wrapper sizes the step ranges by it); a CUDA error as -err.
template <typename T>
int mb_bwd_blocks(int smem, int layout_t) {
  auto query = [&](auto kernel) {
    int n = 0;
    cudaError_t err = allow_dynamic_smem(kernel, smem);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kBwdThreads, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // leave no error set for the next launch
      return -static_cast<int>(err);
    }
    return n;
  };
  return layout_t ? query(mb_bwd_kernel<T, true>) : query(mb_bwd_kernel<T, false>);
}

// The grid of n_tiles x n_ranges blocks at the wrapper's shared memory,
// which must be bwd_smem's.
template <typename T>
int launch_mb_bwd(const BwdArgs<T>& a, int smem, int layout_t, void* stream) {
  const BwdSmem L = bwd_smem<T>(kBwdTile, a.dim_in, a.sh_dim, a.wn, a.mid_dim, a.tab.n_paths);
  if (a.be <= 0 || a.be % 8 != 0 || a.n_ranges < 1 || a.n_ranges > a.grid || static_cast<size_t>(smem) != L.bytes)
    return cudaErrorInvalidValue;
  const int n_blocks = (a.be + kBwdTile - 1) / kBwdTile * a.n_ranges;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel) {
    const cudaError_t err = allow_dynamic_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<n_blocks, kBwdThreads, smem, s>>>(a);
    return cudaGetLastError();
  };
  return static_cast<int>(layout_t ? launch(mb_bwd_kernel<T, true>) : launch(mb_bwd_kernel<T, false>));
}

}  // namespace mb
}  // namespace nequip

#define NEQUIP_MB_BWD(SUFFIX, T)                                                                                  \
  extern "C" int nequip_mb_bwd_blocks_##SUFFIX(int smem, int layout_t) {                                         \
    return nequip::mb::mb_bwd_blocks<T>(smem, layout_t);                                                         \
  }                                                                                                              \
  extern "C" int nequip_mb_bwd_##SUFFIX(                                                                         \
      const void* x, const void* y, const void* g, const void* w, const void* dx_groups, const void* dx_terms,  \
      const void* dx_coef, const void* dx_col_group, const void* paths, const void* path_terms,                  \
      const void* path_coef, void* dx, void* dy, void* dw, int n_paths, int be, int dim_in, int sh_dim, int wn,  \
      int mid_dim, int grid, int n_ranges, int smem, int layout_t, void* stream) {                               \
    const nequip::mb::BwdArgs<T> a{                                                                              \
        static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const T*>(g), static_cast<const T*>(w),  \
        {static_cast<const int32_t*>(dx_groups), static_cast<const int32_t*>(dx_terms),                          \
         static_cast<const T*>(dx_coef), static_cast<const int32_t*>(dx_col_group),                              \
         static_cast<const int32_t*>(paths), static_cast<const int32_t*>(path_terms),                            \
         static_cast<const T*>(path_coef), n_paths},                                                             \
        static_cast<T*>(dx), static_cast<T*>(dy), static_cast<T*>(dw), be, dim_in, sh_dim, wn, mid_dim, grid,    \
        n_ranges};                                                                                               \
    return nequip::mb::launch_mb_bwd<T>(a, smem, layout_t, stream);                                              \
  }

NEQUIP_MB_BWD(f32, float)
NEQUIP_MB_BWD(f64, double)
