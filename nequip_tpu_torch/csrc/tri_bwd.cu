// K5: backward of the trilinear convolution (K4), the per-edge cotangents of
// x, y and w for a node cotangent g.
//
// Replaces the TPU kernel nequip_tpu/ops/pallas/tp_scatter.py,
// _backward_kernel_call (kernel body _bwd_kernel_T, CG-VJP block
// _compute_tp_bwd_block_T).  For each edge e (source s, destination n) with
// g = dL/dout[n]:
//   dx_e[x_row + u]  = sum_terms w_e[w_off + u] * c * y_e[yi] * g[out_row + u]
//   A[p, m2, u]      = sum_terms of path p with m2  c * x[s, x_row + u] * g[out_row + u]
//   dw_e[w_off + u]  = sum_m2 y_e[y_off + m2] * A[p, m2, u]
//   dy_e[y_off + m2] = sum_{p, u} w_e[w_off + u] * A[p, m2, u]
// It is K2 (conv_bwd.cu) without the radial MLP: w is read from an [E, WN]
// buffer and dw is written out per edge.  dx_e goes to an [E, dim_in]
// buffer that K3 (scatter_rows.cu) sums onto the source nodes; masked slots
// are never visited (the wrapper zeroes their rows).
//
// What bounds it on an H100: bytes, the x[src] gather, the w read and the
// dx_e and dw_e writes (419,904 x (2 x 288 + 2 x 352) x 4 B ~ 2.1 GB in
// layer 1 at 23k atoms, f32), ~0.6 ms at HBM rate.
// The first design (PR 2) took one block per destination node, 8 edges a
// step: ~18-edge segments left its steps 75% full, with three barriers a
// step, element-wise copies serialised with the compute, and a 9-way
// predicated select per CG term; 7.5 ms over the flagship's three layers.
// Design (dense edge tiles, as K1 and K2):
// - A block takes TILE = 32 consecutive real slots of the dst-sorted stream,
//   across node boundaries, on a persistent grid of (SMs x resident blocks)
//   (dense_tiles.cuh); n_real = dst_ptr[n_nodes] is read on the card, so an
//   edge slice of the fr sweep (its own dst_ptr, relative to its start) is
//   the same case.  One warp finds the tile's destinations (tile_dst).
// - The tile's x[src] rows, y rows and w rows come into shared memory by
//   cp.async in 16-byte copies; an operand whose base is not 16-byte
//   aligned (y = sh[rows] of an fr slice starts start x 9 values in) is
//   placed at its own 16-byte phase, so its body still moves in 16-byte
//   copies with element copies at the ends (stage_flat).  Where two tiles
//   fit with two blocks an SM (layers 0 and 2), the next tile's rows load
//   while this one computes.  When the tile's destinations span at most
//   kGRows nodes (nearly always: ~18 edges a node) their g rows are staged
//   too, else g is read through L1.
// - The CG-VJP is cg_vjp.cuh's, shared with K2 and K7: dx over (8-edge
//   group, 32-column block) items, then dW_e (in place of w) and the dy
//   partials over (8-edge group, path) items on m2 runs, the items dealt to
//   the warps heaviest path first, each run's partials summed over the
//   channels by a reduce-scatter (9 shuffles for 8 edges), then dy in path
//   order; a g value is loaded once for the 8 edges of an item that share a
//   destination.
// - dW_e and dy leave as contiguous ranges of the tile's rows in 16-byte
//   stores, dx_e as one 128-byte row segment per warp.
// - Every output element is written by one thread from sums in a fixed
//   order, without atomics: two calls give bitwise equal results.
// Shared memory (f32, 32-edge tile): layer 1 109 KB (w 45 KB, x rows 36.9,
// y 1.2, dy partials 12.7, 3 g rows 13.4), two blocks an SM; layers 0 and 2
// double-buffered; f64 of layer 1 16-edge tiles.  Registers (nvcc -Xptxas
// -v): 128 for two blocks an SM, 157-202 for one, no spills.
// Measured (H100 80GB HBM3, 700 W; PERF.md, PR 9): f32 0.52 / 2.14 / 0.79 ms
// for the three layers in chip_smoke.py's phase 2, 3.7x the bound (7.50 ms
// before).  clock64 marks (chip_cg_profile.py, layer 1, cycles per tile of
// one block, two blocks an SM): staging 10.0k, dx 24.1k, dW_e and dy
// partials 34.7k, dy 5.5k, stores 1.2k (stall reasons inside a phase are
// not measured: ncu does not run on the card's machine).  An L2 prefetch
// of the next tile, deeper unrolling, 4-edge items and 16-edge tiles were
// no faster (PERF.md).
//
// bf16 (nequip_tri_bwd_bf16, the fast mode's forces on the fused_tp route
// and the bf16 fr sweep's K4 backward): x, y, w and g are bf16 in device
// memory, and so are dx_e, dy and dw.  Every product and sum runs in
// float32 and each output element is rounded once, on its store; K3 then
// sums dx_e onto the sources in its canonical per-source order.  The plain
// version (tp_scatter.tri_bwd_plain) rounds at the same points.  Design (the
// first bf16 form ran the f32 design on float32 tiles, each operand widened
// by plain loads as it was staged, which lost cp.async's overlap):
// - The operand tiles stay bf16 in shared memory: w, y, the x[src] rows and
//   the staged g rows come in raw by 16-byte cp.async (stage_flat,
//   stage_rows on the storage type), and cg_vjp.cuh reads tiles of storage
//   type S, widening each value in registers where the CG-VJP reads it.  The
//   dy partials stay float32.
// - The 16-byte phase: a row of y is 9 values (18 B), so an fr slice's y =
//   sh[rows] starts at any 2-byte phase.  tri_bwd_smem counts in elements
//   of S (V = 16 / sizeof(S): 8-value phases), and stage_flat copies the at
//   most 14 values outside the 16-byte body by plain 2-byte copies
//   (cp.async has no 2-byte form), issued after the body's copies.
// - dW_e is rounded once to bf16 and written in place of the tile's w row
//   (by the thread that read that w value last; dx has read w by then), and
//   leaves by 16-byte stores.  Two calls give bitwise equal results.
// - Shared memory (32-edge tile, layer 1): a stage is w 22.5 + x 18.4 + y
//   0.6 KB, with the dy partials (12.7) and 3 g rows (6.7) 61.2 KB single-
//   buffered or 102.7 double-buffered; both fit two blocks an SM.  The
//   launch shape is chosen by measurement (chip_cg_profile.py --dtype bf16,
//   the three layers summed, H100 80GB HBM3, 700 W): 32-edge tiles, single-
//   buffered, two blocks of 256 threads an SM, 2.983 ms; double-buffered
//   3.122-3.149 (layer 1 2.06 against 1.93 ms; its larger shared memory
//   leaves L1 less room for the term tables and the g rows read through
//   it, a reading the card's tools cannot confirm); 128-thread blocks two
//   an SM 3.034, three an SM 3.124, 16-edge tiles 3.28-4.04.  Registers:
//   124 at two blocks an SM, 126 (32- and 16-edge tiles) and 151 (8-edge)
//   at one, no spills.
// Measured (chip_cg_profile.py --dtype bf16 --parent: the float32-tile form,
// built from the previous commit's sources, in turns in one process; H100
// 80GB HBM3, 700 W): 3.512 -> 3.055 ms over the three layers, at or below
// f32's in the same call (PERF.md); layer 1 cycles per tile of one block: staging 19.4k ->
// 7.4k, dx 23.1k -> 23.7k, dW_e and dy partials 35.2k -> 34.2k, dy 4.6k ->
// 5.5k, stores 0.9k -> 0.8k.  The CG-VJP phases, about 80% of the tile,
// are f32's, plus one widening instruction a value read.
#include "cg_vjp.cuh"
#include "dense_tiles.cuh"

namespace nequip {
namespace {

constexpr int kCgEdges = 8;  // edges of one CG-VJP item
constexpr int kGRows = 3;    // g rows staged for a tile whose destinations span at most this many nodes

// S: the storage type of the operands and outputs; the kernel computes in
// T = Acc<S> (tp_common.cuh), the type of the tables
template <typename S>
struct TriBwdArgs {
  using T = Acc<S>;
  const S *x, *y, *w;
  const int32_t *edge_src, *dst_ptr;
  const S* g;
  cg::Tables<T> tab;
  S *dx_edge, *dy, *dw;
  int n_nodes, dim_in, sh_dim, wn, mid_dim;
  int g_rows;  // g rows the shared memory holds: kGRows, or 0 where they do not fit
};

// Shared-memory carve-up, in elements of S (the operand tiles' storage
// type): STAGES buffers of (w, y with room for a 16-byte phase, x rows), the
// dy partials (T = Acc<S>), g_rows g rows, then int32 [TILE + 1 + n_paths]
// (the destinations, the first staged node and the paths' order).
struct TriBwdSmem {
  int o_y, o_x, stage, o_part, o_g, o_dst;
  size_t bytes;
};

template <typename T, typename S = T>
__host__ __device__ inline TriBwdSmem tri_bwd_smem(int tile, int stages, int dim_in, int sh_dim, int wn,
                                                   int n_paths, int mid_dim, int g_rows) {
  constexpr int V = 16 / sizeof(S);
  auto up = [](int a) { return (a + V - 1) / V * V; };
  TriBwdSmem L;
  L.o_y = up(tile * wn + V - 1);
  L.o_x = L.o_y + up(tile * sh_dim + V - 1);
  L.stage = L.o_x + up(tile * dim_in);
  L.o_part = stages * L.stage;
  L.o_g = L.o_part + up(tile * n_paths * kMaxYDim * static_cast<int>(sizeof(T) / sizeof(S)));
  L.o_dst = L.o_g + up(g_rows * mid_dim + V - 1);
  L.bytes = static_cast<size_t>(L.o_dst) * sizeof(S) + sizeof(int32_t) * (tile + 1 + n_paths);
  return L;
}

template <typename S, int TILE, int STAGES, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS) tri_bwd_kernel(const TriBwdArgs<S> a) {
  using T = Acc<S>;  // registers, sums and the dy partials; the operand tiles are S
  constexpr int NT = kThreads, NW = NT / 32, TC = TILE < kCgEdges ? TILE : kCgEdges;
  static_assert(TILE <= 32 && TILE % TC == 0 && (STAGES == 1 || STAGES == 2), "one warp finds the destinations");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dim_in = a.dim_in, sh_dim = a.sh_dim, wn = a.wn, mid_dim = a.mid_dim;
  const TriBwdSmem L = tri_bwd_smem<T, S>(TILE, STAGES, dim_in, sh_dim, wn, a.tab.n_paths, mid_dim, a.g_rows);
  S* base_s = reinterpret_cast<S*>(smem_raw);
  T* s_part = reinterpret_cast<T*>(base_s + L.o_part);            // [TILE][n_paths][kMaxYDim]
  S* s_g = base_s + L.o_g;                                        // [g_rows][mid_dim]
  int32_t* s_dst = reinterpret_cast<int32_t*>(base_s + L.o_dst);  // [TILE]
  int32_t* s_g0 = s_dst + TILE;  // the first node of the staged g rows, -1 if g is read from global memory
  int32_t* s_order = s_g0 + 1;   // [n_paths], heaviest first (cg::order_paths)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_real = __ldg(a.dst_ptr + a.n_nodes);
  const int n_tiles = (n_real + TILE - 1) / TILE;
  if (static_cast<int>(blockIdx.x) >= n_tiles) return;

  // starts the copies of a tile's w, y and x[src] rows into buffer buf
  auto stage = [&](int tile, int buf) {
    const int base = tile * TILE, cnt = min(TILE, n_real - base);
    S* sb = base_s + buf * L.stage;
    stage_flat<S, NT>(sb, a.w + static_cast<int64_t>(base) * wn, cnt * wn, TILE * wn, tid);
    stage_flat<S, NT>(sb + L.o_y, a.y + static_cast<int64_t>(base) * sh_dim, cnt * sh_dim, TILE * sh_dim, tid);
    stage_rows<S, TILE, NT>(sb + L.o_x, a.x, a.edge_src + base, cnt, dim_in, tid);
    cp_async_commit();
  };
  cg::order_paths(a.tab, s_order);  // the loop's first barrier publishes it
  if (STAGES == 2) stage(blockIdx.x, 0);

  for (int tile = blockIdx.x, it = 0; tile < n_tiles; tile += gridDim.x, ++it) {
    const int base = tile * TILE, cnt = min(TILE, n_real - base);
    const int buf = STAGES == 2 ? (it & 1) : 0;
    __syncthreads();  // the previous tile's readers are done
    if (warp == 0) {  // the destinations, and their g rows if they span at most g_rows nodes (one more group)
      const int d = tile_dst(a.dst_ptr, a.n_nodes, base, cnt);
      const int d0 = __shfl_sync(0xffffffffu, d, 0), d1 = __shfl_sync(0xffffffffu, d, cnt - 1);
      if (lane < TILE) s_dst[lane] = d < 0 ? d1 : d;  // sorted; rows past cnt compute values not written
      const bool staged = d1 - d0 < a.g_rows;
      if (staged) {
        stage_flat<S, 32>(s_g, a.g + static_cast<int64_t>(d0) * mid_dim, (d1 - d0 + 1) * mid_dim, 0, lane);
        cp_async_commit();
      }
      if (lane == 0) *s_g0 = staged ? d0 : -1;
    }
    if (STAGES == 2) {
      if (tile + static_cast<int>(gridDim.x) < n_tiles)
        stage(tile + gridDim.x, buf ^ 1);
      else
        cp_async_commit();  // an empty group: the wait below counts one group ahead
      cp_async_wait<1>();
    } else {
      stage(tile, 0);
    }
    for (int i = tid; i < TILE * a.tab.n_paths * kMaxYDim; i += NT) s_part[i] = T(0);
    if (STAGES == 1) cp_async_wait<0>();
    __syncthreads();

    S* sb = base_s + buf * L.stage;
    S* s_w = sb + staged_phase<S>(a.w + static_cast<int64_t>(base) * wn);  // [TILE][wn]
    const S* s_y = sb + L.o_y + staged_phase<S>(a.y + static_cast<int64_t>(base) * sh_dim);  // [TILE][sh_dim]
    const S* s_x = sb + L.o_x;                                               // [TILE][dim_in]
    auto cg_vjp = [&](auto gr) {
      cg::dx_items<T, TILE, TC, NW>(a.tab, gr, s_dst, s_y, sh_dim, s_w, wn, cnt, dim_in,
                                    a.dx_edge + static_cast<int64_t>(base) * dim_in);
      __syncthreads();  // dx has read w
      cg::dw_items<T, TILE, TC, NW>(a.tab, s_order, cg::XRows<T, true, S>{s_x, nullptr, dim_in}, gr, s_dst, s_y,
                                    sh_dim, s_w, wn, cnt, s_part, nullptr, wn);
    };
    const int g0 = *s_g0;  // block-uniform
    if (g0 >= 0)
      cg_vjp(cg::GRows<T, true, S>{s_g + staged_phase<S>(a.g + static_cast<int64_t>(g0) * mid_dim), g0, mid_dim});
    else
      cg_vjp(cg::GRows<T, false, S>{a.g, 0, mid_dim});
    __syncthreads();
    cg::path_sum<T, NT>(a.tab, s_part, cnt, sh_dim, a.dy + static_cast<int64_t>(base) * sh_dim);
    store_flat<S, NT>(a.dw + static_cast<int64_t>(base) * wn, s_w, cnt * wn, tid);
  }
}

template <typename S, int TILE, int STAGES, int MIN_BLOCKS>
cudaError_t launch_tile(const TriBwdArgs<S>& args, int dev, size_t smem, cudaStream_t stream) {
  auto kernel = tri_bwd_kernel<S, TILE, STAGES, MIN_BLOCKS>;
  int grid = 0;
  const cudaError_t err = persistent_grid(kernel, kThreads, dev, smem, grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

// The first shape whose shared memory fits: two blocks an SM before one,
// 32-edge tiles before 16 and 8, double-buffered before single (f32, f64;
// bf16 takes single-buffered tiles, measured faster), each with kGRows
// staged g rows before none.
template <typename S>
int launch_tri_bwd(TriBwdArgs<S> a, void* stream) {
  using T = Acc<S>;
  if (a.n_nodes <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t rows = a.n_nodes + 1;  // g offsets are int32
  if (rows * a.mid_dim >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  SmemLimits lim;
  const cudaError_t err = smem_limits(lim);
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t smem = 0;  // the bytes of the shape fits() accepted last
  auto fits = [&](int tile, int stages, int blocks) {
    for (const int g_rows : {kGRows, 0}) {
      a.g_rows = g_rows;
      smem = tri_bwd_smem<T, S>(tile, stages, a.dim_in, a.sh_dim, a.wn, a.tab.n_paths, a.mid_dim, g_rows).bytes;
      if (lim.fit(smem, blocks)) return true;
    }
    return false;
  };
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same<S, T>::value) {
    if (fits(32, 2, 2)) return static_cast<int>(launch_tile<S, 32, 2, 2>(a, lim.dev, smem, s));
  }
  cudaError_t e;
  if (fits(32, 1, 2)) e = launch_tile<S, 32, 1, 2>(a, lim.dev, smem, s);
  else if (fits(16, 1, 2)) e = launch_tile<S, 16, 1, 2>(a, lim.dev, smem, s);
  else if (fits(32, 1, 1)) e = launch_tile<S, 32, 1, 1>(a, lim.dev, smem, s);
  else if (fits(16, 1, 1)) e = launch_tile<S, 16, 1, 1>(a, lim.dev, smem, s);
  else {
    fits(8, 1, 1);  // the smallest shape, without g rows: refused at launch if it does not fit
    e = launch_tile<S, 8, 1, 1>(a, lim.dev, smem, s);
  }
  return static_cast<int>(e);
}

}  // namespace
}  // namespace nequip

#define NEQUIP_TRI_BWD(SUFFIX, T)                                                                              \
  extern "C" int nequip_tri_bwd_##SUFFIX(                                                                     \
      const void* x, const void* y, const void* w, const void* edge_src, const void* dst_ptr, const void* g,  \
      const void* dx_groups, const void* dx_terms, const void* dx_coef, const void* dx_col_group,             \
      const void* paths, const void* path_terms, const void* path_coef, void* dx_edge, void* dy, void* dw,    \
      int n_paths, int n_nodes, int dim_in, int sh_dim, int wn, int mid_dim, void* stream) {                  \
    using A = nequip::Acc<T>;                                                                                 \
    const nequip::TriBwdArgs<T> args{                                                                         \
        static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const T*>(w),                         \
        static_cast<const int32_t*>(edge_src), static_cast<const int32_t*>(dst_ptr), static_cast<const T*>(g), \
        {static_cast<const int32_t*>(dx_groups), static_cast<const int32_t*>(dx_terms),                       \
         static_cast<const A*>(dx_coef), static_cast<const int32_t*>(dx_col_group),                           \
         static_cast<const int32_t*>(paths), static_cast<const int32_t*>(path_terms),                         \
         static_cast<const A*>(path_coef), n_paths},                                                          \
        static_cast<T*>(dx_edge), static_cast<T*>(dy), static_cast<T*>(dw),                                   \
        n_nodes, dim_in, sh_dim, wn, mid_dim, 0};                                                                \
    return nequip::launch_tri_bwd<T>(args, stream);                                                           \
  }

NEQUIP_TRI_BWD(f32, float)
NEQUIP_TRI_BWD(f64, double)
NEQUIP_TRI_BWD(bf16, __nv_bfloat16)
