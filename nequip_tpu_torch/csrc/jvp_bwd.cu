// K7: backward of the fr dual sweep (K6), the per-edge cotangents of all six
// operands for the node cotangents g of msg and gt of tmsg.
//
// Replaces the TPU kernel nequip_tpu/ops/pallas/tp_scatter.py,
// _jvp_backward_kernel_call (kernel body _jvp_bwd_kernel_T, CG-VJP block
// _compute_tp_jvp_bwd_block_T, pallas_call at :2306).  For each edge e
// (source s, destination n), with g = g[n] and gt = gt[n], the twelve VJP
// pieces of the four trilinear terms factor through six families, per CG
// term (path p, m1, m2, m3, c) and channel u:
//   P1 = c x g, P2 = c x gt, P3 = c tx gt   (summed per SH component m2)
//   Q1 = c y g, Q2 = c y gt, Q3 = c ty gt   (summed per feature row m1)
// and
//   dx_e  = w (Q1 + Q3) + dw Q2     dtx_e = w Q2
//   dy_e  = sum_u w (P1 + P3) + dw P2     dty_e = sum_u w P2
//   cw_e  = sum_m2 y (P1 + P3) + ty P2    cdw_e = sum_m2 y P2
// (x, tx read at the source s; w, dw at the path's weight column u).  The
// three x-cotangent terms are summed here, so one K3 row scatter gives the
// node dx (and one more dtx), as in the JAX kernel.  cw/cdw are the
// cotangents of the radial weights and of their tangent; the caller reverses
// them through the radial MLP's jvp.
//
// What bounds it on an H100: bytes, the x/tx gathers and w/dw reads plus the
// six per-edge outputs (4 x 288 + 4 x 352 + 4 x 9 values an edge of layer 1,
// f32); one of the fr sweep's 4 slices of the 23k-atom stream moves ~1.1 GB
// there.
// The first design (PR 3) was K5's first: one block per destination node, 8
// edges a step, with three accumulator arrays under a 9-way select.
// Design: K5's (tri_bwd.cu) with two of every operand.  Dense tiles of TILE
// consecutive real slots of the slice's dst-sorted stream on a persistent
// grid (dense_tiles.cuh), destinations by one warp (tile_dst); the tile's
// x[src] and tx[src] rows, y, ty, w and dw rows staged by cp.async (rows of
// an operand whose base is not 16-byte aligned, as sh[rows] of a slice, at
// the source's 16-byte phase); g and gt rows are read through L1 (staging
// them, as K5 does, was no faster here).  The three-family CG-VJP of
// cg_vjp.cuh: dx and dtx over (4-edge group, 32-column block) items, then
// cw, cdw (in place of w, dw) and the dy/dty partials over (4-edge group,
// path) items on m2 runs, reduce-scattered over the channels, then dy and
// dty in path order; cw, cdw, dy and dty leave in 16-byte stores.  No
// atomics, a fixed order of every sum: bitwise repeatable.  4-edge items
// keep the three families in 128 registers without spilling (8-edge items
// spill, PERF.md).
// Shared memory (f32, layer 1): a 32-edge tile needs ~191 KB, one block an
// SM; 16-edge tiles (96 KB) let two blocks share an SM and are taken.  f64
// of layer 1 takes 8-edge tiles, 4-edge ones only models wider than the
// flagship.  Registers (nvcc -Xptxas -v): 128 for two blocks an SM, 157-207
// for one, no spills.
// Measured (H100 80GB HBM3, 700 W; PERF.md, PR 9): f32 on one of 4 slices
// 0.30 / 1.25 / 0.39 ms for the three layers in chip_smoke.py's phase 2,
// 4.1x the bound (3.94 ms before).  clock64 marks (chip_cg_profile.py,
// layer 1, cycles per 16-edge tile of one block): staging 12.0k, dx and dtx
// 29.5k, cw, cdw and partials 37.4k, dy and dty 10.5k, stores 2.0k.
#include "cg_vjp.cuh"
#include "dense_tiles.cuh"

namespace nequip {
namespace {

constexpr int kCgEdges = 4;  // edges of one CG-VJP item

template <typename T>
struct JvpBwdArgs {
  const T *x, *tx, *y, *ty, *w, *dw;
  const int32_t *edge_src, *dst_ptr;
  const T *g, *gt;
  cg::Tables<T> tab;
  T *dx_edge, *dtx_edge, *dy, *dty, *cw, *cdw;
  int n_nodes, dim_in, sh_dim, wn, mid_dim;
};

// Shared-memory carve-up, in elements of T: STAGES buffers of (w, dw, y,
// ty, each with room for a 16-byte phase; x, tx rows), the dy and dty
// partials, then int32 [TILE + n_paths] (the destinations and the paths'
// order).
struct JvpBwdSmem {
  int o_dw, o_y, o_ty, o_x, o_tx, stage, o_part, o_tpart, o_dst;
  size_t bytes;
};

template <typename T>
__host__ __device__ inline JvpBwdSmem jvp_bwd_smem(int tile, int stages, int dim_in, int sh_dim, int wn,
                                                   int n_paths) {
  constexpr int V = 16 / sizeof(T);
  auto up = [](int a) { return (a + V - 1) / V * V; };
  JvpBwdSmem L;
  L.o_dw = up(tile * wn + V - 1);
  L.o_y = L.o_dw + up(tile * wn + V - 1);
  L.o_ty = L.o_y + up(tile * sh_dim + V - 1);
  L.o_x = L.o_ty + up(tile * sh_dim + V - 1);
  L.o_tx = L.o_x + up(tile * dim_in);
  L.stage = L.o_tx + up(tile * dim_in);
  L.o_part = stages * L.stage;
  L.o_tpart = L.o_part + up(tile * n_paths * kMaxYDim);
  L.o_dst = L.o_tpart + up(tile * n_paths * kMaxYDim);
  L.bytes = static_cast<size_t>(L.o_dst) * sizeof(T) + sizeof(int32_t) * (tile + n_paths);
  return L;
}

template <typename T, int TILE, int STAGES, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS) jvp_bwd_kernel(const JvpBwdArgs<T> a) {
  constexpr int NT = kThreads, NW = NT / 32, TC = TILE < kCgEdges ? TILE : kCgEdges;
  static_assert(TILE <= 32 && TILE % TC == 0 && (STAGES == 1 || STAGES == 2), "one warp finds the destinations");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dim_in = a.dim_in, sh_dim = a.sh_dim, wn = a.wn, mid_dim = a.mid_dim;
  const JvpBwdSmem L = jvp_bwd_smem<T>(TILE, STAGES, dim_in, sh_dim, wn, a.tab.n_paths);
  T* base_t = reinterpret_cast<T*>(smem_raw);
  T* s_part = base_t + L.o_part;    // [TILE][n_paths][kMaxYDim], dy
  T* s_tpart = base_t + L.o_tpart;  // the same, dty
  int32_t* s_dst = reinterpret_cast<int32_t*>(base_t + L.o_dst);  // [TILE]
  int32_t* s_order = s_dst + TILE;                                // [n_paths], heaviest first (cg::order_paths)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_real = __ldg(a.dst_ptr + a.n_nodes);
  const int n_tiles = (n_real + TILE - 1) / TILE;
  if (static_cast<int>(blockIdx.x) >= n_tiles) return;

  auto stage = [&](int tile, int buf) {
    const int base = tile * TILE, cnt = min(TILE, n_real - base);
    const int64_t ow = static_cast<int64_t>(base) * wn, oy = static_cast<int64_t>(base) * sh_dim;
    T* sb = base_t + buf * L.stage;
    stage_flat<T, NT>(sb, a.w + ow, cnt * wn, TILE * wn, tid);
    stage_flat<T, NT>(sb + L.o_dw, a.dw + ow, cnt * wn, TILE * wn, tid);
    stage_flat<T, NT>(sb + L.o_y, a.y + oy, cnt * sh_dim, TILE * sh_dim, tid);
    stage_flat<T, NT>(sb + L.o_ty, a.ty + oy, cnt * sh_dim, TILE * sh_dim, tid);
    stage_rows<T, TILE, NT>(sb + L.o_x, a.x, a.edge_src + base, cnt, dim_in, tid);
    stage_rows<T, TILE, NT>(sb + L.o_tx, a.tx, a.edge_src + base, cnt, dim_in, tid);
    cp_async_commit();
  };
  cg::order_paths(a.tab, s_order);  // the loop's first barrier publishes it
  if (STAGES == 2) stage(blockIdx.x, 0);

  for (int tile = blockIdx.x, it = 0; tile < n_tiles; tile += gridDim.x, ++it) {
    const int base = tile * TILE, cnt = min(TILE, n_real - base);
    const int buf = STAGES == 2 ? (it & 1) : 0;
    __syncthreads();  // the previous tile's readers are done
    if (warp == 0) {  // the destinations
      const int d = tile_dst(a.dst_ptr, a.n_nodes, base, cnt);
      const int d1 = __shfl_sync(0xffffffffu, d, cnt - 1);
      if (lane < TILE) s_dst[lane] = d < 0 ? d1 : d;  // sorted; rows past cnt compute values not written
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
    for (int i = tid; i < TILE * a.tab.n_paths * kMaxYDim; i += NT) s_part[i] = s_tpart[i] = T(0);
    if (STAGES == 1) cp_async_wait<0>();
    __syncthreads();

    const int64_t ow = static_cast<int64_t>(base) * wn, oy = static_cast<int64_t>(base) * sh_dim;
    const int64_t ox = static_cast<int64_t>(base) * dim_in;
    T* sb = base_t + buf * L.stage;
    T* s_w = sb + phase16(a.w + ow);  // [TILE][wn]: w, then cw in place
    T* s_dw = sb + L.o_dw + phase16(a.dw + ow);  // [TILE][wn]: dw, then cdw in place
    const T* s_y = sb + L.o_y + phase16(a.y + oy);     // [TILE][sh_dim]
    const T* s_ty = sb + L.o_ty + phase16(a.ty + oy);  // [TILE][sh_dim]
    const cg::GRows<T, false> gr{a.g, 0, mid_dim}, gtr{a.gt, 0, mid_dim};
    cg::dx_items_jvp<T, TILE, TC, NW>(a.tab, gr, gtr, s_dst, s_y, s_ty, sh_dim, s_w, s_dw, wn, cnt, dim_in,
                                      a.dx_edge + ox, a.dtx_edge + ox);
    __syncthreads();  // dx and dtx have read w and dw
    cg::dw_items_jvp<T, TILE, TC, NW>(a.tab, cg::XRows<T, true>{sb + L.o_x, nullptr, dim_in},
                                      cg::XRows<T, true>{sb + L.o_tx, nullptr, dim_in}, gr, gtr, s_order, s_dst, s_y,
                                      s_ty, sh_dim, s_w, s_dw, wn, cnt, s_part, s_tpart);
    __syncthreads();
    cg::path_sum<T, NT>(a.tab, s_part, cnt, sh_dim, a.dy + oy);
    cg::path_sum<T, NT>(a.tab, s_tpart, cnt, sh_dim, a.dty + oy);
    store_flat<T, NT>(a.cw + ow, s_w, cnt * wn, tid);
    store_flat<T, NT>(a.cdw + ow, s_dw, cnt * wn, tid);
  }
}

template <typename T, int TILE, int STAGES, int MIN_BLOCKS>
cudaError_t launch_tile(const JvpBwdArgs<T>& args, int dev, size_t smem, cudaStream_t stream) {
  auto kernel = jvp_bwd_kernel<T, TILE, STAGES, MIN_BLOCKS>;
  int grid = 0;
  const cudaError_t err = persistent_grid(kernel, kThreads, dev, smem, grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

// The first shape whose shared memory fits: two blocks an SM before one,
// larger tiles before smaller, double-buffered before single.
template <typename T>
int launch_jvp_bwd(const JvpBwdArgs<T>& a, void* stream) {
  if (a.n_nodes <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t rows = a.n_nodes + 1;  // g offsets are int32
  if (rows * a.mid_dim >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  SmemLimits lim;
  const cudaError_t err = smem_limits(lim);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto smem = [&](int tile, int stages) {
    return jvp_bwd_smem<T>(tile, stages, a.dim_in, a.sh_dim, a.wn, a.tab.n_paths).bytes;
  };
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (lim.fit(smem(32, 2), 2)) e = launch_tile<T, 32, 2, 2>(a, lim.dev, smem(32, 2), s);
  else if (lim.fit(smem(32, 1), 2)) e = launch_tile<T, 32, 1, 2>(a, lim.dev, smem(32, 1), s);
  else if (lim.fit(smem(16, 1), 2)) e = launch_tile<T, 16, 1, 2>(a, lim.dev, smem(16, 1), s);
  else if (lim.fit(smem(8, 1), 2)) e = launch_tile<T, 8, 1, 2>(a, lim.dev, smem(8, 1), s);
  else if (lim.fit(smem(16, 1), 1)) e = launch_tile<T, 16, 1, 1>(a, lim.dev, smem(16, 1), s);
  else if (lim.fit(smem(8, 1), 1)) e = launch_tile<T, 8, 1, 1>(a, lim.dev, smem(8, 1), s);
  else e = launch_tile<T, 4, 1, 1>(a, lim.dev, smem(4, 1), s);  // refused if it does not fit either
  return static_cast<int>(e);
}

}  // namespace
}  // namespace nequip

#define NEQUIP_JVP_BWD(SUFFIX, T)                                                                              \
  extern "C" int nequip_jvp_bwd_##SUFFIX(                                                                     \
      const void* x, const void* tx, const void* y, const void* ty, const void* w, const void* dw,            \
      const void* edge_src, const void* dst_ptr, const void* g, const void* gt, const void* dx_groups,        \
      const void* dx_terms, const void* dx_coef, const void* dx_col_group, const void* paths,                 \
      const void* path_terms, const void* path_coef, void* dx_edge, void* dtx_edge, void* dy, void* dty,      \
      void* cw, void* cdw, int n_paths, int n_nodes, int dim_in, int sh_dim, int wn, int mid_dim,             \
      void* stream) {                                                                                         \
    const nequip::JvpBwdArgs<T> args{                                                                         \
        static_cast<const T*>(x), static_cast<const T*>(tx), static_cast<const T*>(y),                        \
        static_cast<const T*>(ty), static_cast<const T*>(w), static_cast<const T*>(dw),                       \
        static_cast<const int32_t*>(edge_src), static_cast<const int32_t*>(dst_ptr),                          \
        static_cast<const T*>(g), static_cast<const T*>(gt),                                                  \
        {static_cast<const int32_t*>(dx_groups), static_cast<const int32_t*>(dx_terms),                       \
         static_cast<const T*>(dx_coef), static_cast<const int32_t*>(dx_col_group),                           \
         static_cast<const int32_t*>(paths), static_cast<const int32_t*>(path_terms),                         \
         static_cast<const T*>(path_coef), n_paths},                                                          \
        static_cast<T*>(dx_edge), static_cast<T*>(dtx_edge), static_cast<T*>(dy), static_cast<T*>(dty),       \
        static_cast<T*>(cw), static_cast<T*>(cdw), n_nodes, dim_in, sh_dim, wn, mid_dim};                     \
    return nequip::launch_jvp_bwd<T>(args, stream);                                                           \
  }

NEQUIP_JVP_BWD(f32, float)
NEQUIP_JVP_BWD(f64, double)
