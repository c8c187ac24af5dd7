// K4: trilinear convolution forward with given per-edge weights,
// gather -> CG tensor product -> sum into the destination node.
//
// Replaces the TPU kernel nequip_tpu/ops/pallas/tp_scatter.py, _forward
// (kernel body _kernel_T, CG block _compute_tp_block_T), the forward of the
// trilinear family F(x, y, w) = scatter_dst(TP(x[src], y, w)) that serves
// tp_impl="fused_tp" and the second-order pass of the fused conv (three F
// calls per layer in each VJP of K5).  Per edge e with source s, destination n:
//   out[n, out_row + u] += w_e[w_off + u] * sum_terms c * y_e[yi] * x[s, x_row + u]
// It computes K1's sum (conv_fwd.cu) without the in-kernel radial MLP: w is
// read from an [E, WN] buffer in kernel order.  Rows of degree-0 and padding
// nodes are zero.
//
// K4-acc (nequip_tri_fwd_acc): the same with out += ..., in place on an [N,
// mid_dim] accumulator.  Replaces _forward(acc=...) (kernel body
// _kernel_from_acc, pallas_call at tp_scatter.py:949), which folds one slice
// of the edge stream into running messages in the edge-chunked fr sweep.
// The wrapper hands it a slice's clipped CSR (dst_ptr relative to the
// slice's first edge) and the slice's y/w rows.  A node with no edge in the
// slice keeps its row bitwise; a node whose edges two slices split gets each
// slice's sum added in turn, slice after slice on one stream.
//
// What bounds it on an H100: bytes, the x[src] gather and the w read
// (419,904 x (288 + 352) x 4 B ~ 1.1 GB in layer 1 at 23k atoms, f32),
// ~0.35 ms over the three layers at HBM rate.
// The first design was one block per destination node stepping 8
// edges at a time: ~18-edge segments left its steps 75% full, layer 2's
// 96 columns left 160 of 256 threads idle, and it re-read the term table
// and recomputed c * y for every column.
// Design: K1's (conv_fwd.cu) without the MLP, on the pieces of cg_fwd.cuh.
// - Tiles of TILE consecutive real slots of the dst-sorted stream, across
//   node boundaries, on a persistent grid (dense_tiles.cuh); one warp finds
//   the tile's destinations (tile_segments).
// - The tile's w and y rows are staged by cp.async at their own 16-byte
//   phase (stage_flat: an fr slice's rows start anywhere), its x[src] rows
//   by stage_rows; c * y per (term, edge) is formed once a tile while x and
//   w land.  Each thread owns output columns and keeps the column's product
//   for every edge of the tile in registers, then walks the edges in stream
//   order (cg_forward).
// - Destinations split across tiles: the part of a last segment that
//   continues goes to the tile's carry row, and a second launch adds each
//   split node's parts in tile order (finish_split_rows), writes the zero
//   rows of nodes without edges, and leaves the accumulator's rows of such
//   nodes as they are.  No atomics, every sum in a fixed order: bitwise
//   repeatable.  The carry rows [ceil(n_real / TILE), mid_dim] (118 MB in
//   layer 1 in f32) live only inside the call.  Owner-computes (the tile
//   holding a node's first edge walks all its edges, in chunks) needs no
//   carry and no second launch, but took 1.95 ms against 1.13-1.14 here
//   (chip_cg_profile.py --fwd owner; PERF.md): about half the tiles
//   take a second chunk at the flagship's 18-edge segments, each as costly
//   as a whole tile.
// - Four blocks an SM where their shared memory fits, the column products
//   then in 64 registers (f32: up to 32 edges, f64: 16): more blocks hide
//   the destination search and the x[src] gather, which the narrow layers
//   leave exposed.  Layers 0 and 2 take 32-edge tiles (20 / 60 KB), layer 1
//   16-edge ones (w 22.5 KB, x 18.4, c * y 5.3, ~47 KB); wider rows take
//   two blocks of 32-, 16-, 8- or 4-edge tiles.
// Measured (chip_smoke.py phase 2; H100 80GB HBM3, 700 W; PERF.md):
// f32 0.22 / 0.76 / 0.22 ms for the three layers, 3.4x the bound (2.54
// before, same call; 1.45 at two blocks of 32-edge tiles); K4-acc on one
// of 4 fr slices 0.12 / 0.27 / 0.12 (0.79 before).  clock64 marks (layer
// 1, cycles per tile of thread 0): staging with the destinations 7.9k, the
// CG product and sums 10.7k.  A double-buffered stage was no faster.
// Registers (nvcc -Xptxas -v): f32 64 at four blocks an SM, 127-128 at two
// (4-edge tiles 114); f64 64 / 128 (4-edge at one block 147); no spills.
#include "cg_fwd.cuh"
#include "dense_tiles.cuh"

namespace nequip {
namespace {

template <typename T>
struct TriFwdArgs {
  const T *x, *y, *w;
  const int32_t *edge_src, *dst_ptr;
  cgf::Tables<T> tab;
  T *out, *carry;
  int n_nodes, dim_in, sh_dim, wn, mid_dim;
};

// Shared-memory carve-up, in elements of T: w [TILE][wn] and y [TILE][sh_dim]
// (each with room for a 16-byte phase), x [TILE][dim_in], c * y
// [n_terms][TILE], then int32 s_dst [TILE] and two flags.
struct TriFwdSmem {
  int o_y, o_x, o_cy, o_idx;
  size_t bytes;
};

template <typename T>
__host__ __device__ inline TriFwdSmem tri_fwd_smem(int tile, int dim_in, int sh_dim, int wn, int n_terms) {
  constexpr int V = 16 / sizeof(T);
  auto up = [](int a) { return (a + V - 1) / V * V; };
  TriFwdSmem L;
  L.o_y = up(tile * wn + V - 1);
  L.o_x = L.o_y + up(tile * sh_dim + V - 1);
  L.o_cy = L.o_x + up(tile * dim_in);
  L.o_idx = L.o_cy + up(tile * n_terms);
  L.bytes = static_cast<size_t>(L.o_idx) * sizeof(T) + sizeof(int32_t) * (tile + 2);
  return L;
}

template <typename T, int TILE, bool kAcc, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS) tri_fwd_kernel(const TriFwdArgs<T> a) {
  constexpr int NT = kThreads;
  static_assert(TILE <= 32, "one warp finds the destinations");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dim_in = a.dim_in, sh_dim = a.sh_dim, wn = a.wn, mid_dim = a.mid_dim;
  const TriFwdSmem L = tri_fwd_smem<T>(TILE, dim_in, sh_dim, wn, a.tab.n_terms);
  T* base_t = reinterpret_cast<T*>(smem_raw);
  T* s_x = base_t + L.o_x;    // [TILE][dim_in]
  T* s_cy = base_t + L.o_cy;  // [n_terms][TILE]
  int32_t* s_dst = reinterpret_cast<int32_t*>(base_t + L.o_idx);  // [TILE]
  int32_t* s_flags = s_dst + TILE;  // [0]: where segments end in the tile; [1]: the last one continues

  const int tid = threadIdx.x;
  const int n_real = __ldg(a.dst_ptr + a.n_nodes);
  const int n_tiles = (n_real + TILE - 1) / TILE;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int base = tile * TILE, cnt = min(TILE, n_real - base);
    const int64_t oy = static_cast<int64_t>(base) * sh_dim, ow = static_cast<int64_t>(base) * wn;
    __syncthreads();  // the previous tile's readers are done
    stage_flat<T, NT>(base_t + L.o_y, a.y + oy, cnt * sh_dim, TILE * sh_dim, tid);
    cp_async_commit();
    stage_flat<T, NT>(base_t, a.w + ow, cnt * wn, TILE * wn, tid);
    stage_rows<T, TILE, NT>(s_x, a.x, a.edge_src + base, cnt, dim_in, tid);
    cp_async_commit();
    if (tid < 32) cgf::tile_segments<TILE>(a.dst_ptr, a.n_nodes, base, cnt, s_dst, s_flags);  // warp 0
    cp_async_wait<1>();  // y has landed
    __syncthreads();
    cgf::scale_y<T, TILE, NT>(a.tab, base_t + L.o_y + phase16(a.y + oy), sh_dim, s_cy, tid);  // while x, w land
    cp_async_wait<0>();
    __syncthreads();

    // a last segment that continues into the next tile goes to this tile's carry row
    T* const carry_row = s_flags[1] ? a.carry + static_cast<int64_t>(tile) * mid_dim : nullptr;
    cgf::cg_forward<T, TILE, NT>(
        a.tab, s_cy, s_x, dim_in, base_t + phase16(a.w + ow), wn, mid_dim, static_cast<unsigned>(s_flags[0]),
        [&](int o, int e, T v) {
          if (e == cnt - 1 && carry_row != nullptr)
            carry_row[o] = v;
          else if (kAcc)
            a.out[static_cast<int64_t>(s_dst[e]) * mid_dim + o] += v;
          else
            a.out[static_cast<int64_t>(s_dst[e]) * mid_dim + o] = v;
        });
  }
}

template <typename T, int TILE, bool kAcc, int MIN_BLOCKS>
cudaError_t launch_tile(const TriFwdArgs<T>& args, int dev, size_t smem, cudaStream_t stream) {
  auto kernel = tri_fwd_kernel<T, TILE, kAcc, MIN_BLOCKS>;
  int grid = 0;
  const cudaError_t err = persistent_grid(kernel, kThreads, dev, smem, grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

// The largest tile whose column products fit the 64 registers of four
// blocks an SM: 32 edges in f32, 16 in f64.
template <typename T>
constexpr int kTop4 = sizeof(T) == 4 ? 32 : 16;

// The launch shape: four blocks an SM at the largest tile up to kTop4 whose
// shared memory allows them (more blocks hide the destination search and
// the gather; layers 0 and 2 take 32-edge tiles, layer 1 16), else the
// first of 32-, 16-, 8- and 4-edge tiles that lets two blocks share an SM,
// else 4-edge tiles at one block an SM; tile 0 if none fits.
struct Shape {
  int tile, blocks;
};

template <typename T>
Shape pick_shape(const SmemLimits& lim, int dim_in, int sh_dim, int wn, int n_terms) {
  auto fits = [&](int tile, int blocks) {
    return lim.fit(tri_fwd_smem<T>(tile, dim_in, sh_dim, wn, n_terms).bytes, blocks);
  };
  for (const int tile : {32, 16})
    if (tile <= kTop4<T> && fits(tile, 4)) return {tile, 4};
  for (const int tile : {32, 16, 8, 4})
    if (fits(tile, 2)) return {tile, 2};
  return {fits(4, 1) ? 4 : 0, 1};
}

// Tile kernel, then the finish kernel.  `tile` must be pick_shape's (the
// caller sized carry [ceil(n_real / tile), mid_dim] by it).
template <typename T, bool kAcc>
int launch_tri_fwd(const TriFwdArgs<T>& a, int tile, void* stream) {
  if (a.n_nodes <= 0) return static_cast<int>(cudaGetLastError());
  SmemLimits lim;
  cudaError_t e = smem_limits(lim);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Shape sh = pick_shape<T>(lim, a.dim_in, a.sh_dim, a.wn, a.tab.n_terms);
  if (sh.tile == 0 || tile != sh.tile) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = tri_fwd_smem<T>(tile, a.dim_in, a.sh_dim, a.wn, a.tab.n_terms).bytes;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sh.blocks == 4 && tile == 32) e = launch_tile<T, kTop4<T>, kAcc, 4>(a, lim.dev, smem, s);
  else if (sh.blocks == 4) e = launch_tile<T, 16, kAcc, 4>(a, lim.dev, smem, s);
  else if (tile == 32) e = launch_tile<T, 32, kAcc, 2>(a, lim.dev, smem, s);
  else if (tile == 16) e = launch_tile<T, 16, kAcc, 2>(a, lim.dev, smem, s);
  else if (tile == 8) e = launch_tile<T, 8, kAcc, 2>(a, lim.dev, smem, s);
  else if (sh.blocks == 2) e = launch_tile<T, 4, kAcc, 2>(a, lim.dev, smem, s);
  else e = launch_tile<T, 4, kAcc, 1>(a, lim.dev, smem, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cgf::launch_finish<T, 1, kAcc>(a.dst_ptr, a.carry, a.out, nullptr, a.n_nodes, a.mid_dim,
                                                         tile, s));
}

// pick_shape's tile for the given widths on the current device; a CUDA error as -err
template <typename T>
int tri_fwd_tile(int dim_in, int sh_dim, int wn, int n_terms) {
  SmemLimits lim;
  const cudaError_t err = smem_limits(lim);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return pick_shape<T>(lim, dim_in, sh_dim, wn, n_terms).tile;
}

}  // namespace
}  // namespace nequip

#define NEQUIP_TRI_FWD(NAME, SUFFIX, T, ACC)                                                                 \
  extern "C" int NAME##_##SUFFIX(const void* x, const void* y, const void* w, const void* edge_src,         \
                                 const void* dst_ptr, const void* groups, const void* terms, const void* coef, \
                                 const void* col_group, void* out, void* carry, int n_terms, int n_nodes,    \
                                 int dim_in, int sh_dim, int wn, int mid_dim, int tile, void* stream) {      \
    const nequip::TriFwdArgs<T> args{                                                                        \
        static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const T*>(w),                        \
        static_cast<const int32_t*>(edge_src), static_cast<const int32_t*>(dst_ptr),                         \
        {static_cast<const int32_t*>(groups), static_cast<const int32_t*>(terms),                            \
         static_cast<const T*>(coef), static_cast<const int32_t*>(col_group), n_terms},                      \
        static_cast<T*>(out), static_cast<T*>(carry), n_nodes, dim_in, sh_dim, wn, mid_dim};                 \
    return nequip::launch_tri_fwd<T, ACC>(args, tile, stream);                                               \
  }

#define NEQUIP_TRI_FWD_TILE(SUFFIX, T)                                                              \
  extern "C" int nequip_tri_fwd_tile_##SUFFIX(int dim_in, int sh_dim, int wn, int n_terms) {       \
    return nequip::tri_fwd_tile<T>(dim_in, sh_dim, wn, n_terms);                                    \
  }

NEQUIP_TRI_FWD(nequip_tri_fwd, f32, float, false)
NEQUIP_TRI_FWD(nequip_tri_fwd, f64, double, false)
NEQUIP_TRI_FWD(nequip_tri_fwd_acc, f32, float, true)
NEQUIP_TRI_FWD(nequip_tri_fwd_acc, f64, double, true)
NEQUIP_TRI_FWD_TILE(f32, float)
NEQUIP_TRI_FWD_TILE(f64, double)
