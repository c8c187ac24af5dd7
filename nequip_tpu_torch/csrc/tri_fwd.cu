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
//   (a patched copy timed when this design was chosen; PERF.md): about half the tiles
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
//
// bf16 (the fast mode's nequip_tri_fwd_bf16, nequip_tri_fwd_acc_bf16): x, y
// and w are bf16 in device memory, and so is out; K4-acc's accumulator is
// float32.  Every product and sum is taken in float32.  As in K1's bf16 form
// (conv_fwd.cu), the sums over edges are compensated float32 sums (hi +
// lo), a destination's parts that tiles split wait in float32 carry rows
// ([n_tiles][2][2][mid_dim], cg_fwd.cuh carry_slots) and the second launch
// adds them in tile order, so a sum does not depend on how its edges fall
// into tiles.  K4 rounds each output once, to the bf16 nearest to its sum.
// K4-acc adds each slice's sum onto the float32 accumulator, rounded to
// float32 once; the caller rounds the accumulator to bf16 once, after the
// last slice (tp_scatter.ChunkedConv), so fr over C slices equals fr over
// one to within that rounding.  JAX instead sums each chunk's messages into
// a bf16 block and keeps the accumulator in bf16 (ROADMAP.md, Known
// quirks).  The plain versions (tp_scatter.tri_fwd_plain) round at the same
// points.  Design (the first bf16 form ran the f32 design on float32 tiles,
// each operand widened by plain loads as it was staged, at two blocks an
// SM, since its compensated walk spilled at four: 2.28 ms over the three
// layers against f32's 1.20):
// - The operand tiles stay bf16 in shared memory: y, w and the x[src] rows
//   come in raw by 16-byte cp.async (stage_flat, stage_rows on the storage
//   type; an fr slice's y starts at any 2-byte phase, and its at most 14
//   end values go by plain 2-byte copies), in f32's two commit groups, so
//   scale_y and warp 0's destination search run while x and w land.
//   tri_fwd_smem counts in elements of S.  c * y stays a float32 tile.
//   cg_fwd.cuh widens each value where it reads it, exactly, so every
//   output is the float32-tile form's bit for bit (chip_cg_profile.py --fwd
//   --dtype bf16 --parent: the four entries, three layers, the whole stream
//   and one of 4 slices).
// - The walk forms a column's products kWalkPart = 16 edges at a time in a
//   rolled loop over the parts, the compensated sum carried across them in
//   edge order: one part's per-edge offsets are live at a time, so a
//   32-edge tile runs at four blocks an SM in 64 registers without a spill
//   (the same parts unrolled spilled 184 bytes and took 2.00 ms).  A bf16
//   tile of layer 1 is w 22.5 + x 18.4 + y 0.6 + c * y 10.6 = 52 KB, so
//   every flagship layer takes 32-edge tiles at four blocks.
// - Launch shapes tried (chip_cg_profile.py --fwd --dtype bf16, K4 on the
//   whole 23k-atom stream, the three layers summed; H100 80GB HBM3, 700 W):
//   32 edges at four blocks, parts of 16: 1.348-1.390 ms; parts of 8
//   1.450-1.518; 32 at three blocks 1.489-1.498 (parts of 8: 1.569); 16 at
//   four 1.693-1.719; 32 at two (128 registers) 1.784-1.798 (whole-tile
//   walk: 1.933); 16 at two 2.313.  Preset M's layer 1 (16 edges at four
//   blocks) 1.90-1.96 ms, within 0.05 of every other shape.
// - Registers (nvcc -Xptxas -v): 63-64 at four blocks (32- and 16-edge
//   tiles), 90-126 at two, 87-88 for 4-edge tiles; no spills.
// Measured (chip_cg_profile.py --fwd --dtype bf16 --parent, both builds in
// turns in one process; H100 80GB HBM3, 700 W): 2.275 -> 1.390 ms over the
// three layers (f32, in another run: 1.197); K4-acc on
// one of 4 slices 0.686 -> 0.463 (f32 0.426).  Layer 1, cycles per tile of
// thread 0 (32-edge tiles; four blocks an SM against the parent's two):
// staging, destinations and y 12.2k -> 7.7k; the CG phase 28.4k -> 38.4k,
// of which the products 8.5k -> 13.1k and the compensated walk 19.4k ->
// 24.9k.  The walk, about 10 instructions an edge where f32 issues one
// FFMA, is what keeps K4 above f32.
#include <type_traits>

#include "cg_fwd.cuh"
#include "dense_tiles.cuh"

namespace nequip {
namespace {

// S: the storage type of x, y, w and out; the kernel computes in T =
// Acc<S> (tp_common.cuh), the type of the tables, the carry rows and
// K4-acc's accumulator
template <typename S>
struct TriFwdArgs {
  using T = Acc<S>;
  const S *x, *y, *w;
  const int32_t *edge_src, *dst_ptr;
  cgf::Tables<T> tab;
  void* out;  // [N, mid_dim] of S, or K4-acc's accumulator of T
  T* carry;
  int n_nodes, dim_in, sh_dim, wn, mid_dim;
};

// Shared-memory carve-up, in elements of S (the operand tiles' storage
// type; 16-byte phases of V = 16 / sizeof(S) elements): w [TILE][wn] and y
// [TILE][sh_dim] (each with room for a 16-byte phase), x [TILE][dim_in], c *
// y [n_terms][TILE] of T = Acc<S>, then int32 s_dst [TILE] and two flags.
struct TriFwdSmem {
  int o_y, o_x, o_cy, o_idx;
  size_t bytes;
};

template <typename T, typename S = T>
__host__ __device__ inline TriFwdSmem tri_fwd_smem(int tile, int dim_in, int sh_dim, int wn, int n_terms) {
  constexpr int V = 16 / sizeof(S);
  auto up = [](int a) { return (a + V - 1) / V * V; };
  TriFwdSmem L;
  L.o_y = up(tile * wn + V - 1);
  L.o_x = L.o_y + up(tile * sh_dim + V - 1);
  L.o_cy = L.o_x + up(tile * dim_in);
  L.o_idx = L.o_cy + up(tile * n_terms * static_cast<int>(sizeof(T) / sizeof(S)));
  L.bytes = static_cast<size_t>(L.o_idx) * sizeof(S) + sizeof(int32_t) * (tile + 2);
  return L;
}

// bf16: the edges whose column products a thread holds at once (the
// compensated walk runs over the tile part by part): kWalkPart of a 32-edge
// tile, 8 of a smaller one (a 16-edge tile walked whole spills at 64
// registers)
constexpr int kWalkPart = 16;

template <int TILE>
constexpr int kPart = TILE >= 32 ? kWalkPart : TILE < 8 ? TILE : 8;

template <typename S, int TILE, bool kAcc, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS) tri_fwd_kernel(const TriFwdArgs<S> a) {
  using T = Acc<S>;  // c * y, registers and sums; the operand tiles are S
  using O = typename std::conditional<kAcc, T, S>::type;
  constexpr bool kRound = !std::is_same<S, T>::value;  // bf16: compensated sums, rounded once (see the header)
  constexpr int NT = kThreads;
  static_assert(TILE <= 32, "one warp finds the destinations");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dim_in = a.dim_in, sh_dim = a.sh_dim, wn = a.wn, mid_dim = a.mid_dim;
  const TriFwdSmem L = tri_fwd_smem<T, S>(TILE, dim_in, sh_dim, wn, a.tab.n_terms);
  S* base_s = reinterpret_cast<S*>(smem_raw);
  S* s_x = base_s + L.o_x;                            // [TILE][dim_in]
  T* s_cy = reinterpret_cast<T*>(base_s + L.o_cy);  // [n_terms][TILE]
  int32_t* s_dst = reinterpret_cast<int32_t*>(base_s + L.o_idx);  // [TILE]
  int32_t* s_flags = s_dst + TILE;  // [0]: where segments end in the tile; [1]: the last one continues
  O* const out = static_cast<O*>(a.out);

  const int tid = threadIdx.x;
  const int n_real = __ldg(a.dst_ptr + a.n_nodes);
  const int n_tiles = (n_real + TILE - 1) / TILE;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int base = tile * TILE, cnt = min(TILE, n_real - base);
    const int64_t oy = static_cast<int64_t>(base) * sh_dim, ow = static_cast<int64_t>(base) * wn;
    __syncthreads();  // the previous tile's readers are done
    stage_flat<S, NT>(base_s + L.o_y, a.y + oy, cnt * sh_dim, TILE * sh_dim, tid);
    cp_async_commit();
    stage_flat<S, NT>(base_s, a.w + ow, cnt * wn, TILE * wn, tid);
    stage_rows<S, TILE, NT>(s_x, a.x, a.edge_src + base, cnt, dim_in, tid);
    cp_async_commit();
    if (tid < 32) cgf::tile_segments<TILE>(a.dst_ptr, a.n_nodes, base, cnt, s_dst, s_flags);  // warp 0
    cp_async_wait<1>();  // y has landed
    __syncthreads();
    cgf::scale_y<T, TILE, NT>(a.tab, base_s + L.o_y + staged_phase<S>(a.y + oy), sh_dim, s_cy, tid);  // while x, w land
    cp_async_wait<0>();
    __syncthreads();

    const S* const s_w = base_s + staged_phase<S>(a.w + ow);
    const unsigned ends = static_cast<unsigned>(s_flags[0]);
    if constexpr (!kRound) {
      // a last segment that continues into the next tile goes to this tile's carry row
      T* const carry_row = s_flags[1] ? a.carry + static_cast<int64_t>(tile) * mid_dim : nullptr;
      cgf::cg_forward<T, TILE, NT>(a.tab, s_cy, s_x, dim_in, s_w, wn, mid_dim, ends, [&](int o, int e, T v) {
        if (e == cnt - 1 && carry_row != nullptr)
          carry_row[o] = v;
        else if (kAcc)
          out[static_cast<int64_t>(s_dst[e]) * mid_dim + o] += v;
        else
          out[static_cast<int64_t>(s_dst[e]) * mid_dim + o] = v;
      });
    } else {
      // bf16: segments that another tile shares to the carry slots, every
      // other one rounded once into out, or added onto the accumulator
      const auto slots = cgf::carry_slots<1>(a.dst_ptr, s_dst, s_flags, a.carry, tile, base, mid_dim);
      cgf::cg_forward_compensated<TILE, NT, kPart<TILE>>(
          a.tab, s_cy, s_x, dim_in, s_w, wn, mid_dim, ends, [&](int o, int e, const SumF32x2& v) {
            O* const at = out + static_cast<int64_t>(s_dst[e]) * mid_dim + o;
            if (T* const row = slots.at(e, cnt))
              slots.put(row, 0, o, v);
            else if constexpr (kAcc)
              *at = add_onto(*at, v);
            else
              *at = bf16_of_sum(v.hi, v.lo);
          });
    }
  }
}

template <typename S, int TILE, bool kAcc, int MIN_BLOCKS>
cudaError_t launch_tile(const TriFwdArgs<S>& args, int dev, size_t smem, cudaStream_t stream) {
  auto kernel = tri_fwd_kernel<S, TILE, kAcc, MIN_BLOCKS>;
  int grid = 0;
  const cudaError_t err = persistent_grid(kernel, kThreads, dev, smem, grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

// The largest tile whose column products fit the 64 registers of four
// blocks an SM: 32 edges in f32 and in bf16 (its walk holds kWalkPart edges'
// products at a time), 16 in f64.
template <typename S>
constexpr int kTop4 = std::is_same<S, double>::value ? 16 : 32;

// The launch shape: four blocks an SM at the largest tile up to kTop4 whose
// shared memory allows them (more blocks hide the destination search and
// the gather; f32 layers 0 and 2 take 32-edge tiles, layer 1 16; bf16 32 in
// every layer), else the first of 32-, 16-, 8- and 4-edge tiles that lets
// two blocks share an SM, else 4-edge tiles at one block an SM; tile 0 if
// none fits.
struct Shape {
  int tile, blocks;
};

template <typename S>
Shape pick_shape(const SmemLimits& lim, int dim_in, int sh_dim, int wn, int n_terms) {
  auto fits = [&](int tile, int blocks) {
    return lim.fit(tri_fwd_smem<Acc<S>, S>(tile, dim_in, sh_dim, wn, n_terms).bytes, blocks);
  };
  for (const int tile : {32, 16})
    if (tile <= kTop4<S> && fits(tile, 4)) return {tile, 4};
  for (const int tile : {32, 16, 8, 4})
    if (fits(tile, 2)) return {tile, 2};
  return {fits(4, 1) ? 4 : 0, 1};
}

// The kernel of launch shape sh
template <typename S, bool kAcc>
cudaError_t launch_shape(const TriFwdArgs<S>& a, Shape sh, int dev, size_t smem, cudaStream_t s) {
  if (sh.blocks == 4 && sh.tile == 32) return launch_tile<S, kTop4<S>, kAcc, 4>(a, dev, smem, s);
  if (sh.blocks == 4) return launch_tile<S, 16, kAcc, 4>(a, dev, smem, s);
  if (sh.tile == 32) return launch_tile<S, 32, kAcc, 2>(a, dev, smem, s);
  if (sh.tile == 16) return launch_tile<S, 16, kAcc, 2>(a, dev, smem, s);
  if (sh.tile == 8) return launch_tile<S, 8, kAcc, 2>(a, dev, smem, s);
  if (sh.blocks == 2) return launch_tile<S, 4, kAcc, 2>(a, dev, smem, s);
  return launch_tile<S, 4, kAcc, 1>(a, dev, smem, s);
}

// Tile kernel, then the finish kernel.  `tile` must be pick_shape's (the
// caller sized carry by it: [ceil(n_real / tile), mid_dim], bf16
// [ceil(n_real / tile) * 4, mid_dim] of float32).
template <typename S, bool kAcc>
int launch_tri_fwd(const TriFwdArgs<S>& a, int tile, void* stream) {
  using T = Acc<S>;
  if (a.n_nodes <= 0) return static_cast<int>(cudaGetLastError());
  SmemLimits lim;
  cudaError_t e = smem_limits(lim);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Shape sh = pick_shape<S>(lim, a.dim_in, a.sh_dim, a.wn, a.tab.n_terms);
  if (sh.tile == 0 || tile != sh.tile) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = tri_fwd_smem<T, S>(tile, a.dim_in, a.sh_dim, a.wn, a.tab.n_terms).bytes;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = launch_shape<S, kAcc>(a, sh, lim.dev, smem, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  using O = typename std::conditional<kAcc, T, S>::type;
  O* const out = static_cast<O*>(a.out);
  if constexpr (std::is_same<S, T>::value)
    return static_cast<int>(cgf::launch_finish<T, 1, kAcc>(a.dst_ptr, a.carry, out, nullptr, a.n_nodes, a.mid_dim,
                                                           tile, s));
  else
    return static_cast<int>(cgf::launch_finish_compensated<S, 1, kAcc>(a.dst_ptr, a.carry, out, nullptr, a.n_nodes,
                                                                       a.mid_dim, tile, s));
}

// pick_shape's tile for the given widths on the current device; a CUDA error as -err
template <typename S>
int tri_fwd_tile(int dim_in, int sh_dim, int wn, int n_terms) {
  SmemLimits lim;
  const cudaError_t err = smem_limits(lim);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return pick_shape<S>(lim, dim_in, sh_dim, wn, n_terms).tile;
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
         static_cast<const nequip::Acc<T>*>(coef), static_cast<const int32_t*>(col_group), n_terms},         \
        out, static_cast<nequip::Acc<T>*>(carry), n_nodes, dim_in, sh_dim, wn, mid_dim};                     \
    return nequip::launch_tri_fwd<T, ACC>(args, tile, stream);                                               \
  }

#define NEQUIP_TRI_FWD_TILE(SUFFIX, T)                                                              \
  extern "C" int nequip_tri_fwd_tile_##SUFFIX(int dim_in, int sh_dim, int wn, int n_terms) {       \
    return nequip::tri_fwd_tile<T>(dim_in, sh_dim, wn, n_terms);                                    \
  }

NEQUIP_TRI_FWD(nequip_tri_fwd, f32, float, false)
NEQUIP_TRI_FWD(nequip_tri_fwd, f64, double, false)
NEQUIP_TRI_FWD(nequip_tri_fwd, bf16, __nv_bfloat16, false)
NEQUIP_TRI_FWD(nequip_tri_fwd_acc, f32, float, true)
NEQUIP_TRI_FWD(nequip_tri_fwd_acc, f64, double, true)
NEQUIP_TRI_FWD(nequip_tri_fwd_acc, bf16, __nv_bfloat16, true)
NEQUIP_TRI_FWD_TILE(f32, float)
NEQUIP_TRI_FWD_TILE(f64, double)
NEQUIP_TRI_FWD_TILE(bf16, __nv_bfloat16)
