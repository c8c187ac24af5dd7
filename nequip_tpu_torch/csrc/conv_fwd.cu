// K1: fused convolution forward, gather -> radial MLP -> CG tensor product
// -> sum into the destination node.
//
// Replaces the TPU kernel nequip_tpu/ops/pallas/tp_scatter.py,
// _make_fused_mlp.forward (kernel body _fwd_mlp_kernel_T, CG block
// _compute_tp_block_T).  Per real edge e with source s and destination n:
//   w_e = alpha1 * silu(alpha0 * emb_e . W1) . W2            (radial MLP)
//   out[n, out_row + u] += w_e[w_off + u] * sum_terms c * sh_e[y] * x[s, x_row + u]
// Rows of nodes with no real edge (padding nodes too) are zero; masked
// slots are never read.
//
// What bounds it on an H100 (flagship, 23k atoms, 419,904 edges, f32):
// operations, the radial MLP's product with W2 (2 x 128 x WN FMAs per edge,
// WN = 96 / 352 / 96), 1.00 ms over the three layers at 67 TFLOP/s of FFMA;
// its bytes (x[src], out) take less.  The first design, one block per
// destination stepping 8 edges at a time, took 5.60 / 14.29 / 5.89 ms in
// the three layers: ~18-edge segments left its tiles 75% full, and its MLP
// loops kept only WN or hidden of 256 threads busy, re-reading W1/W2 from
// L2 for every 8 edges.
// Design (dense edge tiles, as K2 in conv_bwd.cu):
// - A block takes TILE = 32 consecutive real slots of the dst-sorted stream,
//   across node boundaries, on a persistent grid of (SMs x resident blocks)
//   (dense_tiles.cuh: n_real = dst_ptr[n_nodes] is read on the card; one
//   warp finds the tile's destinations with a 32-ary search, tile_dst).
// - The radial MLP is a block GEMM on the tile (radial_mlp.cuh): h =
//   silu(alpha0 emb . W1) from a shared copy of W1, then w = alpha1 h . W2
//   with W2 streamed in 16-row slabs through a 3-stage cp.async ring, each
//   slab serving every edge of the tile; f32 (f64) FFMA, no tensor-core
//   form being f32-exact.  w stays in shared memory: no [E, WN] or
//   [E, hidden] buffer is written.
// - The CG product (cg_fwd.cuh, shared with K4 and K6): the tile's x[src]
//   rows are copied into shared memory (cp.async, over the memory h and the
//   ring held during the GEMM) with c * sh_e[y] per (term, edge) beside
//   them.  Each thread owns output columns of the fwd_groups / fwd_terms
//   tables: it forms the column's CG product for every edge of the tile in
//   registers (each term's table entry read once a tile), then walks the
//   edges in stream order keeping the column's running sum, and writes it
//   out where the destination changes.  Within a tile every output is one
//   thread's fixed-order sum.
// - Destinations split across tiles (cg_fwd.cuh, shared with K4 and K6):
//   a tile whose last segment continues into the next tile writes that part
//   to its row of carry [n_tiles, mid_dim]; every other segment goes to out
//   (a segment that began in an earlier tile is the final part of its
//   node).  A second launch, one warp per node, writes the zero rows of
//   degree-0 and padding nodes and, for each node whose edges span tiles
//   t0 < t1, out[n] = carry[t0] + ... + carry[t1 - 1] + out[n] in tile
//   order.  No atomics: two calls give bitwise equal results.  The carry
//   rows (59 MB in layer 1 in f32) live only inside the call, so the
//   serving peak does not move; the owner-computes alternative (the tile
//   holding a node's first edge finishes it) would redo the MLP GEMM for
//   each tile's overflow edges (in K4 and K6, which have no GEMM, it was
//   timed and was slower: PERF.md).
// - Shared memory: w [TILE][WN], then one region that holds h and the ring
//   during the GEMM and x rows and c * y during the CG product, ~103 KB for
//   a 32-edge f32 tile of layer 1, so two blocks share an SM (registers
//   capped at 128); f64 takes one block an SM, and wider models 16- or
//   8-edge tiles where a 32-edge one does not fit a block.
// Measured (chip_smoke.py phase 2; H100 80GB HBM3, 700 W; PERF.md, K1
// findings): 0.99 / 2.59 / 0.99 ms for the three layers, ~4.6x its bound.
// In scratch builds (clock64 marks per phase, and copies without the GEMM
// or without the CG product) the W2 GEMM took about half of K1 and the CG
// product and its sums about a fifth.  Tried there and slower or no
// faster: the term table in registers (up to 8 terms a column), each
// thread's column metadata in registers, CG steps of 8 or 16 edges instead
// of the whole tile.  Kept, each a small gain: tile_dst instead of a binary
// search per edge, and silu with the fast exp and division in f32.
// Registers and spills (nvcc -Xptxas -v): f32 32-edge tile 128 (two
// blocks an SM), 4 bytes of spill; one block an SM 183; 16-edge 223,
// 8-edge 218; f64 32-edge 246 (two blocks: 128), 16-edge 244, 8-edge 244;
// none spill but the first; the second launch 31-32.
//
// bf16 (the fast mode: nequip_conv_fwd_bf16): x, sh, emb, W1, W2 and out
// are bf16 in device memory; the kernel is the f32 design on a float32
// tile (its shared-memory layout and tile choice are f32's), every operand
// widened as it is staged (plain loads: cp.async has no 2-byte copy) and
// every product and sum taken in float32.  Rounding points, the same in
// the plain version (tp_scatter.conv_fwd_plain): w = alpha1 h . W2 is
// rounded to bf16 (where JAX's K1 rounds it; h stays float32, as in JAX),
// and each output element once, on its store.  JAX sums each chunk's
// messages into a bf16 block; here the sums over edges are compensated
// float32 sums (hi + lo, cgf::cg_forward_compensated), the parts of a
// destination that tiles split too: a tile writes the part of its first
// destination that began in an earlier tile to a second carry slot (carry
// [n_tiles][2][2][mid_dim], float32 hi and lo rows), and the second launch
// rounds carry[t0][0] + ... + carry[t1 - 1][0] + carry[t1][1] once.  Why
// compensated: with plain float32 sums the bf16 output depends on how a
// destination's edges fall into tiles, and an MD neighbour list rebuilt at
// another step (the same pairs within r_max, other pairs in the skin, whose
// messages are zero) tiles them otherwise; about 2^-16 of the outputs then
// round the other way, and host and block MD of the 23k-atom flagship
// drifted 5.4e-5 A apart in 60 steps (PERF.md, bf16 findings).  A compensated sum
// is the exact sum to about n 2^-48 of its terms, whatever the grouping.
#include <type_traits>

#include "cg_fwd.cuh"
#include "dense_tiles.cuh"
#include "radial_mlp.cuh"

namespace nequip {
namespace {

constexpr int kFwdThreads = 256;  // tile_gemm's 8 warps
constexpr int kFwdBK = 16;        // W2 rows per slab of the ring
constexpr int kFwdStages = 3;

// S: the storage type of the operands and out; the kernel computes in
// Acc<S> (tp_common.cuh), the type of the tables, the carry rows and alphas
template <typename S>
struct ConvFwdArgs {
  const S *x, *sh, *emb, *w1, *w2;
  const int32_t *edge_src, *dst_ptr;
  cgf::Tables<Acc<S>> tab;
  S* out;
  Acc<S>* carry;
  int n_nodes, dim_in, sh_dim, n_emb, hidden, wn, mid_dim;
  Acc<S> alpha0, alpha1;
};

// Shared-memory carve-up of one tile, in elements of T from the base (every
// region starts on 16 bytes), then int32 s_dst [TILE] and two flags.  The
// region at o_u holds h [TILE][ldh] and the ring during the GEMM, then x
// [TILE][dim_in] and, at o_u + o_cy, c * y [n_terms][TILE].
struct FwdSmem {
  int ldw, ldh, ldw1;  // row strides of s_w [TILE][ldw], s_h [TILE][ldh], s_w1 [n_emb][ldw1]
  int o_u, o_cy, o_emb, o_y, o_w1, o_idx;
  size_t bytes;
};

template <typename T>
__host__ __device__ inline FwdSmem fwd_smem(int tile, int dim_in, int sh_dim, int n_emb, int hidden, int wn,
                                           int n_terms) {
  constexpr int V = mlp::Vec<T>::V, CW = 32 * V;
  FwdSmem L;
  L.ldw = mlp::round_up(wn, CW);         // whole column chunks: the GEMM's epilogue writes them
  L.ldh = mlp::round_up(hidden, kFwdBK);  // whole k-slabs, zero past hidden
  L.ldw1 = mlp::round_up(hidden, V);
  int o = tile * L.ldw;
  L.o_u = o;
  const int gemm = tile * L.ldh + mlp::ring_elems<T, kFwdBK, kFwdStages>();
  L.o_cy = mlp::round_up(tile * dim_in, V);
  const int cg = L.o_cy + tile * n_terms;
  o += mlp::round_up(gemm > cg ? gemm : cg, V);
  L.o_emb = o;
  o += mlp::round_up(tile * n_emb, V);
  L.o_y = o;
  o += mlp::round_up(tile * sh_dim, V);
  L.o_w1 = o;
  o += mlp::round_up(n_emb * L.ldw1, V);
  L.o_idx = o;
  L.bytes = static_cast<size_t>(o) * sizeof(T) + sizeof(int32_t) * (tile + 2);
  return L;
}

// silu(x) = x * sigmoid(x); in f32 with the fast exp and division (a few
// ulp, far inside K1's tolerance), in f64 as written
__device__ __forceinline__ float silu(float x) { return __fdividef(x, 1.f + __expf(-x)); }
__device__ __forceinline__ double silu(double x) { return x * sigmoid(x); }

template <typename S, int TILE, int MIN_BLOCKS>
__global__ void __launch_bounds__(kFwdThreads, MIN_BLOCKS) conv_fwd_kernel(const ConvFwdArgs<S> a) {
  using T = Acc<S>;  // shared memory, registers and sums
  constexpr bool kRound = !std::is_same<S, T>::value;  // bf16: round on the stores (see the header)
  constexpr int NT = kFwdThreads, TE = TILE / 8, V = mlp::Vec<T>::V;  // TE: rows a thread owns in the GEMM
  static_assert(TILE % 8 == 0 && TILE <= 32, "one warp finds the tile's destinations");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hidden = a.hidden, wn = a.wn, n_emb = a.n_emb, sh_dim = a.sh_dim, dim_in = a.dim_in;
  const int mid_dim = a.mid_dim;
  const FwdSmem L = fwd_smem<T>(TILE, dim_in, sh_dim, n_emb, hidden, wn, a.tab.n_terms);
  T* base_t = reinterpret_cast<T*>(smem_raw);
  T* s_w = base_t;                // [TILE][ldw]
  T* s_h = base_t + L.o_u;        // [TILE][ldh], during the GEMM
  T* s_ring = s_h + TILE * L.ldh;  // the W2 ring, during the GEMM
  T* s_x = base_t + L.o_u;        // [TILE][dim_in], after the GEMM
  T* s_cy = s_x + L.o_cy;         // [n_terms][TILE], after the GEMM
  T* s_emb = base_t + L.o_emb;    // [TILE][n_emb]
  T* s_y = base_t + L.o_y;        // [TILE][sh_dim]
  T* s_w1 = base_t + L.o_w1;      // [n_emb][ldw1]
  int32_t* s_dst = reinterpret_cast<int32_t*>(base_t + L.o_idx);  // [TILE]
  int32_t* s_flags = s_dst + TILE;  // [0]: bit e set where edge e ends its segment in the tile; [1]: carry

  const int tid = threadIdx.x;
  const int n_real = __ldg(a.dst_ptr + a.n_nodes);
  const int n_tiles = mlp::cdiv(n_real, TILE);
  if (static_cast<int>(blockIdx.x) >= n_tiles) return;
  for (int i = tid; i < n_emb * L.ldw1; i += NT) {
    const int r = i / L.ldw1, c = i - r * L.ldw1;
    s_w1[i] = c < hidden ? widen(a.w1[r * hidden + c]) : T(0);
  }

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int base = tile * TILE;
    const int cnt = min(TILE, n_real - base);
    __syncthreads();  // s_w1 is staged; the previous tile's readers are done
    if (tid < 32) cgf::tile_segments<TILE>(a.dst_ptr, a.n_nodes, base, cnt, s_dst, s_flags);  // warp 0
    for (int i = tid; i < TILE * n_emb; i += NT)
      s_emb[i] = i < cnt * n_emb ? widen(a.emb[static_cast<int64_t>(base) * n_emb + i]) : T(0);
    for (int i = tid; i < TILE * sh_dim; i += NT)
      s_y[i] = i < cnt * sh_dim ? widen(a.sh[static_cast<int64_t>(base) * sh_dim + i]) : T(0);
    __syncthreads();

    // hidden layer h = silu(h_pre), V columns of one edge per step, zero in the padding columns
    for (int i = tid; i < TILE * (L.ldh / V); i += NT) {
      const int e = i / (L.ldh / V), t0 = (i - e * (L.ldh / V)) * V;
      T hp[V] = {};
      if (t0 < hidden) mlp::hidden_pre(s_emb + e * n_emb, s_w1 + t0, L.ldw1, n_emb, a.alpha0, hp);
      T v[V];
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = t0 + j < hidden ? silu(hp[j]) : T(0);
      store16(s_h + e * L.ldh + t0, v);
    }
    // w = alpha1 * h . W2 (tile_gemm starts at a barrier: s_h is complete)
    mlp::tile_gemm<T, TILE, kFwdBK, kFwdStages>(
        s_h, L.ldh, a.w2, hidden, wn, s_ring, [&](int r0, int c0, T (&acc)[TE][V]) {
#pragma unroll
          for (int i = 0; i < TE; ++i) {
            T v[V];
#pragma unroll
            for (int j = 0; j < V; ++j) v[j] = round_as<S>(a.alpha1 * acc[i][j]);  // bf16: w rounded
            store16(s_w + (r0 + i) * L.ldw + c0, v);
          }
        });

    // x[src] rows into the region h and the ring held (tile_gemm ended at a
    // barrier with no copy in flight); rows past cnt are zero
    stage_rows<T, TILE, NT>(s_x, a.x, a.edge_src + base, cnt, dim_in, tid);
    cp_async_commit();
    cgf::scale_y<T, TILE, NT>(a.tab, s_y, sh_dim, s_cy, tid);  // c * y per (edge, term), while the rows land
    cp_async_wait<0>();
    __syncthreads();

    // CG product and segmented sum (cg_fwd.cuh); a last segment that
    // continues into the next tile goes to this tile's carry row
    const unsigned ends = static_cast<unsigned>(s_flags[0]);
    if constexpr (!kRound) {
      T* const carry_row = s_flags[1] ? a.carry + static_cast<int64_t>(tile) * mid_dim : nullptr;
      cgf::cg_forward<T, TILE, NT>(
          a.tab, s_cy, s_x, dim_in, s_w, L.ldw, mid_dim, ends, [&](int o, int e, T v) {
            T* row = (e == cnt - 1 && carry_row != nullptr) ? carry_row
                                                             : a.out + static_cast<int64_t>(s_dst[e]) * mid_dim;
            row[o] = v;
          });
    } else {
      // bf16: compensated sums; the tail part to carry [tile][0], the part
      // of a first destination that began in an earlier tile to [tile][1]
      // (each as hi, lo rows), every other segment rounded once into out
      static_assert(std::is_same<S, __nv_bfloat16>::value, "the compensated form writes bf16");
      T* const tail_row = s_flags[1] ? a.carry + static_cast<int64_t>(4 * tile) * mid_dim : nullptr;
      const bool head = __ldg(a.dst_ptr + s_dst[0]) < base;
      T* const head_row = head ? a.carry + static_cast<int64_t>(4 * tile + 2) * mid_dim : nullptr;
      const int first_end = __ffs(static_cast<int>(ends)) - 1;  // the tile's last edge always ends a segment
      cgf::cg_forward_compensated<TILE, NT>(
          a.tab, s_cy, s_x, dim_in, s_w, L.ldw, mid_dim, ends, [&](int o, int e, const SumF32x2& v) {
            T* const row = (e == cnt - 1 && tail_row != nullptr) ? tail_row
                           : (e == first_end && head_row != nullptr) ? head_row : nullptr;
            if (row != nullptr) {
              row[o] = v.hi;
              row[mid_dim + o] = v.lo;
            } else {
              a.out[static_cast<int64_t>(s_dst[e]) * mid_dim + o] = bf16_of_sum(v.hi, v.lo);
            }
          });
    }
  }
}

// shared memory of one block: the tile is Acc<S> whatever S (bf16 tiles are f32's)
template <typename S>
size_t fwd_bytes(const ConvFwdArgs<S>& a, int tile) {
  return fwd_smem<Acc<S>>(tile, a.dim_in, a.sh_dim, a.n_emb, a.hidden, a.wn, a.tab.n_terms).bytes;
}

// The largest tile (32, 16 or 8 edges) whose shared memory fits one block,
// or 0 if none does.
template <typename S>
int pick_tile(const ConvFwdArgs<S>& a, const SmemLimits& lim) {
  const int tiles[] = {32, 16, 8};
  for (int tile : tiles)
    if (lim.fit(fwd_bytes(a, tile), 1)) return tile;
  return 0;
}

template <typename S, int TILE, int MIN_BLOCKS>
cudaError_t launch_tile(const ConvFwdArgs<S>& args, int dev, size_t smem, cudaStream_t stream) {
  auto kernel = conv_fwd_kernel<S, TILE, MIN_BLOCKS>;
  int grid = 0;
  const cudaError_t err = persistent_grid(kernel, kFwdThreads, dev, smem, grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kFwdThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

// Tile kernel, then the finish kernel (cg_fwd.cuh).  The 32-edge tile caps registers at
// 128 for two blocks an SM only where two fit in shared memory (f32 at the
// flagship's widths); `tile` must be pick_tile's (the caller sized carry
// [ceil(n_real / tile), mid_dim], bf16 [ceil(n_real / tile), 2, 2, mid_dim], by it).
template <typename S>
int launch_conv_fwd(const ConvFwdArgs<S>& args, int tile, void* stream) {
  if (args.n_nodes <= 0) return static_cast<int>(cudaGetLastError());
  SmemLimits lim;
  cudaError_t err = smem_limits(lim);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tile != pick_tile(args, lim)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fwd_bytes(args, tile);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile == 32)
    err = lim.fit(smem, 2) ? launch_tile<S, 32, 2>(args, lim.dev, smem, s) : launch_tile<S, 32, 1>(args, lim.dev, smem, s);
  else if (tile == 16)
    err = launch_tile<S, 16, 1>(args, lim.dev, smem, s);
  else
    err = launch_tile<S, 8, 1>(args, lim.dev, smem, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (std::is_same<S, Acc<S>>::value)
    return static_cast<int>(cgf::launch_finish<S, 1, false>(args.dst_ptr, args.carry, args.out, nullptr,
                                                            args.n_nodes, args.mid_dim, tile, s));
  else
    return static_cast<int>(cgf::launch_finish_compensated<S, 1, false>(args.dst_ptr, args.carry, args.out, nullptr,
                                                                        args.n_nodes, args.mid_dim, tile, s));
}

// pick_tile for the given widths on the current device; a CUDA error as -err
template <typename S>
int conv_fwd_tile(int dim_in, int sh_dim, int n_emb, int hidden, int wn, int n_terms) {
  SmemLimits lim;
  const cudaError_t err = smem_limits(lim);
  if (err != cudaSuccess) return -static_cast<int>(err);
  ConvFwdArgs<S> a{};
  a.dim_in = dim_in, a.sh_dim = sh_dim, a.n_emb = n_emb, a.hidden = hidden, a.wn = wn, a.tab.n_terms = n_terms;
  return pick_tile(a, lim);
}

}  // namespace
}  // namespace nequip

#define NEQUIP_CONV_FWD(SUFFIX, T)                                                                               \
  extern "C" int nequip_conv_fwd_tile_##SUFFIX(int dim_in, int sh_dim, int n_emb, int hidden, int wn,           \
                                               int n_terms) {                                                   \
    return nequip::conv_fwd_tile<T>(dim_in, sh_dim, n_emb, hidden, wn, n_terms);                                \
  }                                                                                                             \
  extern "C" int nequip_conv_fwd_##SUFFIX(                                                                      \
      const void* x, const void* sh, const void* emb, const void* w1, const void* w2, const void* edge_src,     \
      const void* dst_ptr, const void* groups, const void* terms, const void* coef, const void* col_group,       \
      void* out, void* carry, int n_nodes, int dim_in, int sh_dim, int n_emb, int hidden, int wn, int mid_dim,   \
      int n_terms, int tile, double alpha0, double alpha1, void* stream) {                                      \
    const nequip::ConvFwdArgs<T> args{                                                                          \
        static_cast<const T*>(x),         static_cast<const T*>(sh),                                            \
        static_cast<const T*>(emb),       static_cast<const T*>(w1),                                            \
        static_cast<const T*>(w2),        static_cast<const int32_t*>(edge_src),                                \
        static_cast<const int32_t*>(dst_ptr),                                                                   \
        {static_cast<const int32_t*>(groups), static_cast<const int32_t*>(terms),                                \
         static_cast<const nequip::Acc<T>*>(coef), static_cast<const int32_t*>(col_group), n_terms},            \
        static_cast<T*>(out),             static_cast<nequip::Acc<T>*>(carry),                                  \
        n_nodes,                          dim_in,                                                               \
        sh_dim,                           n_emb,                                                                \
        hidden,                           wn,                                                                   \
        mid_dim,                          static_cast<nequip::Acc<T>>(alpha0),                                  \
        static_cast<nequip::Acc<T>>(alpha1)};                                                                   \
    return nequip::launch_conv_fwd<T>(args, tile, stream);                                                      \
  }

NEQUIP_CONV_FWD(f32, float)
NEQUIP_CONV_FWD(f64, double)
NEQUIP_CONV_FWD(bf16, __nv_bfloat16)
