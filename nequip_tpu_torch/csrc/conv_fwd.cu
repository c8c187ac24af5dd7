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
// are bf16 in device memory; every sum is taken in float32.  Rounding
// points, the same in the plain version (tp_scatter.conv_fwd_plain): w =
// alpha1 h . W2 is rounded to bf16 (where JAX's K1 rounds it; h stays
// float32, as JAX's K1 keeps h_t in its accumulation dtype), and each output
// element once, on its store.  JAX sums each chunk's messages into a bf16
// block; here the sums over edges are compensated float32 sums (hi + lo,
// cgf::cg_forward_compensated), the parts of a destination that tiles split
// too: a tile writes the part of its first destination that began in an
// earlier tile to a second carry slot (carry [n_tiles][2][2][mid_dim],
// float32 hi and lo rows), and the second launch rounds carry[t0][0] + ... +
// carry[t1 - 1][0] + carry[t1][1] once.  Why compensated: with plain float32
// sums the bf16 output depends on how a destination's edges fall into tiles,
// and an MD neighbour list rebuilt at another step (the same pairs within
// r_max, other pairs in the skin, whose messages are zero) tiles them
// otherwise; about 2^-16 of the outputs then round the other way, and host
// and block MD of the 23k-atom flagship drifted 5.4e-5 A apart in 60 steps
// (PERF.md, bf16 findings).  A compensated sum is the exact sum to about n
// 2^-48 of its terms, whatever the grouping.
// Design (the first bf16 form ran the f32 design on a float32 tile:
// every operand widened by plain loads as it was staged, the W2 product on
// FFMA with each W2 slab widened through registers; 5.80 ms over the three
// layers against f32's 4.71):
// - The W2 product runs on the tensor cores (radial_mlp.cuh tile_mma, as
//   K2's bf16 form): bf16 mma.sync m16n8k16 with float32 accumulators, W2
//   streamed raw through a bf16 cp.async ring (kMmaStages slabs of kMmaBK
//   rows x 128 columns, rows padded by 16 bytes), B fragments by
//   ldmatrix.trans.  h stays a float32 tile (its rows 8 floats past a
//   multiple of 32, so the float2 A loads of a warp's 8 rows fall on other
//   banks) and enters as two bf16 terms, hi = bf16(h) and lo = bf16(h - hi)
//   (MmaRowsSplit), two MMAs a fragment into the same accumulators:
//   float32's product to ~2^-17 relative before w's rounding
//   (tests/test_torch_port_bf16_mma.py models it).  The epilogue rounds
//   alpha1 * acc to bf16 once into s_w, a bf16 tile.  Each output of the
//   product depends only on its row of h and its column of W2, summed in a
//   fixed order of k16 steps: a row's w does not depend on its place in the
//   tile or on the tile's size (an 8-row tile's m16 tile reads its rows
//   again past row 8, whose products are not stored), so the compensated
//   sums keep each output independent of how the edges fall into tiles.
// - The operand tiles stay bf16 in shared memory: emb and y come in raw by
//   16-byte cp.async (stage_flat: a y row is 9 values, so an edge's row
//   starts at any 2-byte phase), the x[src] rows by stage_rows on the
//   storage type, W1 once a block by plain 2-byte copies; hidden_pre,
//   scale_y and cg_forward_compensated widen each value where they read it.
//   c * y stays a float32 tile.  fwd_smem<float, bf16> counts the bf16
//   regions in elements of bf16: a 32-edge tile of layer 1 is w 25.1 KB,
//   then one region of h 17.4 and the ring 34.8 (x 18.4 and c * y 10.6 in
//   it after the product), emb, y and W1 3.2: 80.6 KB, two blocks an SM.
// - The walk forms a column's products kWalkPart = 8 edges at a time in a
//   rolled loop, the compensated sum carried across the parts in edge
//   order (cg_fwd.cuh; as K4's bf16 form does), so a 32-edge tile runs at
//   two blocks an SM in 128 registers without a spill (the whole tile at
//   once spilled 12 bytes; 16-edge parts 4).  The parts add in the same
//   order as one pass, so every part size gives the same sums.
// Launch shapes (chip_cg_profile.py --k1 --dtype bf16, the whole 23k-atom
// stream, the flagship's three layers summed; H100 80GB HBM3, 700 W): two
// blocks an SM of 32-edge tiles with 8-edge parts 3.438-3.497 ms (16-edge
// parts 3.455-3.471, the whole tile 3.961-3.979); three blocks an SM (80
// registers, a 3-slab or 2-slab ring) 3.040-3.079 with 8-edge parts, but
// one value spilled (4 bytes stored once, loaded at four phase starts),
// and without a spill only with 16-row slabs, 3.474; one block 5.465-5.694.
// Preset M's layer 1 at the chosen shape 3.359-3.365.  Registers
// (nvcc -Xptxas -v): 128 at two blocks, 142 (32-edge tiles at one), 153
// (16), 182 (8); no spills.
// Measured (chip_cg_profile.py --k1 --dtype bf16 --parent: the float-tile
// FFMA form built from the previous commit's sources, in turns in one
// process; H100 80GB HBM3, 700 W): 5.601-5.615 -> 3.455 ms over the three
// layers with 16-edge parts (the 8-edge parts kept: 3.438-3.497 in a later
// call; f32 in the same call 4.539-4.559); layer 1, cycles per tile of
// thread 0 (the parent / 8-edge parts): destinations and staging
// 9.7k / 3.3k, hidden layer 6.4k / 6.9k, w product 57.8k / 17.2k, x
// staging with c * y 6.1k / 3.6k, the compensated walk 40.0k / 29.7k; the
// finish launch 0.114 ms.  The walk, about 10 instructions an edge where
// f32 issues one FFMA (as in K4's bf16 form, tri_fwd.cu), is now the
// largest phase.
#include <type_traits>

#include "cg_fwd.cuh"
#include "dense_tiles.cuh"
#include "radial_mlp.cuh"

namespace nequip {
namespace {

constexpr int kFwdThreads = 256;  // tile_gemm's 8 warps
constexpr int kFwdBK = 16;        // W2 rows per slab of the ring
constexpr int kFwdStages = 3;
constexpr int kMmaBK = 32;        // bf16 (tile_mma): W2 rows per slab of the ring
constexpr int kMmaStages = 4;
constexpr int kWalkPart = 8;      // bf16: the edges whose column products the walk holds at once

// The bf16 instantiation runs its W2 product on the tensor cores
// (mlp::tile_mma) on bf16 tiles; f32 and f64 on FFMA (mlp::tile_gemm)
template <typename S>
constexpr bool kMma = std::is_same<S, __nv_bfloat16>::value;

template <int TILE>
constexpr int kPart = TILE < kWalkPart ? TILE : kWalkPart;

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

// Shared-memory carve-up of one tile, in elements of S from the base (every
// region starts on 16 bytes), then int32 s_dst [TILE] and two flags.  The
// region at o_u holds h [TILE][ldh] and the ring (at o_u + o_ring) during
// the W2 product, then x [TILE][dim_in] and, at o_u + o_cy, c * y
// [n_terms][TILE].  f32 and f64 (S = T): every region of T.  bf16 (S =
// __nv_bfloat16, T = float): w, x, emb, y and W1 are bf16 tiles, h and c * y
// float32 (two elements of S a value), the ring tile_mma's; emb and y have
// room for a 16-byte phase.
struct FwdSmem {
  int ldw, ldh, ldw1;  // row strides of s_w [TILE][ldw] (S), s_h [TILE][ldh] (T), s_w1 [n_emb][ldw1] (S)
  int o_u, o_ring, o_cy, o_emb, o_y, o_w1, o_idx;
  size_t bytes;
};

template <typename T, typename S = T>
__host__ __device__ inline FwdSmem fwd_smem(int tile, int dim_in, int sh_dim, int n_emb, int hidden, int wn,
                                           int n_terms) {
  FwdSmem L;
  if constexpr (kMma<S>) {
    constexpr int V = 16 / sizeof(S), R = sizeof(T) / sizeof(S);  // a 16-byte phase; elements of S a float
    auto up = [](int a) { return mlp::round_up(a, V); };
    L.ldw = padded_row(mlp::round_up(wn, mlp::kMmaCols));  // whole column chunks; the epilogue's 8 rows on other banks
    L.ldh = mlp::round_up(hidden, 32) + 8;  // whole k16 steps, zero past hidden; a warp's float2 A loads conflict-free
    L.ldw1 = mlp::round_up(hidden, 4);      // hidden_pre's 4-column loads
    L.o_u = up(tile * L.ldw);
    L.o_ring = R * tile * L.ldh;
    const int gemm = L.o_ring + mlp::mma_ring_bytes<kMmaBK, kMmaStages>() / static_cast<int>(sizeof(S));
    L.o_cy = up(tile * dim_in);
    const int cg = L.o_cy + R * tile * n_terms;
    int o = L.o_u + up(gemm > cg ? gemm : cg);
    L.o_emb = o;
    o += up(tile * n_emb + V - 1);
    L.o_y = o;
    o += up(tile * sh_dim + V - 1);
    L.o_w1 = o;
    o += up(n_emb * L.ldw1);
    L.o_idx = o;
    L.bytes = static_cast<size_t>(o) * sizeof(S) + sizeof(int32_t) * (tile + 2);
  } else {
    constexpr int V = mlp::Vec<T>::V, CW = 32 * V;
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
  }
  return L;
}

// silu(x) = x * sigmoid(x); in f32 with the fast exp and division (a few
// ulp, far inside K1's tolerance), in f64 as written
__device__ __forceinline__ float silu(float x) { return __fdividef(x, 1.f + __expf(-x)); }
__device__ __forceinline__ double silu(double x) { return x * sigmoid(x); }

template <typename S, int TILE, int MIN_BLOCKS>
__global__ void __launch_bounds__(kFwdThreads, MIN_BLOCKS) conv_fwd_kernel(const ConvFwdArgs<S> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (kMma<S>) {
    // bf16 (see the header): bf16 tiles, the W2 product on the tensor cores
    using T = Acc<S>;
    constexpr int NT = kFwdThreads, V = mlp::Vec<T>::V;
    static_assert(TILE % 8 == 0 && TILE <= 32, "one warp finds the tile's destinations");
    const int hidden = a.hidden, wn = a.wn, n_emb = a.n_emb, sh_dim = a.sh_dim, dim_in = a.dim_in;
    const int mid_dim = a.mid_dim;
    const FwdSmem L = fwd_smem<T, S>(TILE, dim_in, sh_dim, n_emb, hidden, wn, a.tab.n_terms);
    S* base_s = reinterpret_cast<S*>(smem_raw);
    S* s_w = base_s;                                           // [TILE][ldw]
    T* s_h = reinterpret_cast<T*>(base_s + L.o_u);             // [TILE][ldh], during the product
    S* s_ring = base_s + L.o_u + L.o_ring;                     // the W2 ring, during the product
    S* s_x = base_s + L.o_u;                                   // [TILE][dim_in], after the product
    T* s_cy = reinterpret_cast<T*>(base_s + L.o_u + L.o_cy);  // [n_terms][TILE], after the product
    S* s_w1 = base_s + L.o_w1;                                 // [n_emb][ldw1]
    int32_t* s_dst = reinterpret_cast<int32_t*>(base_s + L.o_idx);  // [TILE]
    int32_t* s_flags = s_dst + TILE;  // [0]: bit e set where edge e ends its segment in the tile; [1]: carry

    const int tid = threadIdx.x;
    const int n_real = __ldg(a.dst_ptr + a.n_nodes);
    const int n_tiles = mlp::cdiv(n_real, TILE);
    if (static_cast<int>(blockIdx.x) >= n_tiles) return;
    for (int i = tid; i < n_emb * L.ldw1; i += NT) {
      const int r = i / L.ldw1, c = i - r * L.ldw1;
      s_w1[i] = c < hidden ? a.w1[r * hidden + c] : narrow<S>(T(0));
    }

    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int base = tile * TILE;
      const int cnt = min(TILE, n_real - base);
      const int64_t oe = static_cast<int64_t>(base) * n_emb, oy = static_cast<int64_t>(base) * sh_dim;
      __syncthreads();  // s_w1 is staged; the previous tile's readers are done
      stage_flat<S, NT>(base_s + L.o_emb, a.emb + oe, cnt * n_emb, TILE * n_emb, tid);
      stage_flat<S, NT>(base_s + L.o_y, a.sh + oy, cnt * sh_dim, TILE * sh_dim, tid);
      cp_async_commit();
      if (tid < 32) cgf::tile_segments<TILE>(a.dst_ptr, a.n_nodes, base, cnt, s_dst, s_flags);  // warp 0
      cp_async_wait<0>();
      __syncthreads();
      const S* s_emb = base_s + L.o_emb + staged_phase<S>(a.emb + oe);  // [TILE][n_emb]
      const S* s_y = base_s + L.o_y + staged_phase<S>(a.sh + oy);        // [TILE][sh_dim]

      // hidden layer h = silu(h_pre) in float32, V columns of one edge per step, zero in the padding columns
      for (int i = tid; i < TILE * (L.ldh / V); i += NT) {
        const int e = i / (L.ldh / V), t0 = (i - e * (L.ldh / V)) * V;
        T hp[V] = {};
        if (t0 < hidden) mlp::hidden_pre(s_emb + e * n_emb, s_w1 + t0, L.ldw1, n_emb, a.alpha0, hp);
        T v[V];
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = t0 + j < hidden ? silu(hp[j]) : T(0);
        store16(s_h + e * L.ldh + t0, v);
      }
      // w = alpha1 * h . W2 on the tensor cores, h as hi + lo bf16 terms, each w rounded once to bf16 into
      // s_w (tile_mma starts at a barrier: s_h is complete)
      mlp::tile_mma<TILE, kMmaBK, kMmaStages>(
          mlp::MmaRowsSplit<TILE>{s_h, L.ldh}, a.w2, hidden, wn, s_ring, [&](int r, int c, T v0, T v1) {
            *reinterpret_cast<__nv_bfloat162*>(s_w + r * L.ldw + c) =
                __floats2bfloat162_rn(a.alpha1 * v0, a.alpha1 * v1);
          });

      // x[src] rows, raw, into the region h and the ring held (tile_mma
      // ended at a barrier with no copy in flight); rows past cnt are zero
      stage_rows<S, TILE, NT>(s_x, a.x, a.edge_src + base, cnt, dim_in, tid);
      cp_async_commit();
      cgf::scale_y<T, TILE, NT>(a.tab, s_y, sh_dim, s_cy, tid);  // c * y per (edge, term), while the rows land
      cp_async_wait<0>();
      __syncthreads();

      // CG product and compensated sums: the tail part to carry [tile][0],
      // the part of a first destination that began in an earlier tile to
      // [tile][1] (each as hi, lo rows), every other segment rounded once into out
      const unsigned ends = static_cast<unsigned>(s_flags[0]);
      const auto slots = cgf::carry_slots<1>(a.dst_ptr, s_dst, s_flags, a.carry, tile, base, mid_dim);
      cgf::cg_forward_compensated<TILE, NT, kPart<TILE>>(
          a.tab, s_cy, s_x, dim_in, s_w, L.ldw, mid_dim, ends, [&](int o, int e, const SumF32x2& v) {
            if (T* const row = slots.at(e, cnt))
              slots.put(row, 0, o, v);
            else
              a.out[static_cast<int64_t>(s_dst[e]) * mid_dim + o] = bf16_of_sum(v.hi, v.lo);
          });
    }
  } else {
    using T = Acc<S>;  // shared memory, registers and sums
    constexpr int NT = kFwdThreads, TE = TILE / 8, V = mlp::Vec<T>::V;  // TE: rows a thread owns in the GEMM
    static_assert(TILE % 8 == 0 && TILE <= 32, "one warp finds the tile's destinations");
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
              for (int j = 0; j < V; ++j) v[j] = round_as<S>(a.alpha1 * acc[i][j]);
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
      T* const carry_row = s_flags[1] ? a.carry + static_cast<int64_t>(tile) * mid_dim : nullptr;
      cgf::cg_forward<T, TILE, NT>(
          a.tab, s_cy, s_x, dim_in, s_w, L.ldw, mid_dim, ends, [&](int o, int e, T v) {
            T* row = (e == cnt - 1 && carry_row != nullptr) ? carry_row
                                                             : a.out + static_cast<int64_t>(s_dst[e]) * mid_dim;
            row[o] = v;
          });
    }
  }
}

// shared memory of one block
template <typename S>
size_t fwd_bytes(const ConvFwdArgs<S>& a, int tile) {
  return fwd_smem<Acc<S>, S>(tile, a.dim_in, a.sh_dim, a.n_emb, a.hidden, a.wn, a.tab.n_terms).bytes;
}

// The launch shape: the largest tile (32, 16 or 8 edges) whose shared
// memory fits one block, 32-edge tiles at two blocks an SM where two fit,
// else one; tile 0 if none fits.
struct Shape {
  int tile, blocks;
};

template <typename S>
Shape pick_shape(const ConvFwdArgs<S>& a, const SmemLimits& lim) {
  for (const int tile : {32, 16, 8})
    if (lim.fit(fwd_bytes(a, tile), 1)) return {tile, tile == 32 && lim.fit(fwd_bytes(a, tile), 2) ? 2 : 1};
  return {0, 1};
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

// The kernel of launch shape sh: the 32-edge tile caps registers at 128 for
// two blocks an SM only where two fit in shared memory
template <typename S>
cudaError_t launch_shape(const ConvFwdArgs<S>& a, Shape sh, int dev, size_t smem, cudaStream_t s) {
  if (sh.tile == 32) return sh.blocks == 2 ? launch_tile<S, 32, 2>(a, dev, smem, s) : launch_tile<S, 32, 1>(a, dev, smem, s);
  if (sh.tile == 16) return launch_tile<S, 16, 1>(a, dev, smem, s);
  return launch_tile<S, 8, 1>(a, dev, smem, s);
}

// Tile kernel, then the finish kernel (cg_fwd.cuh).  `tile` must be
// pick_shape's (the caller sized carry [ceil(n_real / tile), mid_dim], bf16
// [ceil(n_real / tile), 2, 2, mid_dim], by it).
template <typename S>
int launch_conv_fwd(const ConvFwdArgs<S>& args, int tile, void* stream) {
  if (args.n_nodes <= 0) return static_cast<int>(cudaGetLastError());
  SmemLimits lim;
  cudaError_t err = smem_limits(lim);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Shape sh = pick_shape(args, lim);
  if (tile != sh.tile) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = launch_shape(args, sh, lim.dev, fwd_bytes(args, tile), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the second launch: the destinations that tiles split, and the rows of nodes without an edge
  if constexpr (kMma<S>)
    err = cgf::launch_finish_compensated<S, 1, false>(args.dst_ptr, args.carry, args.out, nullptr, args.n_nodes,
                                                      args.mid_dim, tile, s);
  else
    err = cgf::launch_finish<S, 1, false>(args.dst_ptr, args.carry, args.out, nullptr, args.n_nodes, args.mid_dim,
                                          tile, s);
  return static_cast<int>(err);
}

// pick_shape's tile for the given widths on the current device; a CUDA error as -err
template <typename S>
int conv_fwd_tile(int dim_in, int sh_dim, int n_emb, int hidden, int wn, int n_terms) {
  SmemLimits lim;
  const cudaError_t err = smem_limits(lim);
  if (err != cudaSuccess) return -static_cast<int>(err);
  ConvFwdArgs<S> a{};
  a.dim_in = dim_in, a.sh_dim = sh_dim, a.n_emb = n_emb, a.hidden = hidden, a.wn = wn, a.tab.n_terms = n_terms;
  return pick_shape(a, lim).tile;
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
