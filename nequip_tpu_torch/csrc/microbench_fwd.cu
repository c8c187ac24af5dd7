// T1 and T3: the conv-block microbenchmark forward, one constant chunk of
// `be` edges computed `grid` times and accumulated into out [rows, mid_dim].
//
// Replaces the TPU kernels tools/kernel_microbench.py, make (T1, row layout,
// pallas_call at :142) and make_t (T3, feature-major layout, :271).  Each
// step computes the whole block of its variant:
//   dot        out += S^T broadcast(x[:, 0])          S[e, r] = (rel[e] == r)
//   mlp        w = silu(emb . W1) . W2;               out[0, :WN] += w[0]
//   cg         msg = TP(x, y, broadcast(x[:, 0]));    out[0] += msg[0]
//   full       out += S^T TP(x, y, silu(emb . W1) . W2)
//   xpose      x staged feature-major (the transpose alone); out[0, 0] += x[0, 0]
//   cg_t       msg = TP(x_t, y_t, w_t);               out[0, 0] += msg[0, 0]
//   full_t     full, with x, y transposed in the kernel, W1 [H, n_emb], W2 [WN, H]
//   full_t_pre full_t with x, y given feature-major [dim, be]
// The scatter is the sum over the chunk's edges into their `rel` rows (the
// TPU's one-hot matmul is its algorithm, not its function).  Where only row 0
// reaches `out` (mlp, cg, xpose, cg_t), the whole block is still written to
// shared memory every step, as the TPU writes it to VMEM, so the work stays.
// No step reuses another's result: a call does `grid` times the chunk's work.
//
// Design (K1's blocks on a column-split grid):
// - The plan's uvu paths are packed into column groups (ops/kernels/
//   microbench.py, fwd_groups): whole paths, at most 256 output columns a
//   group (one a thread), each group's shared memory within a block's 227
//   KB; at the tool's widths 4 groups of 224-256 columns (the slice alone
//   128 KB at 128 rows), one block an SM.  A block of the grid (range of
//   steps, group) keeps its group's slice out[:, cols] in shared memory for
//   all its steps and writes it once into partial[range]; a second launch
//   sums the ranges in order.  mlp and xpose take one group of every path.
// - A step is be / TILE tiles of TILE edges (32 in f32, as K1; 8 in f64,
//   where a 160-column f64 slice leaves room for no more).  The variants
//   that scatter sort each tile's edges by output row (warp 0, a tile
//   ahead) and stage the tile in that order, so a column sums each row's
//   messages in registers and then reads every row's slice entry before it
//   writes any: no read waits on a write (one read-modify-write after
//   another took ~60 cycles an edge).  No atomics: every slice entry is one
//   thread's fixed-order sum, so two calls are bitwise equal.
// - Rows are staged by cp.async into row-major tiles (T1; x only the
//   group's x chunks) or feature-major ones [feature][TILE + 1] (T3:
//   full_t and xpose transpose as they stage, cg_t and full_t_pre read
//   feature-major input); x and y land while the MLP runs.
// - The radial MLP: the first product in full (3% of its operations), the
//   second only for the group's w columns.  HIGHEST (f32, f64) is K1's block:
//   the hidden layer from a shared copy of W1, then radial_mlp.cuh's
//   tile_gemm with W2 (packed by group once per call by a first launch)
//   streaming through the cp.async ring.  DEFAULT (f32) runs both products
//   on the tensor cores, TF32 mma.sync m16n8k8 with f32 accumulators, both
//   operands in shared memory, rounded once with cvt.rna.tf32.f32 as they are
//   stored (tf32_round in microbench.py models it): W1^T and W2^T (the group's
//   columns, K-major) resident for the block's life, emb per tile, h as the
//   hidden layer writes it.  T1 puts edges on M (w = h . W2), T3 weights on M
//   (w^T = W2^T . h^T, the TPU's transposed product); both read the same
//   K-major arrays, row strides 4 past a multiple of 32 (no bank conflicts).
// - The CG product is cg_fwd.cuh's: c * y per (term, edge) once a tile
//   (scale_y, in h's room once w is computed; a feature-major copy for T3),
//   each column's product for every edge of the tile in registers
//   (product), then the column's messages go into its slice rows.
//
// What bounds it on an H100: operations (the chunk's inputs and out sit in
// L2); `full` at the tool's defaults is 2048 x (19.4 MFLOP of MLP products
// + 2.8 MFLOP of CG, scatter and silu) ~ 45 GFLOP, 0.68 ms at 67 TFLOP/s f32;
// DEFAULT's products at 495 TFLOP/s TF32 leave 0.165 ms.
// Measured (the tool, python -m nequip_tpu_torch.tools.kernel_microbench,
// PR 4's design and this one in turns in one call; H100 80GB HBM3, 700 W;
// PERF.md, PR 17): full HIGHEST 6.58 ms (PR 4's design 13.53), DEFAULT 3.66
// (9.48), full_t 3.64 (10.01), full_t_pre 3.52 (9.82), dot 0.69 (3.60), mlp
// 2.22 / 0.83 (8.19 / 3.38), xpose 0.13 (0.72).  What holds it: one block of
// 8 warps an SM (the slice fills shared memory) leaves every phase
// latency-bound.  Clock marks per 32-edge tile of thread 0
// (chip_mb_profile.py clocks, full DEFAULT): CG product and slice adds ~2.6K
// cycles, issuing the copies ~3.3K, the TF32 products ~3.8K (HIGHEST:
// tile_gemm ~18K, the W2 ring's latency with one block an SM; a 5-stage
// ring was no faster).
#include <type_traits>

#include "cg_fwd.cuh"
#include "radial_mlp.cuh"
#include "tp_common.cuh"

namespace nequip {
namespace mb {

enum Variant : int { kDot = 0, kMlp, kCg, kFull, kXpose, kCgT, kFullT, kFullTPre };

__host__ __device__ constexpr bool has_mlp(int v) { return v == kMlp || v == kFull || v == kFullT || v == kFullTPre; }
__host__ __device__ constexpr bool has_cg(int v) { return v == kCg || v == kFull || v == kCgT || v == kFullT || v == kFullTPre; }
__host__ __device__ constexpr bool has_scatter(int v) { return v == kDot || v == kFull || v == kFullT || v == kFullTPre; }
__host__ __device__ constexpr bool has_x(int v) { return v != kDot && v != kMlp; }      // x rows staged
__host__ __device__ constexpr bool has_x0(int v) { return v == kDot || v == kCg; }      // x[:, 0] staged
__host__ __device__ constexpr bool feature_major(int v) { return v >= kXpose; }         // T3
__host__ __device__ constexpr bool x_global_t(int v) { return v == kCgT || v == kFullTPre; }  // x, y given [dim, be]
__host__ __device__ constexpr bool w_global_t(int v) { return v == kFullT || v == kFullTPre; }  // W1 [H, n_emb], W2 [WN, H]

constexpr int kNT = 256;              // threads a block (tile_gemm's 8 warps)
constexpr int kBK = 16, kStages = 3;  // K1's W2 ring: rows a slab, slabs in flight

// The int32 table built by microbench.py (fwd_tables): the header, then one
// GInfo record per group, then the sections the header points at.
enum Head : int { h_n_groups, h_ginfo, h_gtab, h_gcol, h_gout, h_terms, h_wcols, h_xsegs, h_ldh, h_ldw1, h_ldb,
                  h_rows_p, h_n_cols_out, h_count };
enum GInfo : int { g_n_cols, g_col_base, g_gtab_base, g_n_w, g_w_base, g_term_base, g_n_terms, g_xseg_base,
                   g_n_xseg, g_xw, g_slice, g_blk, g_row0, g_w, g_h, g_w2, g_w1, g_emb, g_x, g_y, g_cy, g_x0,
                   g_rel, g_count };

template <typename T>
struct FwdArgs {
  const T *x, *y, *emb, *w1, *w2, *w_in;
  const int32_t *rel, *itab;
  const T *coef, *w2p;  // w2p: W2 packed by group ([H][n_w] each), HIGHEST
  T* partial;           // [n_ranges][rows_p][mid_dim]
  int rows, be, dim_in, sh_dim, n_emb, hidden, wn, mid_dim, grid, n_ranges;
};

// silu(x) = x * sigmoid(x); in f32 with the fast exp and division, as K1
__device__ __forceinline__ float silu(float x) { return __fdividef(x, 1.f + __expf(-x)); }
__device__ __forceinline__ double silu(double x) { return x * sigmoid(x); }

// A TF32 operand as it is stored in shared memory: f32 rounded to nearest
// (ties away from zero), the low 13 mantissa bits cleared
__device__ __forceinline__ float tf32_stage(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

// c[16x8] += a[16x8] b[8x8] on the tensor cores, TF32 operands, f32 accumulators
__device__ __forceinline__ void mma_frag(float (&c)[4], const float (&a)[4], const float (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(a[2])),
        "r"(__float_as_uint(a[3])), "r"(__float_as_uint(b[0])), "r"(__float_as_uint(b[1])));
}

// C [M][N] = A [M][K] . B^T, A row-major (row stride lda) and B K-major
// ([N][ldb]) in shared memory, holding TF32 values; M % 16 == N % 16 == K % 8
// == 0.  Each warp takes 16 x 16 blocks of C (two m16n8k8 tiles sharing the A
// fragment) and hands every value to epi(m, n, v).
template <typename Epi>
__device__ __forceinline__ void mma_smem(const float* A, int lda, const float* B, int ldb, int M, int N, int K,
                                         Epi&& epi) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int n_blk = N / 16;
  for (int item = threadIdx.x >> 5; item < (M / 16) * n_blk; item += kNT / 32) {
    const int m0 = item / n_blk * 16, n0 = item % n_blk * 16;
    float c[2][4] = {};
    const float* a0 = A + (m0 + gid) * lda + tig;
    const float* a1 = a0 + 8 * lda;
    const float* b0 = B + (n0 + gid) * ldb + tig;
    const float* b1 = b0 + 8 * ldb;
#pragma unroll 8
    for (int k0 = 0; k0 < K; k0 += 8) {
      const float fa[4] = {a0[k0], a1[k0], a0[k0 + 4], a1[k0 + 4]};
      const float fb0[2] = {b0[k0], b0[k0 + 4]};
      const float fb1[2] = {b1[k0], b1[k0 + 4]};
      mma_frag(c[0], fa, fb0);
      mma_frag(c[1], fa, fb1);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 8 * h + 2 * tig;
      epi(m0 + gid, n, c[h][0]);
      epi(m0 + gid, n + 1, c[h][1]);
      epi(m0 + gid + 8, n, c[h][2]);
      epi(m0 + gid + 8, n + 1, c[h][3]);
    }
  }
}

// Starts the element copies dst[e * dse + c * dsc] = src[p(e) * sse + c *
// ssc] for the TILE edges e and `width` features c, p(e) = perm[e] (the
// tile's edges in row order) or e.  Consecutive threads take consecutive
// edges (kEFast: a feature-major source) or features, every lane of a warp
// busy: the SM pays for these copies per instruction more than per byte (a
// warp a row, with rows of 8-9 elements, took 1.6x as long).
template <typename T, int TILE, bool kEFast>
__device__ __forceinline__ void stage(T* dst, int dse, int dsc, const T* __restrict__ src, int64_t sse, int64_t ssc,
                                      int width, const int32_t* perm, int tid) {
  for (int i = tid; i < TILE * width; i += kNT) {
    int e, c;
    if (kEFast) {
      c = i / TILE;
      e = i - c * TILE;
    } else {
      e = i / width;
      c = i - e * width;
    }
    cp_async_elem<sizeof(T)>(dst + e * dse + c * dsc, src + (perm ? perm[e] : e) * sse + c * ssc, true);
  }
}

// The same with 16-byte copies: dst[e * ld + c] = src[p(e) * sse + c],
// width, ld, sse and both bases multiples of 16 bytes
template <typename T, int TILE>
__device__ __forceinline__ void stage16(T* dst, int ld, const T* __restrict__ src, int64_t sse, int width,
                                        const int32_t* perm, int tid) {
  constexpr int V = 16 / sizeof(T);
  const int nv = width / V;
  for (int i = tid; i < TILE * nv; i += kNT) {
    const int e = i / nv, c = (i - e * nv) * V;
    cp_async_16(dst + e * ld + c, src + (perm ? perm[e] : e) * sse + c, true);
  }
}

// The same a warp a row, for T3's wide tiles: a row-major source
// (kByEdge: rows are edges, dst[e * dse + c * dsc] = src[p(e) * sse + c],
// the transposing copy of x) or a feature-major one (rows are features,
// dst[c * dsc + e] = src[c * ssc + p(e)]); rows of 32 or more elements fill
// the lanes, and a warp a row took 0.6x the flat mapping's time there
template <typename T, int TILE, bool kByEdge>
__device__ __forceinline__ void stage_wide(T* dst, int dse, int dsc, const T* __restrict__ src, int64_t sse,
                                           int64_t ssc, int width, const int32_t* perm, int tid) {
  const int lane = tid & 31;
  if (kByEdge) {
    for (int e = tid >> 5; e < TILE; e += kNT / 32) {
      const T* row = src + (perm ? perm[e] : e) * sse;
      for (int c = lane; c < width; c += 32) cp_async_elem<sizeof(T)>(dst + e * dse + c * dsc, row + c, true);
    }
  } else {
    for (int c = tid >> 5; c < width; c += kNT / 32)
      for (int e = lane; e < TILE; e += 32)
        cp_async_elem<sizeof(T)>(dst + c * dsc + e, src + c * ssc + (perm ? perm[e] : e), true);
  }
}

// Warp 0: the tile's TILE edges sorted by output row, stably (rel: lane e's
// row, below 2^nbits; lanes >= TILE take no part), into one buffer of the
// row-order table [perm TILE][row TILE][ends]: perm[j] the edge at sorted
// place j, row[j] its row, bit j of ends set where j is the last edge of its
// row.  Each lane's rank is found bit by bit from the top, one ballot a bit
// (the lanes whose rows agree so far, and how many of them fall below): 7
// rounds at 128 rows instead of 32 shuffles.
template <int TILE>
__device__ __forceinline__ void sort_rows(int rel, int32_t* tab, int lane, int nbits) {
  unsigned eq = TILE == 32 ? 0xffffffffu : (1u << TILE) - 1u;  // lanes whose rows agree with this lane's so far
  int rank = 0;
  for (int b = nbits - 1; b >= 0; --b) {
    const bool one = (rel >> b) & 1;
    const unsigned ones = __ballot_sync(0xffffffffu, one);
    if (one) rank += __popc(eq & ~ones);
    eq &= one ? ones : ~ones;
  }
  rank += __popc(eq & ((1u << lane) - 1u));
  if (lane < TILE) {
    tab[rank] = lane;
    tab[TILE + rank] = rel;
  }
  __syncwarp();
  const bool end = lane < TILE && (lane == TILE - 1 || tab[TILE + lane + 1] != tab[TILE + lane]);
  const unsigned ends = __ballot_sync(0xffffffffu, end);
  if (lane == 0) tab[2 * TILE] = static_cast<int32_t>(ends);
}

// One column's messages v[j] of a tile in row order (sort_rows' table
// `rows`) added into its slice column col[row * ld]: each row's messages
// summed in edge order, then every row's entry read before any is written
// (the rows differ, so the reads need not wait for the writes).
template <typename T, int TILE>
__device__ __forceinline__ void add_rows(T (&v)[TILE], const int32_t* rows, T* col, int ld) {
  const unsigned ends = static_cast<unsigned>(rows[2 * TILE]);
  T acc = T(0);
  int off[TILE];
  T old[TILE];
#pragma unroll
  for (int j = 0; j < TILE; ++j) {
    acc += v[j];
    if ((ends >> j) & 1u) {
      v[j] = acc;
      acc = T(0);
      off[j] = rows[TILE + j] * ld;
      old[j] = col[off[j]];
    }
  }
#pragma unroll
  for (int j = 0; j < TILE; ++j)
    if ((ends >> j) & 1u) col[off[j]] = old[j] + v[j];
}

// T3's c * y: cy[k][e] = coef[k] * y_t[y_index(k)][e] (cg_fwd.cuh's scale_y on a feature-major y tile)
template <typename T, int TILE>
__device__ __forceinline__ void scale_y_t(const cgf::Tables<T>& tab, const T* y_t, T* cy, int tid) {
  for (int i = tid; i < TILE * tab.n_terms; i += kNT) {
    const int k = i / TILE, e = i - k * TILE;
    cy[i] = __ldg(tab.coef + k) * y_t[__ldg(tab.terms + 2 * k + 1) * (TILE + 1) + e];
  }
}

// T3's column product (cg_fwd.cuh's product on a feature-major x tile; the same sums in the same order)
template <typename T, int TILE>
__device__ __forceinline__ void product_t(const cgf::Tables<T>& tab, const cgf::Column& c, const T* cy, const T* x_t,
                                          T (&m)[TILE]) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int e = 0; e < TILE; ++e) m[e] = T(0);
  for (int k = c.t0; k < c.t1; ++k) {
    const T* xr = x_t + (__ldg(tab.terms + 2 * k) + c.u) * (TILE + 1);
#pragma unroll
    for (int e0 = 0; e0 < TILE; e0 += V) {
      T cv[V];
      load16(cv, cy + k * TILE + e0);
#pragma unroll
      for (int j = 0; j < V; ++j) m[e0 + j] += cv[j] * xr[e0 + j];
    }
  }
}

template <typename T, int V, bool kTf32, int TILE>
__global__ void __launch_bounds__(kNT) mb_fwd_kernel(const FwdArgs<T> a) {
  constexpr bool kT = feature_major(V);
  constexpr int LDT = TILE + 1;  // row stride of a feature-major tile
  constexpr int VEC = mlp::Vec<T>::V, TE = TILE / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int32_t* itab = a.itab;
  const int32_t* gi = itab + __ldg(itab + h_ginfo) + g_count * blockIdx.y;
  const int n_cols = __ldg(gi + g_n_cols), n_w = __ldg(gi + g_n_w), xw = __ldg(gi + g_xw);
  const int ldh = __ldg(itab + h_ldh), ldw1 = __ldg(itab + h_ldw1), ldb = __ldg(itab + h_ldb);
  const int hidden = a.hidden, n_emb = a.n_emb, sh_dim = a.sh_dim, dim_in = a.dim_in, be = a.be;
  const int lde = kTf32 ? ldw1 : n_emb;  // emb row stride (TF32: W1^T's too)
  auto region = [&](int g) { return reinterpret_cast<T*>(smem_raw + __ldg(gi + g)); };
  T* s_slice = region(g_slice);  // [rows][n_cols], the group's out slice (scatter variants)
  T* s_blk = region(g_blk);      // the msg block of cg ([TILE][n_cols]) and cg_t ([n_cols][LDT])
  T* s_row0 = region(g_row0);    // row 0's sums (mlp, cg, xpose, cg_t)
  T* s_w = region(g_w);          // radial weights: [TILE][n_w] (T1) or [n_w][LDT] (T3)
  T* s_h = region(g_h);          // hidden layer [TILE][ldh]
  T* s_w2 = region(g_w2);        // HIGHEST: tile_gemm's ring; TF32: W2^T [n_w][ldb]
  T* s_w1 = region(g_w1);        // HIGHEST: W1 [n_emb][ldw1]; TF32: W1^T [H][ldw1]
  T* s_emb = region(g_emb);      // [TILE][lde]
  T* s_x = region(g_x);          // the group's x chunks: [TILE][xw] (T1) or [xw][LDT] (T3)
  T* s_y = region(g_y);          // [TILE][sh_dim] (T1) or [sh_dim][LDT] (T3)
  T* s_cy = region(g_cy);        // c * y [n_terms][TILE]
  T* s_x0 = region(g_x0);        // x[:, 0] [TILE]
  int32_t* s_rows = reinterpret_cast<int32_t*>(smem_raw + __ldg(gi + g_rel));  // [2][2 TILE + 1], sort_rows
  const int term_base = __ldg(gi + g_term_base), col_base = __ldg(gi + g_col_base);
  const cgf::Tables<T> tab{itab + __ldg(itab + h_gtab) + 4 * __ldg(gi + g_gtab_base),
                           itab + __ldg(itab + h_terms) + 2 * term_base, a.coef + term_base,
                           itab + __ldg(itab + h_gcol) + col_base, __ldg(gi + g_n_terms)};
  const int32_t* gout = itab + __ldg(itab + h_gout) + col_base;  // global column of each local one
  const int32_t* wcols = itab + __ldg(itab + h_wcols) + __ldg(gi + g_w_base);
  const int32_t* xsegs = itab + __ldg(itab + h_xsegs) + 2 * __ldg(gi + g_xseg_base);
  const int n_xseg = __ldg(gi + g_n_xseg);

  if (has_scatter(V))
    for (int i = tid; i < a.rows * n_cols; i += kNT) s_slice[i] = T(0);
  if (!has_scatter(V))
    for (int i = tid; i < (V == kMlp ? n_w : n_cols); i += kNT) s_row0[i] = T(0);
  if constexpr (has_mlp(V)) {  // the block's resident weights
    constexpr bool wt = w_global_t(V);
    if constexpr (kTf32) {
      for (int i = tid; i < hidden * n_emb; i += kNT) {  // W1^T [H][ldw1]
        const int t = wt ? i / n_emb : i % hidden, e = wt ? i % n_emb : i / hidden;
        s_w1[t * ldw1 + e] = tf32_stage(a.w1[i]);
      }
      for (int i = tid; i < hidden * n_w; i += kNT) {  // W2^T [n_w][ldb], the group's columns
        const int j = wt ? i / hidden : i % n_w, k = wt ? i % hidden : i / n_w;
        const int64_t src = wt ? static_cast<int64_t>(__ldg(wcols + j)) * hidden + k
                               : static_cast<int64_t>(k) * a.wn + __ldg(wcols + j);
        s_w2[j * ldb + k] = tf32_stage(a.w2[src]);
      }
    } else {
      for (int i = tid; i < n_emb * ldw1; i += kNT) {  // W1 [n_emb][ldw1], zero past H
        const int e = i / ldw1, t = i - e * ldw1;
        s_w1[i] = t < hidden ? a.w1[wt ? t * n_emb + e : e * hidden + t] : T(0);
      }
    }
  }

  // Scatter variants walk each tile's edges in row order and stage them in
  // that order (sort_rows, a tile ahead, two buffers; warp 0 holds the rows
  // of the next tile to sort in a register).
  const int lane = tid & 31;
  const int nbits = 32 - __clz(max(a.rows - 1, 1));  // bits of a row index
  int rel_next = 0;
  if (has_scatter(V) && tid < 32) {
    sort_rows<TILE>(lane < TILE ? __ldg(a.rel + lane) : 0, s_rows, lane, nbits);
    rel_next = lane < TILE ? __ldg(a.rel + TILE % be + lane) : 0;
  }
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * a.grid / a.n_ranges;
  const int64_t s1 = static_cast<int64_t>(blockIdx.x + 1) * a.grid / a.n_ranges;
  int tt = 0;  // tiles done by the block
  for (int64_t step = s0; step < s1; ++step) {
    for (int base = 0; base < be; base += TILE, ++tt) {
      __syncthreads();  // the previous tile's readers are done; the block's set-up is visible
      const int32_t* rows = s_rows + (tt & 1) * (2 * TILE + 1);  // this tile's row order
      const int32_t* perm = has_scatter(V) ? rows : nullptr;
      // what the MLP needs first (emb), and x[:, 0]
      if (has_mlp(V) && n_emb % VEC == 0)
        stage16<T, TILE>(s_emb, lde, a.emb + static_cast<int64_t>(base) * n_emb, n_emb, n_emb, perm, tid);
      else if (has_mlp(V))
        stage<T, TILE, false>(s_emb, lde, 1, a.emb + static_cast<int64_t>(base) * n_emb, n_emb, 1, n_emb, perm, tid);
      if (has_x0(V))
        stage<T, TILE, false>(s_x0, 1, 0, a.x + static_cast<int64_t>(base) * dim_in, dim_in, 0, 1, perm, tid);
      cp_async_commit();
      // this tile's x (the group's chunks), y and w_in; they land while the MLP runs
      if constexpr (has_x(V)) {
        for (int q = 0, lx = 0; q < n_xseg; ++q) {
          const int gx = __ldg(xsegs + 2 * q), wq = __ldg(xsegs + 2 * q + 1);
          if (x_global_t(V))  // x_t [dim_in, be] -> [xw][LDT]
            stage_wide<T, TILE, false>(s_x + lx * LDT, 0, LDT, a.x + static_cast<int64_t>(gx) * be + base, 0, be, wq, perm,
                                       tid);
          else if (kT)        // x [be, dim_in] -> [xw][LDT], transposed as it is staged
            stage_wide<T, TILE, true>(s_x + lx * LDT, 1, LDT, a.x + static_cast<int64_t>(base) * dim_in + gx, dim_in, 0, wq,
                                      perm, tid);
          else                // x -> [TILE][xw], 16-byte copies (chunk offsets and widths are multiples of 16)
            stage16<T, TILE>(s_x + lx, xw, a.x + static_cast<int64_t>(base) * dim_in + gx, dim_in, wq, perm, tid);
          lx += wq;
        }
      }
      if constexpr (has_cg(V)) {
        if (x_global_t(V))
          stage<T, TILE, true>(s_y, 1, LDT, a.y + base, 1, be, sh_dim, perm, tid);
        else
          stage<T, TILE, false>(s_y, kT ? 1 : sh_dim, kT ? LDT : 1, a.y + static_cast<int64_t>(base) * sh_dim, sh_dim, 1,
                                sh_dim, perm, tid);
      }
      if (V == kCgT)  // w_t [WN, be] -> [n_w][LDT], the group's rows, a warp a row
        for (int j = tid >> 5; j < n_w; j += kNT / 32)
          for (int e = lane; e < TILE; e += 32)
            cp_async_elem<sizeof(T)>(s_w + j * LDT + e, a.w_in + static_cast<int64_t>(__ldg(wcols + j)) * be + base + e,
                                     true);
      cp_async_commit();
      if (has_scatter(V) && tid < 32) {  // warp 0: the next tile's row order, while the copies fly
        sort_rows<TILE>(rel_next, s_rows + ((tt + 1) & 1) * (2 * TILE + 1), lane, nbits);
        rel_next = lane < TILE ? __ldg(a.rel + (base + 2 * TILE) % be + lane) : 0;
      }

      if constexpr (has_mlp(V)) {
        cp_async_wait<1>();  // emb has landed (for this thread's copies)
        if constexpr (kTf32) {  // round this thread's emb copies (stage16's or stage's) to TF32 in place
          const int w = n_emb % VEC == 0 ? VEC : 1, nv = n_emb / w;
          for (int i = tid; i < TILE * nv; i += kNT) {
            const int e = i / nv, c = (i - e * nv) * w;
            for (int j = 0; j < w; ++j) s_emb[e * lde + c + j] = tf32_stage(s_emb[e * lde + c + j]);
          }
        }
        __syncthreads();
        if constexpr (kTf32) {
          // h = silu(emb . W1), then w = h . W2 for the group's columns (T3: both transposed)
          if (!kT)
            mma_smem(s_emb, lde, s_w1, ldw1, TILE, hidden, n_emb,
                     [&](int m, int n, float v) { s_h[m * ldh + n] = tf32_stage(silu(v)); });
          else
            mma_smem(s_w1, ldw1, s_emb, lde, hidden, TILE, n_emb,
                     [&](int m, int n, float v) { s_h[n * ldh + m] = tf32_stage(silu(v)); });
          __syncthreads();
          if (!kT)
            mma_smem(s_h, ldh, s_w2, ldb, TILE, n_w, hidden, [&](int m, int n, float v) { s_w[m * n_w + n] = v; });
          else
            mma_smem(s_w2, ldb, s_h, ldh, n_w, TILE, hidden, [&](int m, int n, float v) { s_w[m * LDT + n] = v; });
        } else {
          // K1's block: h = silu(emb . W1), V columns of one edge a step, zero in the padding columns
          for (int i = tid; i < TILE * (ldh / VEC); i += kNT) {
            const int e = i / (ldh / VEC), t0 = (i - e * (ldh / VEC)) * VEC;
            T hp[VEC] = {};
            if (t0 < hidden) mlp::hidden_pre(s_emb + e * n_emb, s_w1 + t0, ldw1, n_emb, T(1), hp);
            T v[VEC];
#pragma unroll
            for (int j = 0; j < VEC; ++j) v[j] = t0 + j < hidden ? silu(hp[j]) : T(0);
            store16(s_h + e * ldh + t0, v);
          }
          // w = h . W2 for the group's columns, W2 through the ring (tile_gemm starts at a barrier)
          mlp::tile_gemm<T, TILE, kBK, kStages>(
              s_h, ldh, a.w2p + static_cast<int64_t>(hidden) * __ldg(gi + g_w_base), hidden, n_w, s_w2,
              [&](int r0, int c0, T (&acc)[TE][VEC]) {
                if (c0 >= n_w) return;  // a chunk's padding columns
#pragma unroll
                for (int i = 0; i < TE; ++i) {
                  if (kT) {
#pragma unroll
                    for (int j = 0; j < VEC; ++j) s_w[(c0 + j) * LDT + r0 + i] = acc[i][j];
                  } else {
                    store16(s_w + (r0 + i) * n_w + c0, acc[i]);
                  }
                }
              });
        }
      }
      cp_async_wait<0>();
      __syncthreads();  // every copy has landed, and w is complete
      if (V == kMlp && base == 0)
        for (int j = tid; j < n_w; j += kNT) s_row0[j] += s_w[j];

      if constexpr (has_cg(V)) {
        if (kT)
          scale_y_t<T, TILE>(tab, s_y, s_cy, tid);
        else
          cgf::scale_y<T, TILE, kNT>(tab, s_y, sh_dim, s_cy, tid);
        __syncthreads();
        // each thread owns its columns and walks the tile's edges in order
        for (int i = tid; i < n_cols; i += kNT) {
          const cgf::Column c = cgf::column(tab, i);
          T m[TILE];
          if (kT)
            product_t<T, TILE>(tab, c, s_cy, s_x, m);
          else
            cgf::product<T, TILE>(tab, c, s_cy, s_x, xw, m);
          if constexpr (has_scatter(V)) {
#pragma unroll
            for (int e = 0; e < TILE; ++e) m[e] *= kT ? s_w[c.wc * LDT + e] : s_w[e * n_w + c.wc];
            add_rows<T, TILE>(m, rows, s_slice + i, n_cols);
          } else {
#pragma unroll
            for (int e = 0; e < TILE; ++e) {
              const T we = V == kCg ? s_x0[e] : kT ? s_w[c.wc * LDT + e] : s_w[e * n_w + c.wc];
              const T msg = we * m[e];
              if (kT)
                s_blk[i * LDT + e] = msg;
              else
                s_blk[e * n_cols + i] = msg;
              if (e == 0 && base == 0) s_row0[i] += msg;
            }
          }
        }
      }
      if (V == kDot)
        for (int i = tid; i < n_cols; i += kNT) {
          T v[TILE];
#pragma unroll
          for (int e = 0; e < TILE; ++e) v[e] = s_x0[e];
          add_rows<T, TILE>(v, rows, s_slice + i, n_cols);
        }
      if (V == kXpose && base == 0 && tid == 0) s_row0[0] += s_x[0];
    }
  }

  // the block's sums into partial[range]: the slice, or row 0's entries below n_cols_out
  __syncthreads();
  const int rows_p = __ldg(itab + h_rows_p), n_cols_out = __ldg(itab + h_n_cols_out);
  T* part = a.partial + static_cast<int64_t>(blockIdx.x) * rows_p * a.mid_dim;
  if (has_scatter(V)) {
    for (int i = tid; i < a.rows * n_cols; i += kNT) {
      const int r = i / n_cols, c = i - r * n_cols;
      part[static_cast<int64_t>(r) * a.mid_dim + __ldg(gout + c)] = s_slice[i];
    }
  } else if (V == kMlp) {
    for (int j = tid; j < n_w; j += kNT) part[__ldg(wcols + j)] = s_row0[j];
  } else if (V == kXpose) {
    if (tid == 0) part[0] = s_row0[0];
  } else {
    for (int i = tid; i < n_cols; i += kNT)
      if (__ldg(gout + i) < n_cols_out) part[__ldg(gout + i)] = s_row0[i];
  }
}

// W2's columns by group for tile_gemm: group g's [H][n_w] block at row
// offset H * w_base, from W2 [H, WN] or (kWT) W2^T [WN, H]; one block a group
template <typename T, bool kWT>
__global__ void __launch_bounds__(kNT) mb_pack_w2(const T* __restrict__ w2, const int32_t* __restrict__ itab,
                                                  T* __restrict__ w2p, int hidden, int wn) {
  const int32_t* gi = itab + __ldg(itab + h_ginfo) + g_count * blockIdx.x;
  const int n_w = __ldg(gi + g_n_w), w_base = __ldg(gi + g_w_base);
  const int32_t* wcols = itab + __ldg(itab + h_wcols) + w_base;
  T* dst = w2p + static_cast<int64_t>(hidden) * w_base;
  for (int i = threadIdx.x; i < hidden * n_w; i += kNT) {
    const int k = i / n_w, j = i - k * n_w;
    dst[i] = kWT ? w2[static_cast<int64_t>(__ldg(wcols + j)) * hidden + k] : w2[static_cast<int64_t>(k) * wn + __ldg(wcols + j)];
  }
}

// out[r, c] = sum over ranges b, in order, of partial[b, r, c] for r <
// rows_p and c < n_cols, else zero
template <typename T>
__global__ void mb_reduce_kernel(const T* __restrict__ partial, T* __restrict__ out, int n_ranges, int rows,
                                 int rows_p, int mid_dim, int n_cols) {
  const int64_t n = static_cast<int64_t>(rows) * mid_dim, stride = static_cast<int64_t>(rows_p) * mid_dim;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int r = static_cast<int>(i / mid_dim), c = static_cast<int>(i - static_cast<int64_t>(r) * mid_dim);
    T acc = T(0);
    if (r < rows_p && c < n_cols)
      for (int b = 0; b < n_ranges; ++b) acc += partial[b * stride + i];
    out[i] = acc;
  }
}

// Calls f(kernel) with the kernel of `variant` (cudaErrorInvalidValue where
// there is none: TF32 exists for the MLP variants only).
template <typename T, bool kTf32, int TILE, typename F>
cudaError_t with_kernel(int variant, F&& f) {
#define NEQUIP_MB_CASE(V)                                      \
  case V:                                                      \
    if constexpr (!kTf32 || has_mlp(V))                        \
      return f(mb_fwd_kernel<T, V, kTf32, TILE>);              \
    return cudaErrorInvalidValue;
  switch (variant) {
    NEQUIP_MB_CASE(kDot)
    NEQUIP_MB_CASE(kMlp)
    NEQUIP_MB_CASE(kCg)
    NEQUIP_MB_CASE(kFull)
    NEQUIP_MB_CASE(kXpose)
    NEQUIP_MB_CASE(kCgT)
    NEQUIP_MB_CASE(kFullT)
    NEQUIP_MB_CASE(kFullTPre)
    default:
      return cudaErrorInvalidValue;
  }
#undef NEQUIP_MB_CASE
}

template <typename T>
constexpr int kTile = std::is_same<T, float>::value ? 32 : 8;  // microbench.py's TILE

template <typename T, typename F>
cudaError_t for_variant(int variant, int tf32, F&& f) {
  if (!tf32) return with_kernel<T, false, kTile<T>>(variant, f);
  if constexpr (std::is_same<T, float>::value) return with_kernel<T, true, kTile<T>>(variant, f);
  return cudaErrorInvalidValue;  // TF32 has no f64 form
}

// Blocks of the variant's kernel at `smem` bytes that are resident on one SM
// at once (the wrapper sizes the grid's step ranges by it); a CUDA error as -err
template <typename T>
int mb_fwd_blocks(int variant, int tf32, int smem) {
  int n = 0;
  const cudaError_t err = for_variant<T>(variant, tf32, [&](auto kernel) {
    const cudaError_t e = allow_dynamic_smem(kernel, smem);
    return e != cudaSuccess ? e : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kNT, smem);
  });
  if (err != cudaSuccess) {
    cudaGetLastError();  // leave no error set for the next launch
    return -static_cast<int>(err);
  }
  return n;
}

// The pack (HIGHEST MLP variants), the grid of (step range, column group)
// blocks, then the in-order sum of the ranges.
template <typename T>
int launch_mb_fwd(const FwdArgs<T>& a, T* w2p, T* out, int n_groups, int smem, int variant, int tf32,
                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.be % kTile<T> != 0 || a.n_ranges < 1 || a.n_ranges > a.grid || n_groups < 1 ||
      (tf32 && (a.hidden % 16 || a.n_emb % 8)))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if (has_mlp(variant) && !tf32) {
    if (w_global_t(variant))
      mb_pack_w2<T, true><<<n_groups, kNT, 0, s>>>(a.w2, a.itab, w2p, a.hidden, a.wn);
    else
      mb_pack_w2<T, false><<<n_groups, kNT, 0, s>>>(a.w2, a.itab, w2p, a.hidden, a.wn);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  err = for_variant<T>(variant, tf32, [&](auto kernel) {
    const cudaError_t e = allow_dynamic_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(a.n_ranges, n_groups), kNT, smem, s>>>(a);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows_p = has_scatter(variant) ? a.rows : 1;
  const int n_cols = variant == kMlp ? a.wn : (variant == kCgT || variant == kXpose) ? 1 : a.mid_dim;
  const int64_t n = static_cast<int64_t>(a.rows) * a.mid_dim;
  mb_reduce_kernel<T><<<static_cast<int>((n + 255) / 256), 256, 0, s>>>(a.partial, out, a.n_ranges, a.rows, rows_p,
                                                                      a.mid_dim, n_cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mb
}  // namespace nequip

#define NEQUIP_MB_FWD(SUFFIX, T)                                                                              \
  extern "C" int nequip_mb_fwd_blocks_##SUFFIX(int variant, int tf32, int smem) {                             \
    return nequip::mb::mb_fwd_blocks<T>(variant, tf32, smem);                                                  \
  }                                                                                                           \
  extern "C" int nequip_mb_fwd_##SUFFIX(                                                                     \
      const void* x, const void* y, const void* emb, const void* rel, const void* w1, const void* w2,       \
      const void* w_in, const void* itab, const void* coef, void* w2p, void* partial, void* out, int rows,   \
      int be, int dim_in, int sh_dim, int n_emb, int hidden, int wn, int mid_dim, int grid, int n_ranges,    \
      int n_groups, int smem, int variant, int tf32, void* stream) {                                         \
    const nequip::mb::FwdArgs<T> a{static_cast<const T*>(x),       static_cast<const T*>(y),                 \
                                   static_cast<const T*>(emb),     static_cast<const T*>(w1),                \
                                   static_cast<const T*>(w2),      static_cast<const T*>(w_in),              \
                                   static_cast<const int32_t*>(rel), static_cast<const int32_t*>(itab),      \
                                   static_cast<const T*>(coef),    static_cast<const T*>(w2p),               \
                                   static_cast<T*>(partial),       rows,                                     \
                                   be,                             dim_in,                                   \
                                   sh_dim,                         n_emb,                                    \
                                   hidden,                         wn,                                       \
                                   mid_dim,                        grid,                                     \
                                   n_ranges};                                                                \
    return nequip::mb::launch_mb_fwd<T>(a, static_cast<T*>(w2p), static_cast<T*>(out), n_groups, smem,       \
                                        variant, tf32, stream);                                              \
  }

NEQUIP_MB_FWD(f32, float)
NEQUIP_MB_FWD(f64, double)
