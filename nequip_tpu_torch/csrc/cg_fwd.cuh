// The CG forward of the uvu conv tensor product on a dense edge tile, shared
// by the kernels that sum per-edge messages into their destination rows: K1
// (conv_fwd.cu, the fused conv's forward, w from its radial MLP), K4
// (tri_fwd.cu, the trilinear forward, w given) and K6 (jvp_fwd.cu, the fr
// dual sweep's forward, two families at once).
//
// For an edge e (source s) and output column o = (path, m3, u):
//   m_e[o] = sum_terms c * y_e[y_index] * x[s, x_row + u]
//   out[dst_e, o] += w_e[w_off + u] * m_e[o]
// The tile's x[src] rows lie in shared memory (stage_rows), with c * y per
// (term, edge) beside them (scale_y: each term's table entry read once a
// tile, not once a column).  Each thread owns output columns: it forms the
// column's product for every edge of the tile in registers, then walks the
// edges in stream order keeping the column's running sum, and hands it out
// where a destination's segment ends (bit e of `ends`).  Within a tile every
// output is one thread's fixed-order sum; no atomics.
//
// What bounds the product: shared-memory wavefronts (chip_cg_profile.py
// clocks: the CG phase of K4's layer-1 tile runs near one wavefront a
// cycle).  A warp's lanes are the 32 channels of one (path, m3) row, so
// x[e][x_row + u] is one wavefront and c * y a broadcast; c * y is kept
// term-major, [k][TILE], so one 16-byte broadcast serves 4 (f32) or 2 (f64)
// edges.
//
// Destinations split across tiles (tile_segments, finish_split_rows): a
// tile whose last segment continues into the next tile writes that part to
// its carry row, every other segment to the output row; a second launch
// sums each split node's parts in tile order and writes the rows of nodes
// without an edge.  (K4 and K6 were also timed with owner-computes, the
// tile holding a node's first edge finishing it in chunks: slower,
// PERF.md.)
//
// The bf16 forms sum over edges in compensated float32
// (cg_forward_compensated, cg_forward_jvp_compensated), and a tile puts the
// part of a destination that another tile shares in float32 carry rows, hi
// and lo (carry_slots), so that each output is rounded once, from a sum that
// does not depend on how its edges fall into tiles
// (finish_split_rows_compensated).  The bf16 forms read bf16 tiles of x
// (tx), y (ty) and w (dw), staged raw (K1's w from its W2 product's
// epilogue, rounded once), and widen each value where it is read
// (S, the tiles' storage type: widening bf16 is exact, so the products and
// sums are the float32 tiles' bit for bit).  c * y (c * ty) is a float32
// tile in every form.  Their walks form a column's products PART edges at a
// time (the compensated sum carried across the parts in edge order, so the
// sums are those of one pass over the tile), which keeps the registers of
// the products and the two-word sums within what more blocks an SM allow.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "dense_tiles.cuh"

namespace nequip {
namespace cgf {

// TPPlan's forward tables (ops/kernels/tp_scatter.py): groups int32 [G, 4] =
// (out_row, w_off, t_begin, t_end), one per (path, m3); terms int32 [T, 2] =
// (x_row, y_index) with coef [T] = cg * path_weight; col_group int32
// [mid_dim], the group owning each output column.
template <typename T>
struct Tables {
  const int32_t *groups, *terms;
  const T* coef;
  const int32_t* col_group;
  int n_terms;
};

// cy[k * TILE + e] = coef[k] * y[e * ldy + y_index(k)] for the TILE edges
// of a tile (zero where y's rows are); cy 16-byte aligned; y of a storage
// type S, widened as it is read
template <typename T, int TILE, int NT, typename S>
__device__ __forceinline__ void scale_y(const Tables<T>& tab, const S* y, int ldy, T* cy, int tid) {
  for (int i = tid; i < TILE * tab.n_terms; i += NT) {
    const int k = i / TILE, e = i - k * TILE;
    cy[i] = __ldg(tab.coef + k) * widen(y[e * ldy + __ldg(tab.terms + 2 * k + 1)]);
  }
}

// output column o: channel u of its group, weight column wc, terms [t0, t1)
struct Column {
  int u, wc, t0, t1;
};

template <typename T>
__device__ __forceinline__ Column column(const Tables<T>& tab, int o) {
  const int32_t* gr = tab.groups + 4 * __ldg(tab.col_group + o);
  const int u = o - __ldg(gr);
  return {u, __ldg(gr + 1) + u, __ldg(gr + 2), __ldg(gr + 3)};
}

// m[e] = sum over the column's terms of cy[k][e] * x[e][x_row + u] for the
// N edges of a part of the tile (cy and x at the part's first edge, cy's
// rows TILE apart); x of a storage type S, widened as it is read
template <typename T, int TILE, int N = TILE, typename S>
__device__ __forceinline__ void product(const Tables<T>& tab, const Column& c, const T* cy, const S* x, int ldx,
                                        T (&m)[N]) {
  constexpr int V = 16 / sizeof(T);
  static_assert(TILE % V == 0 && N % V == 0, "whole 16-byte loads of c * y");
#pragma unroll
  for (int e = 0; e < N; ++e) m[e] = T(0);
  for (int k = c.t0; k < c.t1; ++k) {
    const int xr = __ldg(tab.terms + 2 * k) + c.u;
#pragma unroll
    for (int e0 = 0; e0 < N; e0 += V) {
      T cv[V];
      load16(cv, cy + k * TILE + e0);
#pragma unroll
      for (int j = 0; j < V; ++j) m[e0 + j] += cv[j] * widen(x[(e0 + j) * ldx + xr]);
    }
  }
}

// The column sums of one tile: for each column o of the thread, acc += w[e][wc]
// * m[e] edge by edge in stream order from zero; where bit e of `ends` is
// set (the tile's last edge always is), emit(o, e, acc) takes the segment's
// sum and the next starts from zero.
template <typename T, int TILE, int NT, typename Emit>
__device__ __forceinline__ void cg_forward(const Tables<T>& tab, const T* cy, const T* x, int ldx, const T* w,
                                           int ldw, int mid_dim, unsigned ends, Emit emit) {
  for (int o = threadIdx.x; o < mid_dim; o += NT) {
    const Column c = column(tab, o);
    T m[TILE];  // column o of each edge's CG product (zero on rows past the tile's edges)
    product<T, TILE>(tab, c, cy, x, ldx, m);
    T acc = T(0);
#pragma unroll
    for (int e = 0; e < TILE; ++e) {
      acc += w[e * ldw + c.wc] * m[e];
      if ((ends >> e) & 1u) {
        emit(o, e, acc);
        acc = T(0);
      }
    }
  }
}

// cg_forward for the bf16 forms of K1 (conv_fwd.cu) and K4 (tri_fwd.cu): the same products, each
// rounded to float32 once, summed into a compensated float32 sum
// (SumF32x2), which emit(o, e, sum) takes.  Its value does not depend on
// how the segment's edges fall into tiles, nor on zero terms among them,
// so a bf16 output rounded from it does not either (MD's neighbour lists,
// rebuilt at other steps, give other tilings of the same edges).  The
// column's products are formed PART edges at a time, the sum carried across
// the parts; x and w are tiles of a storage type S (float, or bf16 widened
// as read).
template <int TILE, int NT, int PART = TILE, typename S, typename Emit>
__device__ __forceinline__ void cg_forward_compensated(const Tables<float>& tab, const float* cy, const S* x, int ldx,
                                                       const S* w, int ldw, int mid_dim, unsigned ends, Emit emit) {
  static_assert(TILE % PART == 0, "whole parts");
  for (int o = threadIdx.x; o < mid_dim; o += NT) {
    const Column c = column(tab, o);
    SumF32x2 acc;
    auto part = [&](int e0) {  // the products of edges [e0, e0 + PART), then their sums
      float m[PART];
      product<float, TILE, PART>(tab, c, cy + e0, x + e0 * ldx, ldx, m);
#pragma unroll
      for (int j = 0; j < PART; ++j) {
        const int e = e0 + j;
        acc.add(__fmul_rn(widen(w[e * ldw + c.wc]), m[j]));
        if ((ends >> e) & 1u) {
          emit(o, e, acc);
          acc = SumF32x2{};
        }
      }
    };
    if constexpr (PART == TILE) {
      part(0);
    } else {
#pragma unroll 1
      for (int e0 = 0; e0 < TILE; e0 += PART) part(e0);  // rolled: one part's offsets live at a time
    }
  }
}

// m[e] and tm[e] of the fr dual sweep for column c: with tangents tx (rows
// beside x) and c * ty (cty, laid out as cy),
//   m = sum c y x,  tm = sum c (ty x + y tx)
// for the N edges of a part of the tile, as product
template <typename T, int TILE, int N = TILE, typename S>
__device__ __forceinline__ void product_jvp(const Tables<T>& tab, const Column& c, const T* cy, const T* cty,
                                            const S* x, const S* tx, int ldx, T (&m)[N], T (&tm)[N]) {
  constexpr int V = 16 / sizeof(T);
  static_assert(TILE % V == 0 && N % V == 0, "whole 16-byte loads of c * y");
#pragma unroll
  for (int e = 0; e < N; ++e) m[e] = tm[e] = T(0);
  for (int k = c.t0; k < c.t1; ++k) {
    const int xr = __ldg(tab.terms + 2 * k) + c.u;
#pragma unroll
    for (int e0 = 0; e0 < N; e0 += V) {
      T cv[V], ctv[V];
      load16(cv, cy + k * TILE + e0);
      load16(ctv, cty + k * TILE + e0);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int e = e0 + j;
        const T xa = widen(x[e * ldx + xr]);
        m[e] += cv[j] * xa;
        tm[e] += ctv[j] * xa + cv[j] * widen(tx[e * ldx + xr]);
      }
    }
  }
}

// The column sums of the fr dual sweep: with dw (beside w), per column and edge
//   acc += w m,     tacc += w tm + dw m
// both sums handed out together.
template <typename T, int TILE, int NT, typename Emit>
__device__ __forceinline__ void cg_forward_jvp(const Tables<T>& tab, const T* cy, const T* cty, const T* x,
                                               const T* tx, int ldx, const T* w, const T* dw, int ldw, int mid_dim,
                                               unsigned ends, Emit emit) {
  for (int o = threadIdx.x; o < mid_dim; o += NT) {
    const Column c = column(tab, o);
    T m[TILE], tm[TILE];
    product_jvp<T, TILE>(tab, c, cy, cty, x, tx, ldx, m, tm);
    T acc = T(0), tacc = T(0);
#pragma unroll
    for (int e = 0; e < TILE; ++e) {
      const T we = w[e * ldw + c.wc];
      acc += we * m[e];
      tacc += we * tm[e] + dw[e * ldw + c.wc] * m[e];
      if ((ends >> e) & 1u) {
        emit(o, e, acc, tacc);
        acc = tacc = T(0);
      }
    }
  }
}

// cg_forward_jvp for K6's bf16 form (jvp_fwd.cu): the same products, each
// w m, w tm and dw m rounded to float32 once and added to a compensated
// sum (SumF32x2, as cg_forward_compensated), both of which emit(o, e, sum,
// tsum) takes; PART edges' products at a time, from tiles of a storage
// type S, as cg_forward_compensated.
template <int TILE, int NT, int PART = TILE, typename S, typename Emit>
__device__ __forceinline__ void cg_forward_jvp_compensated(const Tables<float>& tab, const float* cy,
                                                           const float* cty, const S* x, const S* tx, int ldx,
                                                           const S* w, const S* dw, int ldw, int mid_dim,
                                                           unsigned ends, Emit emit) {
  static_assert(TILE % PART == 0, "whole parts");
  for (int o = threadIdx.x; o < mid_dim; o += NT) {
    const Column c = column(tab, o);
    SumF32x2 acc, tacc;
    auto part = [&](int e0) {  // the products of edges [e0, e0 + PART), then their sums
      float m[PART], tm[PART];
      product_jvp<float, TILE, PART>(tab, c, cy + e0, cty + e0, x + e0 * ldx, tx + e0 * ldx, ldx, m, tm);
#pragma unroll
      for (int j = 0; j < PART; ++j) {
        const int e = e0 + j;
        const float we = widen(w[e * ldw + c.wc]);
        acc.add(__fmul_rn(we, m[j]));
        tacc.add(__fmul_rn(we, tm[j]));
        tacc.add(__fmul_rn(widen(dw[e * ldw + c.wc]), m[j]));
        if ((ends >> e) & 1u) {
          emit(o, e, acc, tacc);
          acc = tacc = SumF32x2{};
        }
      }
    };
    if constexpr (PART == TILE) {
      part(0);
    } else {
#pragma unroll 1
      for (int e0 = 0; e0 < TILE; e0 += PART) part(e0);  // rolled: one part's offsets live at a time
    }
  }
}

constexpr int kFinishWarps = 8;  // nodes per block of finish_split_rows

// The second launch of the split-destination design: one warp per node.  A
// node's row holds what the tile with its last edge summed (onto the
// accumulator with kAcc); where its edges span tiles t0 < t1, the parts of
// tiles t0 .. t1 - 1 wait in their carry rows [n_tiles][NF][mid_dim] and
// the row becomes carry[t0] + ... + carry[t1 - 1] + row, in tile order.
// Rows of nodes with no real edge are set to zero, or with kAcc left as
// they are.  NF = 2 sums two outputs (K6's msg and tmsg).
template <typename T, int NF, bool kAcc>
__global__ void __launch_bounds__(32 * kFinishWarps) finish_split_rows(const int32_t* __restrict__ dst_ptr,
                                                                      const T* __restrict__ carry, T* __restrict__ out,
                                                                      T* __restrict__ tout, int n_nodes, int mid_dim,
                                                                      int tile) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kFinishWarps + (threadIdx.x >> 5);
  if (n >= n_nodes) return;
  const int b = __ldg(dst_ptr + n), e = __ldg(dst_ptr + n + 1);
  const int t0 = b / tile, t1 = (e - 1) / tile;
  if (b == e ? kAcc : t0 == t1) return;  // the accumulator's row, or written whole by its tile
  for (int f = 0; f < NF; ++f) {
    T* row = (f == 0 ? out : tout) + static_cast<int64_t>(n) * mid_dim;
    if (b == e) {
      for (int c = lane; c < mid_dim; c += 32) row[c] = T(0);
      continue;
    }
    for (int c = lane; c < mid_dim; c += 32) {
      T v = carry[(static_cast<int64_t>(t0) * NF + f) * mid_dim + c];
      for (int t = t0 + 1; t < t1; ++t) v += carry[(static_cast<int64_t>(t) * NF + f) * mid_dim + c];
      row[c] = v + row[c];
    }
  }
}

template <typename T, int NF, bool kAcc>
cudaError_t launch_finish(const int32_t* dst_ptr, const T* carry, T* out, T* tout, int n_nodes, int mid_dim, int tile,
                          cudaStream_t stream) {
  const int blocks = (n_nodes + kFinishWarps - 1) / kFinishWarps;
  finish_split_rows<T, NF, kAcc><<<blocks, 32 * kFinishWarps, 0, stream>>>(dst_ptr, carry, out, tout, n_nodes,
                                                                           mid_dim, tile);
  return cudaGetLastError();
}

// Where the bf16 forms of K4 and K6 put a tile's compensated segment sums
// (hi, lo) that another tile shares (K1's bf16 form, conv_fwd.cu, writes
// the same layout with NF = 1 inline): carry rows [n_tiles][2][2][NF][mid_dim] of float32,
// per tile two slots, each a hi row then a lo row of NF outputs (K6: msg
// and tmsg).  Slot 0 takes the tile's last segment when it continues into
// the next tile, slot 1 its first segment when that began in an earlier
// tile; every other segment goes to its destination's row (at() is null).
template <int NF>
struct CarrySlots {
  float *tail, *head;
  int first_end;  // the edge where the tile's first segment ends
  int mid_dim;
  __device__ __forceinline__ float* at(int e, int cnt) const {
    if (e == cnt - 1 && tail != nullptr) return tail;
    return e == first_end ? head : nullptr;
  }
  // sum v of output f at column o into the slot at row
  __device__ __forceinline__ void put(float* row, int f, int o, const SumF32x2& v) const {
    row[f * mid_dim + o] = v.hi;
    row[(NF + f) * mid_dim + o] = v.lo;
  }
};

// The carry slots of tile `tile` (edges [base, base + cnt)), from warp 0's
// destinations and flags (tile_segments); after the barrier that publishes them.
template <int NF>
__device__ __forceinline__ CarrySlots<NF> carry_slots(const int32_t* __restrict__ dst_ptr, const int32_t* s_dst,
                                                      const int32_t* s_flags, float* carry, int tile, int base,
                                                      int mid_dim) {
  float* const rows = carry + static_cast<int64_t>(4 * tile) * NF * mid_dim;
  return {s_flags[1] ? rows : nullptr, __ldg(dst_ptr + s_dst[0]) < base ? rows + 2 * NF * mid_dim : nullptr,
          __ffs(s_flags[0]) - 1, mid_dim};  // the tile's last edge always ends a segment
}

// The output rows of the second launch of the bf16 forms: bf16, or with
// kAcc the float32 accumulators.
template <typename S, bool kAcc>
using FinishOut = typename std::conditional<kAcc, float, S>::type;

// The second launch of the bf16 forms (K1 conv_fwd.cu, K4 tri_fwd.cu, K6
// jvp_fwd.cu), one warp per node: the parts of a node whose edges span
// tiles t0 < t1 wait in carry_slots' rows, tiles t0 .. t1 - 1's in slot 0
// and tile t1's in slot 1, and the node's sum is carry[t0][0] + ... +
// carry[t1 - 1][0] + carry[t1][1], added in tile order as compensated sums.
// Without kAcc each row (bf16) becomes the bf16 nearest to that sum, and
// rows of nodes with no real edge are set to zero.  With kAcc (K4-acc,
// K6-acc: float32 accumulators across the slices of the fr sweep) the sum
// is added onto the row, rounded to float32 once, and rows of nodes with
// no edge in the slice stay as they are.  The tiles wrote the other rows
// whole.  NF = 2 sums two outputs (K6's msg into out, tmsg into tout).
template <typename S, int NF, bool kAcc>
__global__ void __launch_bounds__(32 * kFinishWarps)
    finish_split_rows_compensated(const int32_t* __restrict__ dst_ptr, const float* __restrict__ carry,
                                  FinishOut<S, kAcc>* __restrict__ out, FinishOut<S, kAcc>* __restrict__ tout,
                                  int n_nodes, int mid_dim, int tile) {
  static_assert(std::is_same<S, __nv_bfloat16>::value, "the compensated finish is the bf16 forms'");
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kFinishWarps + (threadIdx.x >> 5);
  if (n >= n_nodes) return;
  const int b = __ldg(dst_ptr + n), e = __ldg(dst_ptr + n + 1);
  const int t0 = b / tile, t1 = (e - 1) / tile;
  if (b == e ? kAcc : t0 == t1) return;  // the accumulator's row, or written whole by its tile
  for (int f = 0; f < NF; ++f) {
    FinishOut<S, kAcc>* row = (f == 0 ? out : tout) + static_cast<int64_t>(n) * mid_dim;
    auto part = [&](int t, int slot, int c) {  // output f of carry[t][slot] at column c
      const float* p = carry + (static_cast<int64_t>(4 * t + 2 * slot) * NF + f) * mid_dim + c;
      return SumF32x2{p[0], p[NF * mid_dim]};
    };
    for (int c = lane; c < mid_dim; c += 32) {
      SumF32x2 v;
      if (b != e) {
        v = part(t0, 0, c);
        for (int t = t0 + 1; t < t1; ++t) v.add(part(t, 0, c));
        v.add(part(t1, 1, c));
      }
      if constexpr (kAcc)
        row[c] = add_onto(row[c], v);
      else
        row[c] = bf16_of_sum(v.hi, v.lo);
    }
  }
}

template <typename S, int NF, bool kAcc>
cudaError_t launch_finish_compensated(const int32_t* dst_ptr, const float* carry, FinishOut<S, kAcc>* out,
                                      FinishOut<S, kAcc>* tout, int n_nodes, int mid_dim, int tile,
                                      cudaStream_t stream) {
  const int blocks = (n_nodes + kFinishWarps - 1) / kFinishWarps;
  finish_split_rows_compensated<S, NF, kAcc><<<blocks, 32 * kFinishWarps, 0, stream>>>(dst_ptr, carry, out, tout,
                                                                                        n_nodes, mid_dim, tile);
  return cudaGetLastError();
}

// Warp 0 of the block of tile [base, base + cnt): each edge's destination
// into s_dst [TILE] (rows past cnt: -1, never read), s_flags[0] the mask of
// the edges where a segment ends in the tile (always the tile's last edge),
// s_flags[1] whether that last segment continues into the next tile (its
// sum then goes to the tile's carry row).
template <int TILE>
__device__ __forceinline__ void tile_segments(const int32_t* __restrict__ dst_ptr, int n_nodes, int base, int cnt,
                                              int32_t* s_dst, int32_t* s_flags) {
  const int lane = threadIdx.x & 31;
  const bool real = lane < cnt;
  const int d = tile_dst(dst_ptr, n_nodes, base, cnt);
  const int d_next = __shfl_down_sync(0xffffffffu, d, 1);
  const unsigned ends = __ballot_sync(0xffffffffu, real && (lane == cnt - 1 || d_next != d));
  if (lane < TILE) s_dst[lane] = d;
  if (lane == 0) s_flags[0] = static_cast<int32_t>(ends);
  if (lane == cnt - 1) s_flags[1] = __ldg(dst_ptr + d + 1) > base + cnt;
}

}  // namespace cgf
}  // namespace nequip
