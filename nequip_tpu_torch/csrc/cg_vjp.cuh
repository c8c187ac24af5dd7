// The CG-VJP of the uvu conv tensor product on a dense edge tile, shared by
// the kernels that take its cotangents per edge: K2 (conv_bwd.cu, the fused
// conv's backward), K5 (tri_bwd.cu, the trilinear conv's) and K7
// (jvp_bwd.cu, the fr dual sweep's, three families at once).
//
// For an edge e (source s, destination n) with node cotangent g = g[n], the
// weights w of the edge and its SH row y, over the CG terms (path p, m1, m2,
// m3, c) and the channels u of the path:
//   dx_e[x_row + u]   = sum_terms w[w_off + u] * c * y[y_off + m2] * g[out_row + u]
//   A[p, m2, u]       = sum_terms of path p with m2  c * x[s, x_row + u] * g[out_row + u]
//   dW_e[w_off + u]   = sum_m2 y[y_off + m2] * A[p, m2, u]
//   dy_e[y_off + m2]  = sum_{p, u} w[w_off + u] * A[p, m2, u]
//
// Work items, as PR 7 laid them out for K2: dx over (TC-edge group, 32-column
// block), dW_e and the dy partials over (TC-edge group, path), one warp per
// item with lanes over columns or channels; each term's table entry is read
// once for TC edges, whose loads are in flight together.  TPPlan sorts each
// path's terms by m2, so A[p, m2] is one run of terms, folded into dW_e and
// into the dy partial when the run ends.  The partials of a run are summed
// over the warp's lanes by a reduce-scatter that leaves edge i's sum on its
// own lanes (TC + 1 shuffles for TC edges instead of 5 TC: reduce_scatter).
// dy then sums the partials in path order.
//
// The tile's y rows and w rows (and, in K5/K7, its x[src] rows and, where
// its destinations are few, their g rows) lie in shared memory; K2 reads g
// rows through L1, where the tile's few destinations stay.  An item whose
// edges share one destination (the common case: ~18 edges a node) loads
// each g value once for its edges.  dW_e overwrites w in place: one lane
// reads w[e][j] before it writes dW_e[e][j], and dx has read w before the
// dW_e items start.  Every sum runs in a fixed order, so the results are
// bitwise repeatable.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cp_async.cuh"
#include "tp_common.cuh"

namespace nequip {
namespace cg {

// TPPlan's term tables (layouts in ops/kernels/tp_scatter.py):
// dx_groups int32 [Gx, 4] = (x_row, unused, t_begin, t_end), one per input row;
// dx_terms int32 [Tx, 3] = (out_row, y_index, w_off), dx_coef [Tx]; dx_col_group int32 [dim_in];
// paths int32 [P, 6] = (w_off, mul, y_off, y_dim, t_begin, t_end);
// path_terms int32 [Tp, 3] = (x_row, out_row, m2), path_coef [Tp], sorted by m2 within a path.
template <typename T>
struct Tables {
  const int32_t *dx_groups, *dx_terms;
  const T* dx_coef;
  const int32_t *dx_col_group, *paths, *path_terms;
  const T* path_coef;
  int n_paths;
};

// The x[src] rows of the tile: staged in shared memory as rows [TILE][ld]
// (STAGED: K5, K7), or gathered from global memory through L1 at row
// s_src[e] (K2).
template <typename T, bool STAGED>
struct XRows {
  const T* x;
  const int32_t* s_src;  // unused when STAGED
  int ld;
  __device__ __forceinline__ int row(int e) const { return (STAGED ? e : s_src[e]) * ld; }
  __device__ __forceinline__ T at(int off) const {
    if constexpr (STAGED)
      return x[off];
    else
      return __ldg(x + off);
  }
};

// The g rows of the tile's destinations: staged in shared memory from node
// d0 on (STAGED: K5, K7 when a tile's destinations are few), or read from
// global memory through L1 (d0 = 0).
template <typename T, bool STAGED>
struct GRows {
  const T* g;
  int d0, ld;
  __device__ __forceinline__ int row(int dst) const { return (dst - d0) * ld; }
  __device__ __forceinline__ T at(int off) const {
    if constexpr (STAGED)
      return g[off];
    else
      return __ldg(g + off);
  }
};

// The warp sums of v[0, N) (N a power of two <= 32) with each edge's sum on
// its own lanes: lane l gets the sum of v[edge_of<N>(l)], exact on every lane
// l with l % (32 / N) == 0.  Halving steps (lanes over bit 16, 8, ... swap
// half their values and add the other half) and then a butterfly over the
// remaining bits: N - 1 + log2(32 / N) shuffles instead of 5 N, in a fixed
// order.
template <int N>
__device__ __forceinline__ int edge_of(int lane) {
  int e = 0;
#pragma unroll
  for (int h = N / 2, bit = 16; h >= 1; h /= 2, bit /= 2)
    if (lane & bit) e += h;
  return e;
}

template <typename T, int N>
__device__ __forceinline__ T reduce_scatter(T (&v)[N], int lane) {
  static_assert(N >= 1 && N <= 32 && (N & (N - 1)) == 0, "N is a power of two <= 32");
#pragma unroll
  for (int h = N / 2, bit = 16; h >= 1; h /= 2, bit /= 2) {
    const bool up = lane & bit;
#pragma unroll
    for (int j = 0; j < h; ++j) {
      const T send = up ? v[j] : v[j + h];
      const T keep = up ? v[j + h] : v[j];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, bit);
    }
  }
  T s = v[0];
#pragma unroll
  for (int bit = 16 / N; bit >= 1; bit /= 2) s += __shfl_xor_sync(0xffffffffu, s, bit);
  return s;
}

// The paths heaviest first into s_order [n_paths], by terms + 2 x SH
// components (a proxy of a path's terms and m2 runs): dw_items deals its
// items to the warps in this order, in a snake, which evens the warps'
// loads (the flagship's layer 1 has a path of 25 terms beside paths of 1).
// One thread, once per block; a barrier must follow.
template <typename T>
__device__ __forceinline__ void order_paths(const Tables<T>& tab, int32_t* s_order) {
  if (threadIdx.x != 0) return;
  auto cost = [&](int p) {
    const int32_t* pt = tab.paths + 6 * p;
    return __ldg(pt + 5) - __ldg(pt + 4) + 2 * __ldg(pt + 3);
  };
  for (int p = 0; p < tab.n_paths; ++p) {  // insertion sort, stable
    const int c = cost(p);
    int q = p;
    for (; q > 0 && cost(s_order[q - 1]) < c; --q) s_order[q] = s_order[q - 1];
    s_order[q] = p;
  }
}

// The k-th of n items for the warp in round k0 / NW: a snake over the warps
// (round r deals items r NW + warp, the next round in reverse), -1 past n.
template <int NW>
__device__ __forceinline__ int snake_item(int k0, int n) {
  const int warp = threadIdx.x >> 5, k = k0 + (((k0 / NW) & 1) ? NW - 1 - warp : warp);
  return k < n ? k : -1;
}

// f(std::true_type{}) when the edges e0 .. e0 + TC - 1 share one
// destination (s_dst is sorted, so the first and the last tell), else
// f(std::false_type{}): the one-destination form loads each g value once
// for the TC edges instead of TC times.
template <int TC, typename F>
__device__ __forceinline__ void by_dst(const int32_t* s_dst, int e0, F&& f) {
  if (s_dst[e0] == s_dst[e0 + TC - 1])
    f(std::true_type{});
  else
    f(std::false_type{});
}

// Adds the warp sums of v[i] (edges e0 + i) to part[((e0 + i) * n_paths +
// p) * kMaxYDim + m], by a reduce-scatter.
template <typename T, int TC>
__device__ __forceinline__ void add_run(T (&v)[TC], T* part, int e0, int p, int m, int n_paths, int lane) {
  const T s = reduce_scatter<T, TC>(v, lane);
  if ((lane & (32 / TC - 1)) == 0) part[((e0 + edge_of<TC>(lane)) * n_paths + p) * kMaxYDim + m] += s;
}

// dx_e for the tile's edges < cnt into dx_out [cnt][dim_in] (row e of the
// tile at dx_out + e * dim_in); y rows s_y [TILE][ldy], w rows s_w [TILE][ldw].
template <typename T, int TILE, int TC, int NW, bool GS>
__device__ __forceinline__ void dx_items(const Tables<T>& tab, const GRows<T, GS> gr, const int32_t* s_dst,
                                         const T* s_y, int ldy, const T* s_w, int ldw, int cnt, int dim_in,
                                         T* __restrict__ dx_out) {
  constexpr int NG = TILE / TC;
  static_assert(TILE % TC == 0, "whole edge groups");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_cb = (dim_in + 31) / 32;  // 32-column blocks of dx
  for (int item = warp; item < NG * n_cb; item += NW) {
    const int e0 = (item / n_cb) * TC, c = (item % n_cb) * 32 + lane;
    if (e0 >= cnt || c >= dim_in) continue;
    const int32_t* grp = tab.dx_groups + 4 * __ldg(tab.dx_col_group + c);
    const int u = c - __ldg(grp), t0 = __ldg(grp + 2), t1 = __ldg(grp + 3);
    by_dst<TC>(s_dst, e0, [&](auto one_dst) {
      constexpr int NGV = decltype(one_dst)::value ? 1 : TC;  // g values a term
      int go[NGV];  // g row offsets (the launcher checks n_nodes * mid_dim < 2^31)
      T acc[TC];
#pragma unroll
      for (int i = 0; i < NGV; ++i) go[i] = gr.row(s_dst[e0 + i]) + u;
#pragma unroll
      for (int i = 0; i < TC; ++i) acc[i] = T(0);
#pragma unroll 2
      for (int k = t0; k < t1; ++k) {
        const int out_row = __ldg(tab.dx_terms + 3 * k), yi = __ldg(tab.dx_terms + 3 * k + 1);
        const int wo = __ldg(tab.dx_terms + 3 * k + 2) + u;
        const T coef = __ldg(tab.dx_coef + k);
        T gv[NGV];
#pragma unroll
        for (int i = 0; i < NGV; ++i) gv[i] = gr.at(go[i] + out_row);
#pragma unroll
        for (int i = 0; i < TC; ++i)
          acc[i] += coef * s_y[(e0 + i) * ldy + yi] * gv[NGV == 1 ? 0 : i] * s_w[(e0 + i) * ldw + wo];
      }
#pragma unroll
      for (int i = 0; i < TC; ++i)
        if (e0 + i < cnt) dx_out[static_cast<int64_t>(e0 + i) * dim_in + c] = acc[i];
    });
  }
}

// dW_e in place of w (and, if dw_out is not null, into dw_out [cnt][wn]) and
// the dy partials s_part [TILE][n_paths][kMaxYDim] (zero before the call,
// summed into by each m2 run).
template <typename T, int TILE, int TC, int NW, bool STAGED, bool GS>
__device__ __forceinline__ void dw_items(const Tables<T>& tab, const int32_t* s_order, const XRows<T, STAGED> xr,
                                         const GRows<T, GS> gr, const int32_t* s_dst, const T* s_y, int ldy, T* s_w,
                                         int ldw, int cnt, T* s_part, T* __restrict__ dw_out, int wn) {
  constexpr int NG = TILE / TC;
  const int lane = threadIdx.x & 31, n_paths = tab.n_paths;
  for (int k0 = 0; k0 < NG * n_paths; k0 += NW) {
    const int item = snake_item<NW>(k0, NG * n_paths);  // (path in s_order, edge group)
    if (item < 0) continue;
    const int e0 = (item % NG) * TC, p = s_order[item / NG];
    if (e0 >= cnt) continue;
    const int32_t* pt = tab.paths + 6 * p;
    const int w_off = __ldg(pt), mul = __ldg(pt + 1), y_off = __ldg(pt + 2);
    const int t0 = __ldg(pt + 4), t1 = __ldg(pt + 5);
    by_dst<TC>(s_dst, e0, [&](auto one_dst) {
      constexpr int NGV = decltype(one_dst)::value ? 1 : TC;  // g values a term
      for (int ub = 0; ub < mul; ub += 32) {  // warp-uniform trip count
        const int u = ub + lane;
        const bool on = u < mul;
        int xo[TC], go[NGV];  // x and g row offsets (the launcher checks they fit in int32)
        T wv[TC], dw[TC];
#pragma unroll
        for (int i = 0; i < NGV; ++i) go[i] = gr.row(s_dst[e0 + i]) + u;
#pragma unroll
        for (int i = 0; i < TC; ++i) {
          xo[i] = xr.row(e0 + i) + u;
          wv[i] = on ? s_w[(e0 + i) * ldw + w_off + u] : T(0);
          dw[i] = T(0);
        }
        for (int k = t0, run_end; k < t1; k = run_end) {  // one run of terms per m2
          const int m = __ldg(tab.path_terms + 3 * k + 2);
          for (run_end = k + 1; run_end < t1 && __ldg(tab.path_terms + 3 * run_end + 2) == m;) ++run_end;
          T am[TC];
#pragma unroll
          for (int i = 0; i < TC; ++i) am[i] = T(0);
          if (on) {
#pragma unroll 2
            for (int kk = k; kk < run_end; ++kk) {
              const int x_row = __ldg(tab.path_terms + 3 * kk), out_row = __ldg(tab.path_terms + 3 * kk + 1);
              const T coef = __ldg(tab.path_coef + kk);
              T gv[NGV];
#pragma unroll
              for (int i = 0; i < NGV; ++i) gv[i] = gr.at(go[i] + out_row);
#pragma unroll
              for (int i = 0; i < TC; ++i) am[i] += coef * xr.at(xo[i] + x_row) * gv[NGV == 1 ? 0 : i];
            }
          }
          T v[TC];
#pragma unroll
          for (int i = 0; i < TC; ++i) {
            dw[i] += s_y[(e0 + i) * ldy + y_off + m] * am[i];
            v[i] = wv[i] * am[i];
          }
          add_run<T, TC>(v, s_part, e0, p, m, n_paths, lane);
        }
        if (on) {
#pragma unroll
          for (int i = 0; i < TC; ++i) {
            s_w[(e0 + i) * ldw + w_off + u] = dw[i];
            if (dw_out != nullptr && e0 + i < cnt) dw_out[static_cast<int64_t>(e0 + i) * wn + w_off + u] = dw[i];
          }
        }
      }
    });
  }
}

// The fr sweep's dx and dtx (K7): with gt = gt[n], ty the SH tangent and dw
// the weight tangent of the edge,
//   dx_e  = sum_terms c [w (y g + ty gt) + dw y gt],   dtx_e = sum_terms c w y gt.
template <typename T, int TILE, int TC, int NW, bool GS>
__device__ __forceinline__ void dx_items_jvp(const Tables<T>& tab, const GRows<T, GS> gr, const GRows<T, GS> gtr,
                                             const int32_t* s_dst, const T* s_y, const T* s_ty, int ldy,
                                             const T* s_w, const T* s_dw, int ldw, int cnt, int dim_in,
                                             T* __restrict__ dx_out, T* __restrict__ dtx_out) {
  constexpr int NG = TILE / TC;
  static_assert(TILE % TC == 0, "whole edge groups");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_cb = (dim_in + 31) / 32;
  for (int item = warp; item < NG * n_cb; item += NW) {
    const int e0 = (item / n_cb) * TC, c = (item % n_cb) * 32 + lane;
    if (e0 >= cnt || c >= dim_in) continue;
    const int32_t* grp = tab.dx_groups + 4 * __ldg(tab.dx_col_group + c);
    const int u = c - __ldg(grp), t0 = __ldg(grp + 2), t1 = __ldg(grp + 3);
    by_dst<TC>(s_dst, e0, [&](auto one_dst) {
      constexpr int NGV = decltype(one_dst)::value ? 1 : TC;  // g and gt values a term
      int go[NGV];  // gt rows lie as g's
      T acc[TC], tacc[TC];
#pragma unroll
      for (int i = 0; i < NGV; ++i) go[i] = gr.row(s_dst[e0 + i]) + u;
#pragma unroll
      for (int i = 0; i < TC; ++i) acc[i] = tacc[i] = T(0);
#pragma unroll 2
      for (int k = t0; k < t1; ++k) {
        const int out_row = __ldg(tab.dx_terms + 3 * k), yi = __ldg(tab.dx_terms + 3 * k + 1);
        const int wo = __ldg(tab.dx_terms + 3 * k + 2) + u;
        const T coef = __ldg(tab.dx_coef + k);
        T gv[NGV], gtv[NGV];
#pragma unroll
        for (int i = 0; i < NGV; ++i) gv[i] = gr.at(go[i] + out_row), gtv[i] = gtr.at(go[i] + out_row);
#pragma unroll
        for (int i = 0; i < TC; ++i) {
          const int ey = (e0 + i) * ldy + yi, ew = (e0 + i) * ldw + wo, j = NGV == 1 ? 0 : i;
          const T cy = coef * s_y[ey], cw = coef * s_w[ew];
          acc[i] += cw * (s_y[ey] * gv[j] + s_ty[ey] * gtv[j]) + s_dw[ew] * cy * gtv[j];
          tacc[i] += cw * s_y[ey] * gtv[j];
        }
      }
#pragma unroll
      for (int i = 0; i < TC; ++i)
        if (e0 + i < cnt) {
          dx_out[static_cast<int64_t>(e0 + i) * dim_in + c] = acc[i];
          dtx_out[static_cast<int64_t>(e0 + i) * dim_in + c] = tacc[i];
        }
    });
  }
}

// The fr sweep's weight cotangents and dy/dty partials (K7).  Per m2 run the
// three families P1 = sum c x g, P2 = sum c x gt, P3 = sum c tx gt, then
//   cw  += y (P1 + P3) + ty P2,   cdw += y P2,
//   dy partial  = w (P1 + P3) + dw P2,   dty partial = w P2;
// cw overwrites w and cdw overwrites dw in place.
template <typename T, int TILE, int TC, int NW, bool GS>
__device__ __forceinline__ void dw_items_jvp(const Tables<T>& tab, const XRows<T, true> xr,
                                             const XRows<T, true> txr, const GRows<T, GS> gr,
                                             const GRows<T, GS> gtr, const int32_t* s_order, const int32_t* s_dst,
                                             const T* s_y, const T* s_ty, int ldy, T* s_w, T* s_dw, int ldw, int cnt,
                                             T* s_part, T* s_tpart) {
  constexpr int NG = TILE / TC;
  const int lane = threadIdx.x & 31, n_paths = tab.n_paths;
  for (int k0 = 0; k0 < NG * n_paths; k0 += NW) {
    const int item = snake_item<NW>(k0, NG * n_paths);  // (path in s_order, edge group)
    if (item < 0) continue;
    const int e0 = (item % NG) * TC, p = s_order[item / NG];
    if (e0 >= cnt) continue;
    const int32_t* pt = tab.paths + 6 * p;
    const int w_off = __ldg(pt), mul = __ldg(pt + 1), y_off = __ldg(pt + 2);
    const int t0 = __ldg(pt + 4), t1 = __ldg(pt + 5);
    by_dst<TC>(s_dst, e0, [&](auto one_dst) {
      constexpr int NGV = decltype(one_dst)::value ? 1 : TC;  // g and gt values a term
      for (int ub = 0; ub < mul; ub += 32) {
        const int u = ub + lane;
        const bool on = u < mul;
        int xo[TC], go[NGV];
        T wv[TC], dwv[TC], cw[TC], cdw[TC];
#pragma unroll
        for (int i = 0; i < NGV; ++i) go[i] = gr.row(s_dst[e0 + i]) + u;
#pragma unroll
        for (int i = 0; i < TC; ++i) {
          xo[i] = xr.row(e0 + i) + u;
          wv[i] = on ? s_w[(e0 + i) * ldw + w_off + u] : T(0);
          dwv[i] = on ? s_dw[(e0 + i) * ldw + w_off + u] : T(0);
          cw[i] = cdw[i] = T(0);
        }
        for (int k = t0, run_end; k < t1; k = run_end) {
          const int m = __ldg(tab.path_terms + 3 * k + 2);
          for (run_end = k + 1; run_end < t1 && __ldg(tab.path_terms + 3 * run_end + 2) == m;) ++run_end;
          T a1[TC], a2[TC], a3[TC];
#pragma unroll
          for (int i = 0; i < TC; ++i) a1[i] = a2[i] = a3[i] = T(0);
          if (on) {
#pragma unroll 2
            for (int kk = k; kk < run_end; ++kk) {
              const int x_row = __ldg(tab.path_terms + 3 * kk), out_row = __ldg(tab.path_terms + 3 * kk + 1);
              const T coef = __ldg(tab.path_coef + kk);
              T gv[NGV], gtv[NGV];
#pragma unroll
              for (int i = 0; i < NGV; ++i) gv[i] = gr.at(go[i] + out_row), gtv[i] = gtr.at(go[i] + out_row);
#pragma unroll
              for (int i = 0; i < TC; ++i) {
                const int j = NGV == 1 ? 0 : i;
                const T cx = coef * xr.at(xo[i] + x_row);
                a1[i] += cx * gv[j];
                a2[i] += cx * gtv[j];
                a3[i] += coef * txr.at(xo[i] + x_row) * gtv[j];
              }
            }
          }
          T v[TC], tv[TC];
#pragma unroll
          for (int i = 0; i < TC; ++i) {
            const int ey = (e0 + i) * ldy + y_off + m;
            const T p13 = a1[i] + a3[i];
            cw[i] += s_y[ey] * p13 + s_ty[ey] * a2[i];
            cdw[i] += s_y[ey] * a2[i];
            v[i] = wv[i] * p13 + dwv[i] * a2[i];
            tv[i] = wv[i] * a2[i];
          }
          add_run<T, TC>(v, s_part, e0, p, m, n_paths, lane);
          add_run<T, TC>(tv, s_tpart, e0, p, m, n_paths, lane);
        }
        if (on) {
#pragma unroll
          for (int i = 0; i < TC; ++i) {
            s_w[(e0 + i) * ldw + w_off + u] = cw[i];
            s_dw[(e0 + i) * ldw + w_off + u] = cdw[i];
          }
        }
      }
    });
  }
}

// dy [cnt][sh_dim] (flat at out) from the partials in path order: each
// thread sums V = 16 / sizeof(T) consecutive elements, reading each path's
// row once for them, and stores them as one 16-byte store where out is
// 16-byte aligned.
template <typename T, int NT>
__device__ __forceinline__ void path_sum(const Tables<T>& tab, const T* s_part, int cnt, int sh_dim,
                                         T* __restrict__ out) {
  constexpr int V = 16 / sizeof(T);
  const int n = cnt * sh_dim, n_paths = tab.n_paths;
  const bool vec = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  for (int i0 = threadIdx.x * V; i0 < n; i0 += NT * V) {
    int e[V], c[V];
    T v[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      e[j] = (i0 + j) / sh_dim, c[j] = i0 + j - e[j] * sh_dim;
      v[j] = T(0);
    }
    for (int p = 0; p < n_paths; ++p) {
      const int y_off = __ldg(tab.paths + 6 * p + 2), y_dim = __ldg(tab.paths + 6 * p + 3);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int m = c[j] - y_off;
        if (i0 + j < n && m >= 0 && m < y_dim) v[j] += s_part[(e[j] * n_paths + p) * kMaxYDim + m];
      }
    }
    if (vec && i0 + V <= n) {
      store16(out + i0, v);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (i0 + j < n) out[i0 + j] = v[j];
    }
  }
}

}  // namespace cg
}  // namespace nequip
