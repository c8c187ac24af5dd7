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
// six per-edge outputs (419,904 x (4 x 288 + 4 x 352 + 4 x 9) x 4 B ~ 4.4 GB
// in layer 1 at 23k atoms, f32), ~1.3 ms at HBM rate; like K5 it is more
// likely latency bound by its barriers per edge tile.
// Design: K5's (tri_bwd.cu), one block per destination node over its CSR
// segment with g[n] and gt[n] in shared memory (the TPU kernel's one-hot
// gather matmul is not needed), kEdgeTile edges per step.  dx/dtx: one
// thread per input column; cw/cdw and the per-path dy/dty partials: one warp
// per (edge, path) with lanes over channels, reduced by warp shuffles and
// then across paths in a fixed order, so every sum is deterministic.  Shared
// memory is 2 x mid_dim + kEdgeTile x (2 x (dim_in + sh_dim + WN) +
// 2 x paths x kMaxYDim) values, 114 KB in layer 1 in f64 (allowed above
// 48 KB; the card gives a block 227 KB).
#include "tp_common.cuh"

namespace nequip {

// dx_groups: int32 [Gx, 4] = (x_row, unused, t_begin, t_end), one per input row
// dx_terms:  int32 [Tx, 3] = (out_row, y_index, w_off), dx_coef[Tx]
// dx_col_group: int32 [dim_in]
// paths:      int32 [P, 6] = (w_off, mul, y_off, y_dim, t_begin, t_end)
// path_terms: int32 [Tp, 3] = (x_row, out_row, m2), path_coef[Tp]
template <typename T>
__global__ void __launch_bounds__(kThreads) jvp_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ tx, const T* __restrict__ y,
    const T* __restrict__ ty, const T* __restrict__ w, const T* __restrict__ dw,
    const int32_t* __restrict__ edge_src, const int32_t* __restrict__ dst_ptr,
    const T* __restrict__ g, const T* __restrict__ gt,
    const int32_t* __restrict__ dx_groups, const int32_t* __restrict__ dx_terms,
    const T* __restrict__ dx_coef, const int32_t* __restrict__ dx_col_group,
    const int32_t* __restrict__ paths, const int32_t* __restrict__ path_terms,
    const T* __restrict__ path_coef, int n_paths,
    T* __restrict__ dx_edge, T* __restrict__ dtx_edge, T* __restrict__ dy,
    T* __restrict__ dty, T* __restrict__ cw, T* __restrict__ cdw,
    int dim_in, int sh_dim, int wn, int mid_dim) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_g = reinterpret_cast<T*>(smem_raw);     // [mid_dim]
  T* s_gt = s_g + mid_dim;                     // [mid_dim]
  T* s_x = s_gt + mid_dim;                     // [kEdgeTile, dim_in]
  T* s_tx = s_x + kEdgeTile * dim_in;          // [kEdgeTile, dim_in]
  T* s_y = s_tx + kEdgeTile * dim_in;          // [kEdgeTile, sh_dim]
  T* s_ty = s_y + kEdgeTile * sh_dim;          // [kEdgeTile, sh_dim]
  T* s_w = s_ty + kEdgeTile * sh_dim;          // [kEdgeTile, wn]
  T* s_dw = s_w + kEdgeTile * wn;              // [kEdgeTile, wn]
  T* s_dyp = s_dw + kEdgeTile * wn;            // [kEdgeTile, n_paths, kMaxYDim]
  T* s_dtyp = s_dyp + kEdgeTile * n_paths * kMaxYDim;

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int e_begin = dst_ptr[n];
  const int e_end = dst_ptr[n + 1];
  if (e_begin == e_end) return;  // no edge of this node in the stream (or slice)
  for (int o = tid; o < mid_dim; o += blockDim.x) {
    s_g[o] = g[static_cast<int64_t>(n) * mid_dim + o];
    s_gt[o] = gt[static_cast<int64_t>(n) * mid_dim + o];
  }

  for (int base = e_begin; base < e_end; base += kEdgeTile) {
    const int cnt = min(kEdgeTile, e_end - base);
    __syncthreads();  // s_g/s_gt are loaded; readers of the previous tile are done
    for (int i = tid; i < cnt * dim_in; i += blockDim.x) {
      const int e = i / dim_in;
      const int64_t at = static_cast<int64_t>(edge_src[base + e]) * dim_in + (i - e * dim_in);
      s_x[i] = x[at];
      s_tx[i] = tx[at];
    }
    for (int i = tid; i < cnt * sh_dim; i += blockDim.x) {
      s_y[i] = y[static_cast<int64_t>(base) * sh_dim + i];
      s_ty[i] = ty[static_cast<int64_t>(base) * sh_dim + i];
    }
    for (int i = tid; i < cnt * wn; i += blockDim.x) {
      s_w[i] = w[static_cast<int64_t>(base) * wn + i];
      s_dw[i] = dw[static_cast<int64_t>(base) * wn + i];
    }
    __syncthreads();

    // dx, dtx: one thread per input column
    for (int c = tid; c < dim_in; c += blockDim.x) {
      const int32_t* gr = dx_groups + 4 * dx_col_group[c];
      const int u = c - gr[0];
      const int t0 = gr[2];
      const int t1 = gr[3];
      for (int e = 0; e < cnt; ++e) {
        const T* ye = s_y + e * sh_dim;
        const T* tye = s_ty + e * sh_dim;
        const T* we = s_w + e * wn;
        const T* dwe = s_dw + e * wn;
        T acc = T(0);
        T tacc = T(0);
        for (int k = t0; k < t1; ++k) {
          const int32_t* tk = dx_terms + 3 * k;
          const int o = tk[0] + u;
          const T yv = ye[tk[1]];
          const T wv = we[tk[2] + u];
          const T ygt = dx_coef[k] * yv * s_gt[o];
          acc += dx_coef[k] * wv * (yv * s_g[o] + tye[tk[1]] * s_gt[o]) + dwe[tk[2] + u] * ygt;
          tacc += wv * ygt;
        }
        const int64_t at = static_cast<int64_t>(base + e) * dim_in + c;
        dx_edge[at] = acc;
        dtx_edge[at] = tacc;
      }
    }

    // cw, cdw and the per-path dy/dty partials: one warp per (edge, path),
    // lanes over channels
    for (int pe = warp; pe < cnt * n_paths; pe += n_warps) {
      const int e = pe / n_paths;
      const int p = pe - e * n_paths;
      const int32_t* pt = paths + 6 * p;
      const int w_off = pt[0], mul = pt[1], y_off = pt[2], y_dim = pt[3];
      const int t0 = pt[4], t1 = pt[5];
      const T* xe = s_x + e * dim_in;
      const T* txe = s_tx + e * dim_in;
      const T* ye = s_y + e * sh_dim;
      const T* tye = s_ty + e * sh_dim;
      const T* we = s_w + e * wn;
      const T* dwe = s_dw + e * wn;
      T part[kMaxYDim];
      T tpart[kMaxYDim];
#pragma unroll
      for (int m = 0; m < kMaxYDim; ++m) part[m] = tpart[m] = T(0);
      for (int ub = 0; ub < mul; ub += 32) {  // warp-uniform trip count
        const int u = ub + lane;
        if (u < mul) {
          T a1[kMaxYDim], a2[kMaxYDim], a3[kMaxYDim];
#pragma unroll
          for (int m = 0; m < kMaxYDim; ++m) a1[m] = a2[m] = a3[m] = T(0);
          for (int k = t0; k < t1; ++k) {
            const int32_t* tk = path_terms + 3 * k;
            const T c = path_coef[k];
            const T xv = xe[tk[0] + u];
            const T gv = s_g[tk[1] + u];
            const T gtv = s_gt[tk[1] + u];
            const T v1 = c * xv * gv;
            const T v2 = c * xv * gtv;
            const T v3 = c * txe[tk[0] + u] * gtv;
#pragma unroll
            for (int m = 0; m < kMaxYDim; ++m)
              if (m == tk[2]) {
                a1[m] += v1;
                a2[m] += v2;
                a3[m] += v3;
              }
          }
          const T wu = we[w_off + u];
          const T dwu = dwe[w_off + u];
          T cwu = T(0);
          T cdwu = T(0);
#pragma unroll
          for (int m = 0; m < kMaxYDim; ++m)
            if (m < y_dim) {
              const T p13 = a1[m] + a3[m];
              cwu += ye[y_off + m] * p13 + tye[y_off + m] * a2[m];
              cdwu += ye[y_off + m] * a2[m];
              part[m] += wu * p13 + dwu * a2[m];
              tpart[m] += wu * a2[m];
            }
          const int64_t at = static_cast<int64_t>(base + e) * wn + w_off + u;
          cw[at] = cwu;
          cdw[at] = cdwu;
        }
      }
#pragma unroll
      for (int m = 0; m < kMaxYDim; ++m) {
        T v = part[m];
        T tv = tpart[m];
        for (int off = 16; off > 0; off >>= 1) {
          v += __shfl_xor_sync(0xffffffffu, v, off);
          tv += __shfl_xor_sync(0xffffffffu, tv, off);
        }
        part[m] = v;
        tpart[m] = tv;
      }
      if (lane == 0) {
#pragma unroll
        for (int m = 0; m < kMaxYDim; ++m)
          if (m < y_dim) {
            s_dyp[(e * n_paths + p) * kMaxYDim + m] = part[m];
            s_dtyp[(e * n_paths + p) * kMaxYDim + m] = tpart[m];
          }
      }
    }
    __syncthreads();

    // dy, dty: sum the path partials in path order
    for (int i = tid; i < cnt * sh_dim; i += blockDim.x) {
      const int e = i / sh_dim;
      const int c = i - e * sh_dim;
      T acc = T(0);
      T tacc = T(0);
      for (int p = 0; p < n_paths; ++p) {
        const int m = c - paths[6 * p + 2];
        if (m >= 0 && m < paths[6 * p + 3]) {
          acc += s_dyp[(e * n_paths + p) * kMaxYDim + m];
          tacc += s_dtyp[(e * n_paths + p) * kMaxYDim + m];
        }
      }
      dy[static_cast<int64_t>(base + e) * sh_dim + c] = acc;
      dty[static_cast<int64_t>(base + e) * sh_dim + c] = tacc;
    }
  }
}

template <typename T>
int launch_jvp_bwd(const void* x, const void* tx, const void* y, const void* ty, const void* w,
                   const void* dw, const void* edge_src, const void* dst_ptr, const void* g,
                   const void* gt, const void* dx_groups, const void* dx_terms,
                   const void* dx_coef, const void* dx_col_group, const void* paths,
                   const void* path_terms, const void* path_coef, void* dx_edge,
                   void* dtx_edge, void* dy, void* dty, void* cw, void* cdw, int n_paths,
                   int n_nodes, int dim_in, int sh_dim, int wn, int mid_dim, void* stream) {
  const size_t smem =
      sizeof(T) * (2 * static_cast<size_t>(mid_dim) +
                   static_cast<size_t>(kEdgeTile) *
                       (2 * (dim_in + sh_dim + wn) + 2 * n_paths * kMaxYDim));
  cudaError_t err = allow_dynamic_smem(jvp_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_nodes > 0) {
    jvp_bwd_kernel<T><<<n_nodes, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(tx), static_cast<const T*>(y),
        static_cast<const T*>(ty), static_cast<const T*>(w), static_cast<const T*>(dw),
        static_cast<const int32_t*>(edge_src), static_cast<const int32_t*>(dst_ptr),
        static_cast<const T*>(g), static_cast<const T*>(gt),
        static_cast<const int32_t*>(dx_groups), static_cast<const int32_t*>(dx_terms),
        static_cast<const T*>(dx_coef), static_cast<const int32_t*>(dx_col_group),
        static_cast<const int32_t*>(paths), static_cast<const int32_t*>(path_terms),
        static_cast<const T*>(path_coef), n_paths, static_cast<T*>(dx_edge),
        static_cast<T*>(dtx_edge), static_cast<T*>(dy), static_cast<T*>(dty),
        static_cast<T*>(cw), static_cast<T*>(cdw), dim_in, sh_dim, wn, mid_dim);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nequip

#define NEQUIP_JVP_BWD(SUFFIX, T)                                                              \
  extern "C" int nequip_jvp_bwd_##SUFFIX(                                                     \
      const void* x, const void* tx, const void* y, const void* ty, const void* w,            \
      const void* dw, const void* edge_src, const void* dst_ptr, const void* g,               \
      const void* gt, const void* dx_groups, const void* dx_terms, const void* dx_coef,       \
      const void* dx_col_group, const void* paths, const void* path_terms,                    \
      const void* path_coef, void* dx_edge, void* dtx_edge, void* dy, void* dty, void* cw,    \
      void* cdw, int n_paths, int n_nodes, int dim_in, int sh_dim, int wn, int mid_dim,       \
      void* stream) {                                                                         \
    return nequip::launch_jvp_bwd<T>(x, tx, y, ty, w, dw, edge_src, dst_ptr, g, gt,           \
                                     dx_groups, dx_terms, dx_coef, dx_col_group, paths,       \
                                     path_terms, path_coef, dx_edge, dtx_edge, dy, dty, cw,   \
                                     cdw, n_paths, n_nodes, dim_in, sh_dim, wn, mid_dim,      \
                                     stream);                                                 \
  }

NEQUIP_JVP_BWD(f32, float)
NEQUIP_JVP_BWD(f64, double)
