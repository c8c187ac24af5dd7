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
// layer 1 at 23k atoms, f32), ~0.6 ms at HBM rate; like K2 more likely
// latency bound by its barriers per edge tile.
// Design: K2's, one block per destination node over its CSR segment, g[n]
// in shared memory, kEdgeTile edges per step; dy is reduced across a path's
// channels by warp shuffles and then across paths in a fixed order, so every
// sum is deterministic.
#include "tp_common.cuh"

namespace nequip {

// dx_groups: int32 [Gx, 4] = (x_row, unused, t_begin, t_end), one per input row
// dx_terms:  int32 [Tx, 3] = (out_row, y_index, w_off), dx_coef[Tx]
// dx_col_group: int32 [dim_in]
// paths:      int32 [P, 6] = (w_off, mul, y_off, y_dim, t_begin, t_end)
// path_terms: int32 [Tp, 3] = (x_row, out_row, m2), path_coef[Tp]
template <typename T>
__global__ void __launch_bounds__(kThreads) tri_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ w,
    const int32_t* __restrict__ edge_src, const int32_t* __restrict__ dst_ptr,
    const T* __restrict__ g,
    const int32_t* __restrict__ dx_groups, const int32_t* __restrict__ dx_terms,
    const T* __restrict__ dx_coef, const int32_t* __restrict__ dx_col_group,
    const int32_t* __restrict__ paths, const int32_t* __restrict__ path_terms,
    const T* __restrict__ path_coef, int n_paths,
    T* __restrict__ dx_edge, T* __restrict__ dy, T* __restrict__ dw,
    int dim_in, int sh_dim, int wn, int mid_dim) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_g = reinterpret_cast<T*>(smem_raw);     // [mid_dim]
  T* s_x = s_g + mid_dim;                      // [kEdgeTile, dim_in]
  T* s_y = s_x + kEdgeTile * dim_in;           // [kEdgeTile, sh_dim]
  T* s_w = s_y + kEdgeTile * sh_dim;           // [kEdgeTile, wn]
  T* s_dyp = s_w + kEdgeTile * wn;             // [kEdgeTile, n_paths, kMaxYDim]

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int e_begin = dst_ptr[n];
  const int e_end = dst_ptr[n + 1];
  if (e_begin == e_end) return;  // no edge of this node in the stream (or slice)
  for (int o = tid; o < mid_dim; o += blockDim.x)
    s_g[o] = g[static_cast<int64_t>(n) * mid_dim + o];

  for (int base = e_begin; base < e_end; base += kEdgeTile) {
    const int cnt = min(kEdgeTile, e_end - base);
    __syncthreads();  // s_g is loaded; readers of the previous tile are done
    for (int i = tid; i < cnt * dim_in; i += blockDim.x) {
      const int e = i / dim_in;
      s_x[i] = x[static_cast<int64_t>(edge_src[base + e]) * dim_in + (i - e * dim_in)];
    }
    for (int i = tid; i < cnt * sh_dim; i += blockDim.x)
      s_y[i] = y[static_cast<int64_t>(base) * sh_dim + i];
    for (int i = tid; i < cnt * wn; i += blockDim.x)
      s_w[i] = w[static_cast<int64_t>(base) * wn + i];
    __syncthreads();

    // dx: one thread per input column
    for (int c = tid; c < dim_in; c += blockDim.x) {
      const int32_t* gr = dx_groups + 4 * dx_col_group[c];
      const int u = c - gr[0];
      const int t0 = gr[2];
      const int t1 = gr[3];
      for (int e = 0; e < cnt; ++e) {
        const T* ye = s_y + e * sh_dim;
        const T* we = s_w + e * wn;
        T acc = T(0);
        for (int k = t0; k < t1; ++k) {
          const int32_t* tk = dx_terms + 3 * k;
          acc += dx_coef[k] * ye[tk[1]] * s_g[tk[0] + u] * we[tk[2] + u];
        }
        dx_edge[static_cast<int64_t>(base + e) * dim_in + c] = acc;
      }
    }

    // dw and the per-path dy partials: one warp per (edge, path), lanes over channels
    for (int pe = warp; pe < cnt * n_paths; pe += n_warps) {
      const int e = pe / n_paths;
      const int p = pe - e * n_paths;
      const int32_t* pt = paths + 6 * p;
      const int w_off = pt[0], mul = pt[1], y_off = pt[2], y_dim = pt[3];
      const int t0 = pt[4], t1 = pt[5];
      const T* xe = s_x + e * dim_in;
      const T* ye = s_y + e * sh_dim;
      const T* we = s_w + e * wn;
      T part[kMaxYDim];
#pragma unroll
      for (int m = 0; m < kMaxYDim; ++m) part[m] = T(0);
      for (int ub = 0; ub < mul; ub += 32) {  // warp-uniform trip count
        const int u = ub + lane;
        if (u < mul) {
          T a[kMaxYDim];
#pragma unroll
          for (int m = 0; m < kMaxYDim; ++m) a[m] = T(0);
          for (int k = t0; k < t1; ++k) {
            const int32_t* tk = path_terms + 3 * k;
            const T v = path_coef[k] * xe[tk[0] + u] * s_g[tk[1] + u];
#pragma unroll
            for (int m = 0; m < kMaxYDim; ++m)
              if (m == tk[2]) a[m] += v;
          }
          const T wu = we[w_off + u];
          T dwu = T(0);
#pragma unroll
          for (int m = 0; m < kMaxYDim; ++m)
            if (m < y_dim) {
              dwu += ye[y_off + m] * a[m];
              part[m] += wu * a[m];
            }
          dw[static_cast<int64_t>(base + e) * wn + w_off + u] = dwu;
        }
      }
#pragma unroll
      for (int m = 0; m < kMaxYDim; ++m) {
        T v = part[m];
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        part[m] = v;
      }
      if (lane == 0) {
#pragma unroll
        for (int m = 0; m < kMaxYDim; ++m)
          if (m < y_dim) s_dyp[(e * n_paths + p) * kMaxYDim + m] = part[m];
      }
    }
    __syncthreads();

    // dy: sum the path partials in path order
    for (int i = tid; i < cnt * sh_dim; i += blockDim.x) {
      const int e = i / sh_dim;
      const int c = i - e * sh_dim;
      T acc = T(0);
      for (int p = 0; p < n_paths; ++p) {
        const int m = c - paths[6 * p + 2];
        if (m >= 0 && m < paths[6 * p + 3]) acc += s_dyp[(e * n_paths + p) * kMaxYDim + m];
      }
      dy[static_cast<int64_t>(base + e) * sh_dim + c] = acc;
    }
  }
}

template <typename T>
int launch_tri_bwd(const void* x, const void* y, const void* w, const void* edge_src,
                   const void* dst_ptr, const void* g, const void* dx_groups,
                   const void* dx_terms, const void* dx_coef, const void* dx_col_group,
                   const void* paths, const void* path_terms, const void* path_coef,
                   void* dx_edge, void* dy, void* dw, int n_paths, int n_nodes, int dim_in,
                   int sh_dim, int wn, int mid_dim, void* stream) {
  const size_t smem =
      sizeof(T) * (static_cast<size_t>(mid_dim) +
                   static_cast<size_t>(kEdgeTile) * (dim_in + sh_dim + wn + n_paths * kMaxYDim));
  cudaError_t err = allow_dynamic_smem(tri_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_nodes > 0) {
    tri_bwd_kernel<T><<<n_nodes, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const T*>(w),
        static_cast<const int32_t*>(edge_src), static_cast<const int32_t*>(dst_ptr),
        static_cast<const T*>(g), static_cast<const int32_t*>(dx_groups),
        static_cast<const int32_t*>(dx_terms), static_cast<const T*>(dx_coef),
        static_cast<const int32_t*>(dx_col_group), static_cast<const int32_t*>(paths),
        static_cast<const int32_t*>(path_terms), static_cast<const T*>(path_coef), n_paths,
        static_cast<T*>(dx_edge), static_cast<T*>(dy), static_cast<T*>(dw), dim_in, sh_dim,
        wn, mid_dim);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nequip

#define NEQUIP_TRI_BWD(SUFFIX, T)                                                             \
  extern "C" int nequip_tri_bwd_##SUFFIX(                                                    \
      const void* x, const void* y, const void* w, const void* edge_src, const void* dst_ptr, \
      const void* g, const void* dx_groups, const void* dx_terms, const void* dx_coef,       \
      const void* dx_col_group, const void* paths, const void* path_terms,                   \
      const void* path_coef, void* dx_edge, void* dy, void* dw, int n_paths, int n_nodes,    \
      int dim_in, int sh_dim, int wn, int mid_dim, void* stream) {                           \
    return nequip::launch_tri_bwd<T>(x, y, w, edge_src, dst_ptr, g, dx_groups, dx_terms,     \
                                     dx_coef, dx_col_group, paths, path_terms, path_coef,    \
                                     dx_edge, dy, dw, n_paths, n_nodes, dim_in, sh_dim, wn,  \
                                     mid_dim, stream);                                       \
  }

NEQUIP_TRI_BWD(f32, float)
NEQUIP_TRI_BWD(f64, double)
