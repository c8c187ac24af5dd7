// K2: first-order backward of the fused convolution (K1), inference variant:
// the per-edge cotangents that the forces need.
//
// Replaces the TPU kernel nequip_tpu/ops/pallas/tp_scatter.py,
// _make_fused_mlp.kernel_bwd (kernel body _bwd_mlp_kernel_T, CG-VJP block
// _compute_tp_bwd_block_T).  For each edge e (source s, destination n) with
// the node cotangent g = dL/dout[n]:
//   recompute h_pre = alpha0 * emb_e . W1, h = silu(h_pre), w = alpha1 * h . W2
//   dx_e[x_row + u]  = sum_terms w[w_off + u] * c * sh_e[y] * g[out_row + u]
//   A[p, m2, u]      = sum_terms of path p with m2  c * x[s, x_row + u] * g[out_row + u]
//   dW_e[w_off + u]  = sum_m2 sh_e[y_off + m2] * A[p, m2, u]
//   dsh_e[y_off + m2] = sum_{p, u} w[w_off + u] * A[p, m2, u]
//   dh_pre = alpha1 * (dW_e . W2^T) * silu'(h_pre),  demb_e = alpha0 * dh_pre . W1^T
// dx_e goes to an [E, dim_in] buffer that K3 (scatter_rows.cu) sums onto the
// source nodes.  The TPU kernel also accumulates dW1/dW2 over all edges by
// carrying them across its sequential grid; Hopper's blocks run in no order,
// so those training-only sums need a second pass and are not computed here.
//
// What bounds it on an H100: its bytes are K1's plus the [E, dim_in] dx
// write (484 MB at 23k atoms, layer 1, f32) and a W2^T pass from L2 per
// edge tile; measured, it takes 5.3 / 19.7 / 5.9 ms in the three layers
// (H100 80GB HBM3, 700 W), latency bound like K1 (six barriers per 8-edge
// tile, the MLP loops walk hidden or WN in sequence with few warps busy).
// Design: one block per destination node over its CSR segment, g[n] loaded
// once into shared memory, kEdgeTile edges per step; dsh is reduced across
// a path's channels by warp shuffles and then across paths in a fixed
// order, so every sum is deterministic.
#include "tp_common.cuh"

namespace nequip {

// dx_groups: int32 [Gx, 4] = (x_row, unused, t_begin, t_end), one per input row
// dx_terms:  int32 [Tx, 3] = (out_row, y_index, w_off), dx_coef[Tx]
// dx_col_group: int32 [dim_in]
// paths:      int32 [P, 6] = (w_off, mul, y_off, y_dim, t_begin, t_end)
// path_terms: int32 [Tp, 3] = (x_row, out_row, m2), path_coef[Tp]
template <typename T>
__global__ void __launch_bounds__(kThreads) conv_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ sh, const T* __restrict__ emb,
    const T* __restrict__ w1, const T* __restrict__ w2, const T* __restrict__ w2t,
    const int32_t* __restrict__ edge_src, const int32_t* __restrict__ dst_ptr,
    const T* __restrict__ g,
    const int32_t* __restrict__ dx_groups, const int32_t* __restrict__ dx_terms,
    const T* __restrict__ dx_coef, const int32_t* __restrict__ dx_col_group,
    const int32_t* __restrict__ paths, const int32_t* __restrict__ path_terms,
    const T* __restrict__ path_coef, int n_paths,
    T* __restrict__ dx_edge, T* __restrict__ dsh, T* __restrict__ demb,
    int dim_in, int sh_dim, int n_emb, int hidden, int wn, int mid_dim,
    T alpha0, T alpha1) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_g = reinterpret_cast<T*>(smem_raw);     // [mid_dim]
  T* s_x = s_g + mid_dim;                      // [kEdgeTile, dim_in]
  T* s_y = s_x + kEdgeTile * dim_in;           // [kEdgeTile, sh_dim]
  T* s_emb = s_y + kEdgeTile * sh_dim;         // [kEdgeTile, n_emb]
  T* s_hpre = s_emb + kEdgeTile * n_emb;       // [kEdgeTile, hidden]
  T* s_h = s_hpre + kEdgeTile * hidden;        // [kEdgeTile, hidden]
  T* s_dh = s_h + kEdgeTile * hidden;          // [kEdgeTile, hidden]
  T* s_w = s_dh + kEdgeTile * hidden;          // [kEdgeTile, wn]
  T* s_dw = s_w + kEdgeTile * wn;              // [kEdgeTile, wn]
  T* s_dshp = s_dw + kEdgeTile * wn;           // [kEdgeTile, n_paths, kMaxYDim]

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int e_begin = dst_ptr[n];
  const int e_end = dst_ptr[n + 1];
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
      s_y[i] = sh[static_cast<int64_t>(base) * sh_dim + i];
    for (int i = tid; i < cnt * n_emb; i += blockDim.x)
      s_emb[i] = emb[static_cast<int64_t>(base) * n_emb + i];
    __syncthreads();

    // recompute the radial MLP (hidden layer, then weights)
    for (int t = tid; t < hidden; t += blockDim.x) {
      T acc[kEdgeTile];
#pragma unroll
      for (int e = 0; e < kEdgeTile; ++e) acc[e] = T(0);
      for (int i = 0; i < n_emb; ++i) {
        const T wv = w1[i * hidden + t];
#pragma unroll
        for (int e = 0; e < kEdgeTile; ++e)
          if (e < cnt) acc[e] += s_emb[e * n_emb + i] * wv;
      }
#pragma unroll
      for (int e = 0; e < kEdgeTile; ++e)
        if (e < cnt) {
          const T a = alpha0 * acc[e];
          s_hpre[e * hidden + t] = a;
          s_h[e * hidden + t] = a * sigmoid(a);
        }
    }
    __syncthreads();
    for (int j = tid; j < wn; j += blockDim.x) {
      T acc[kEdgeTile];
#pragma unroll
      for (int e = 0; e < kEdgeTile; ++e) acc[e] = T(0);
      for (int t = 0; t < hidden; ++t) {
        const T wv = w2[static_cast<int64_t>(t) * wn + j];
#pragma unroll
        for (int e = 0; e < kEdgeTile; ++e)
          if (e < cnt) acc[e] += s_h[e * hidden + t] * wv;
      }
#pragma unroll
      for (int e = 0; e < kEdgeTile; ++e)
        if (e < cnt) s_w[e * wn + j] = alpha1 * acc[e];
    }
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

    // dW and the per-path dsh partials: one warp per (edge, path), lanes over channels
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
          T dw = T(0);
#pragma unroll
          for (int m = 0; m < kMaxYDim; ++m)
            if (m < y_dim) {
              dw += ye[y_off + m] * a[m];
              part[m] += wu * a[m];
            }
          s_dw[e * wn + w_off + u] = dw;
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
          if (m < y_dim) s_dshp[(e * n_paths + p) * kMaxYDim + m] = part[m];
      }
    }
    __syncthreads();

    // dsh: sum the path partials in path order
    for (int i = tid; i < cnt * sh_dim; i += blockDim.x) {
      const int e = i / sh_dim;
      const int c = i - e * sh_dim;
      T acc = T(0);
      for (int p = 0; p < n_paths; ++p) {
        const int m = c - paths[6 * p + 2];
        if (m >= 0 && m < paths[6 * p + 3]) acc += s_dshp[(e * n_paths + p) * kMaxYDim + m];
      }
      dsh[static_cast<int64_t>(base + e) * sh_dim + c] = acc;
    }
    // dh_pre = alpha1 * (dW . W2^T) * silu'(h_pre), W2^T is [wn, hidden]
    for (int t = tid; t < hidden; t += blockDim.x) {
      T acc[kEdgeTile];
#pragma unroll
      for (int e = 0; e < kEdgeTile; ++e) acc[e] = T(0);
      for (int j = 0; j < wn; ++j) {
        const T wv = w2t[static_cast<int64_t>(j) * hidden + t];
#pragma unroll
        for (int e = 0; e < kEdgeTile; ++e)
          if (e < cnt) acc[e] += s_dw[e * wn + j] * wv;
      }
#pragma unroll
      for (int e = 0; e < kEdgeTile; ++e)
        if (e < cnt) {
          const T hp = s_hpre[e * hidden + t];
          const T sg = sigmoid(hp);
          s_dh[e * hidden + t] = alpha1 * acc[e] * (sg * (T(1) + hp * (T(1) - sg)));
        }
    }
    __syncthreads();
    // demb = alpha0 * dh_pre . W1^T, W1 is [n_emb, hidden]
    for (int i = tid; i < cnt * n_emb; i += blockDim.x) {
      const int e = i / n_emb;
      const int c = i - e * n_emb;
      T acc = T(0);
      for (int t = 0; t < hidden; ++t) acc += s_dh[e * hidden + t] * w1[c * hidden + t];
      demb[static_cast<int64_t>(base + e) * n_emb + c] = alpha0 * acc;
    }
  }
}

template <typename T>
int launch_conv_bwd(const void* x, const void* sh, const void* emb, const void* w1,
                    const void* w2, const void* w2t, const void* edge_src,
                    const void* dst_ptr, const void* g, const void* dx_groups,
                    const void* dx_terms, const void* dx_coef, const void* dx_col_group,
                    const void* paths, const void* path_terms, const void* path_coef,
                    void* dx_edge, void* dsh, void* demb, int n_paths, int n_nodes,
                    int dim_in, int sh_dim, int n_emb, int hidden, int wn, int mid_dim,
                    double alpha0, double alpha1, void* stream) {
  const size_t smem =
      sizeof(T) * (static_cast<size_t>(mid_dim) +
                   static_cast<size_t>(kEdgeTile) *
                       (dim_in + sh_dim + n_emb + 3 * hidden + 2 * wn + n_paths * kMaxYDim));
  cudaError_t err = allow_dynamic_smem(conv_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_nodes > 0) {
    conv_bwd_kernel<T><<<n_nodes, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(sh), static_cast<const T*>(emb),
        static_cast<const T*>(w1), static_cast<const T*>(w2), static_cast<const T*>(w2t),
        static_cast<const int32_t*>(edge_src), static_cast<const int32_t*>(dst_ptr),
        static_cast<const T*>(g), static_cast<const int32_t*>(dx_groups),
        static_cast<const int32_t*>(dx_terms), static_cast<const T*>(dx_coef),
        static_cast<const int32_t*>(dx_col_group), static_cast<const int32_t*>(paths),
        static_cast<const int32_t*>(path_terms), static_cast<const T*>(path_coef), n_paths,
        static_cast<T*>(dx_edge), static_cast<T*>(dsh), static_cast<T*>(demb), dim_in,
        sh_dim, n_emb, hidden, wn, mid_dim, static_cast<T>(alpha0), static_cast<T>(alpha1));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nequip

#define NEQUIP_CONV_BWD(SUFFIX, T)                                                             \
  extern "C" int nequip_conv_bwd_##SUFFIX(                                                    \
      const void* x, const void* sh, const void* emb, const void* w1, const void* w2,         \
      const void* w2t, const void* edge_src, const void* dst_ptr, const void* g,              \
      const void* dx_groups, const void* dx_terms, const void* dx_coef,                       \
      const void* dx_col_group, const void* paths, const void* path_terms,                    \
      const void* path_coef, void* dx_edge, void* dsh, void* demb, int n_paths, int n_nodes,  \
      int dim_in, int sh_dim, int n_emb, int hidden, int wn, int mid_dim, double alpha0,      \
      double alpha1, void* stream) {                                                          \
    return nequip::launch_conv_bwd<T>(x, sh, emb, w1, w2, w2t, edge_src, dst_ptr, g,          \
                                      dx_groups, dx_terms, dx_coef, dx_col_group, paths,      \
                                      path_terms, path_coef, dx_edge, dsh, demb, n_paths,     \
                                      n_nodes, dim_in, sh_dim, n_emb, hidden, wn, mid_dim,    \
                                      alpha0, alpha1, stream);                                \
  }

NEQUIP_CONV_BWD(f32, float)
NEQUIP_CONV_BWD(f64, double)
