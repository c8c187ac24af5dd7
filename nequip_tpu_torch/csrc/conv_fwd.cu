// K1: fused convolution forward, gather -> radial MLP -> CG tensor product
// -> sum into the destination node.
//
// Replaces the TPU kernel nequip_tpu/ops/pallas/tp_scatter.py,
// _make_fused_mlp.forward (kernel body _fwd_mlp_kernel_T, CG block
// _compute_tp_block_T).  Per edge e with source s and destination n:
//   w_e = alpha1 * silu(alpha0 * emb_e . W1) . W2            (radial MLP)
//   out[n, out_row + u] += w_e[w_off + u] * sum_terms c * sh_e[y] * x[s, x_row + u]
//
// What bounds it on an H100: its bytes are the x[src] gather (419,904 x 288
// x 4 B ~ 484 MB in layer 1 at 23k atoms, f32) and W2 (128 x 352 x 4 B =
// 180 KB) read from L2 per edge tile, ~0.2 ms at HBM rate; measured, it
// takes 5.9 / 14.4 / 6.0 ms in the three layers (H100 80GB HBM3, 700 W), so
// it is bound by latency: each 8-edge tile passes four barriers, and in the
// radial-weight loop only WN threads (96 of 256 in layers 0 and 2) are busy,
// each walking the 128 hidden units in sequence.
// Design: one block per destination node walks that node's CSR segment of
// the dst-sorted edge stream, so the node's output row (<= 1120 values)
// accumulates in shared memory and is written once: no atomics, and the sum
// order is fixed.  Edges are staged kEdgeTile at a time, so each W1/W2 value
// read from L2 serves kEdgeTile edges, and the [E, WN] radial weights never
// reach device memory.  The CG terms come from a run-time table (one group
// per output row (path, m3)).  Tiles spanning several nodes (more edges per
// W2 pass) and per-model generated code are the next steps for speed.
#include "tp_common.cuh"

namespace nequip {

// groups: int32 [G, 4] = (out_row, w_off, t_begin, t_end), one per (path, m3)
// terms:  int32 [T, 2] = (x_row, y_index) with coef[T] = cg * path_weight
// col_group: int32 [mid_dim], the group owning each output column
template <typename T>
__global__ void __launch_bounds__(kThreads) conv_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ sh, const T* __restrict__ emb,
    const T* __restrict__ w1, const T* __restrict__ w2,
    const int32_t* __restrict__ edge_src, const int32_t* __restrict__ dst_ptr,
    const int32_t* __restrict__ groups, const int32_t* __restrict__ terms,
    const T* __restrict__ coef, const int32_t* __restrict__ col_group,
    T* __restrict__ out,
    int dim_in, int sh_dim, int n_emb, int hidden, int wn, int mid_dim,
    T alpha0, T alpha1) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_acc = reinterpret_cast<T*>(smem_raw);  // [mid_dim]
  T* s_x = s_acc + mid_dim;                    // [kEdgeTile, dim_in]
  T* s_y = s_x + kEdgeTile * dim_in;           // [kEdgeTile, sh_dim]
  T* s_emb = s_y + kEdgeTile * sh_dim;         // [kEdgeTile, n_emb]
  T* s_h = s_emb + kEdgeTile * n_emb;          // [kEdgeTile, hidden]
  T* s_w = s_h + kEdgeTile * hidden;           // [kEdgeTile, wn]

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int e_begin = dst_ptr[n];
  const int e_end = dst_ptr[n + 1];
  for (int o = tid; o < mid_dim; o += blockDim.x) s_acc[o] = T(0);

  for (int base = e_begin; base < e_end; base += kEdgeTile) {
    const int cnt = min(kEdgeTile, e_end - base);
    __syncthreads();  // readers of the previous tile are done
    for (int i = tid; i < cnt * dim_in; i += blockDim.x) {
      const int e = i / dim_in;
      s_x[i] = x[static_cast<int64_t>(edge_src[base + e]) * dim_in + (i - e * dim_in)];
    }
    for (int i = tid; i < cnt * sh_dim; i += blockDim.x)
      s_y[i] = sh[static_cast<int64_t>(base) * sh_dim + i];
    for (int i = tid; i < cnt * n_emb; i += blockDim.x)
      s_emb[i] = emb[static_cast<int64_t>(base) * n_emb + i];
    __syncthreads();

    // hidden layer: h = silu(alpha0 * emb . W1), W1 is [n_emb, hidden]
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
          s_h[e * hidden + t] = a * sigmoid(a);
        }
    }
    __syncthreads();

    // radial weights: w = alpha1 * h . W2, W2 is [hidden, wn]
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

    // CG product: each thread owns its output columns, so no races
    for (int o = tid; o < mid_dim; o += blockDim.x) {
      const int32_t* gr = groups + 4 * col_group[o];
      const int u = o - gr[0];
      const int w_col = gr[1] + u;
      const int t0 = gr[2];
      const int t1 = gr[3];
      T total = s_acc[o];
      for (int e = 0; e < cnt; ++e) {
        const T* xe = s_x + e * dim_in;
        const T* ye = s_y + e * sh_dim;
        T m = T(0);
        for (int k = t0; k < t1; ++k) m += coef[k] * ye[terms[2 * k + 1]] * xe[terms[2 * k] + u];
        total += s_w[e * wn + w_col] * m;
      }
      s_acc[o] = total;
    }
  }
  for (int o = tid; o < mid_dim; o += blockDim.x)
    out[static_cast<int64_t>(n) * mid_dim + o] = s_acc[o];
}

template <typename T>
int launch_conv_fwd(const void* x, const void* sh, const void* emb, const void* w1,
                    const void* w2, const void* edge_src, const void* dst_ptr,
                    const void* groups, const void* terms, const void* coef,
                    const void* col_group, void* out, int n_nodes, int dim_in, int sh_dim,
                    int n_emb, int hidden, int wn, int mid_dim, double alpha0, double alpha1,
                    void* stream) {
  const size_t smem = sizeof(T) * (static_cast<size_t>(mid_dim) +
                                   static_cast<size_t>(kEdgeTile) *
                                       (dim_in + sh_dim + n_emb + hidden + wn));
  cudaError_t err = allow_dynamic_smem(conv_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_nodes > 0) {
    conv_fwd_kernel<T><<<n_nodes, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(sh), static_cast<const T*>(emb),
        static_cast<const T*>(w1), static_cast<const T*>(w2),
        static_cast<const int32_t*>(edge_src), static_cast<const int32_t*>(dst_ptr),
        static_cast<const int32_t*>(groups), static_cast<const int32_t*>(terms),
        static_cast<const T*>(coef), static_cast<const int32_t*>(col_group),
        static_cast<T*>(out), dim_in, sh_dim, n_emb, hidden, wn, mid_dim,
        static_cast<T>(alpha0), static_cast<T>(alpha1));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nequip

#define NEQUIP_CONV_FWD(SUFFIX, T)                                                          \
  extern "C" int nequip_conv_fwd_##SUFFIX(                                                 \
      const void* x, const void* sh, const void* emb, const void* w1, const void* w2,      \
      const void* edge_src, const void* dst_ptr, const void* groups, const void* terms,    \
      const void* coef, const void* col_group, void* out, int n_nodes, int dim_in,         \
      int sh_dim, int n_emb, int hidden, int wn, int mid_dim, double alpha0, double alpha1, \
      void* stream) {                                                                      \
    return nequip::launch_conv_fwd<T>(x, sh, emb, w1, w2, edge_src, dst_ptr, groups, terms, \
                                      coef, col_group, out, n_nodes, dim_in, sh_dim, n_emb, \
                                      hidden, wn, mid_dim, alpha0, alpha1, stream);         \
  }

NEQUIP_CONV_FWD(f32, float)
NEQUIP_CONV_FWD(f64, double)
