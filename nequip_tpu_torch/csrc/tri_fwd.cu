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
// read from an [E, WN] buffer in kernel order.
//
// What bounds it on an H100: bytes, the x[src] gather and the w read
// (419,904 x (288 + 352) x 4 B ~ 1.1 GB in layer 1 at 23k atoms, f32),
// ~0.3 ms at HBM rate; like K1 it is more likely latency bound by its
// per-tile barriers (see PERF.md).
// Design: one block per destination node walks that node's CSR segment of
// the dst-sorted stream, kEdgeTile edges at a time staged in shared memory;
// each thread owns output columns, so the row sums in shared memory without
// atomics and in a fixed order.
//
// K4-acc (nequip_tri_fwd_acc): the same kernel with out += ..., in place on
// an [N, mid_dim] accumulator.  Replaces _forward(acc=...) (kernel body
// _kernel_from_acc, pallas_call at tp_scatter.py:949), which folds one slice
// of the edge stream into running messages in the edge-chunked fr sweep.
// The wrapper hands it a slice's clipped CSR (dst_ptr relative to the
// slice's first edge) and the slice's y/w rows; a block whose node has no
// edge in the slice returns at once and leaves its row untouched, and a
// node whose segment two slices split gets the second part added to the
// first, slice after slice on one stream: deterministic, no atomics.
#include "tp_common.cuh"

namespace nequip {

// groups: int32 [G, 4] = (out_row, w_off, t_begin, t_end), one per (path, m3)
// terms:  int32 [T, 2] = (x_row, y_index) with coef[T] = cg * path_weight
// col_group: int32 [mid_dim], the group owning each output column
template <typename T, bool kAcc>
__global__ void __launch_bounds__(kThreads) tri_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ w,
    const int32_t* __restrict__ edge_src, const int32_t* __restrict__ dst_ptr,
    const int32_t* __restrict__ groups, const int32_t* __restrict__ terms,
    const T* __restrict__ coef, const int32_t* __restrict__ col_group,
    T* __restrict__ out, int dim_in, int sh_dim, int wn, int mid_dim) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_acc = reinterpret_cast<T*>(smem_raw);  // [mid_dim]
  T* s_x = s_acc + mid_dim;                    // [kEdgeTile, dim_in]
  T* s_y = s_x + kEdgeTile * dim_in;           // [kEdgeTile, sh_dim]
  T* s_w = s_y + kEdgeTile * sh_dim;           // [kEdgeTile, wn]

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int e_begin = dst_ptr[n];
  const int e_end = dst_ptr[n + 1];
  if (kAcc && e_begin == e_end) return;  // block-uniform: no barrier is skipped
  for (int o = tid; o < mid_dim; o += blockDim.x)
    s_acc[o] = kAcc ? out[static_cast<int64_t>(n) * mid_dim + o] : T(0);

  for (int base = e_begin; base < e_end; base += kEdgeTile) {
    const int cnt = min(kEdgeTile, e_end - base);
    __syncthreads();  // readers of the previous tile are done
    for (int i = tid; i < cnt * dim_in; i += blockDim.x) {
      const int e = i / dim_in;
      s_x[i] = x[static_cast<int64_t>(edge_src[base + e]) * dim_in + (i - e * dim_in)];
    }
    for (int i = tid; i < cnt * sh_dim; i += blockDim.x)
      s_y[i] = y[static_cast<int64_t>(base) * sh_dim + i];
    for (int i = tid; i < cnt * wn; i += blockDim.x)
      s_w[i] = w[static_cast<int64_t>(base) * wn + i];
    __syncthreads();

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
  __syncthreads();
  for (int o = tid; o < mid_dim; o += blockDim.x)
    out[static_cast<int64_t>(n) * mid_dim + o] = s_acc[o];
}

template <typename T, bool kAcc>
int launch_tri_fwd(const void* x, const void* y, const void* w, const void* edge_src,
                   const void* dst_ptr, const void* groups, const void* terms,
                   const void* coef, const void* col_group, void* out, int n_nodes,
                   int dim_in, int sh_dim, int wn, int mid_dim, void* stream) {
  const size_t smem = sizeof(T) * (static_cast<size_t>(mid_dim) +
                                   static_cast<size_t>(kEdgeTile) * (dim_in + sh_dim + wn));
  cudaError_t err = allow_dynamic_smem(tri_fwd_kernel<T, kAcc>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_nodes > 0) {
    tri_fwd_kernel<T, kAcc><<<n_nodes, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const T*>(w),
        static_cast<const int32_t*>(edge_src), static_cast<const int32_t*>(dst_ptr),
        static_cast<const int32_t*>(groups), static_cast<const int32_t*>(terms),
        static_cast<const T*>(coef), static_cast<const int32_t*>(col_group),
        static_cast<T*>(out), dim_in, sh_dim, wn, mid_dim);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nequip

#define NEQUIP_TRI_FWD(NAME, SUFFIX, T, ACC)                                                 \
  extern "C" int NAME##_##SUFFIX(                                                           \
      const void* x, const void* y, const void* w, const void* edge_src,                    \
      const void* dst_ptr, const void* groups, const void* terms, const void* coef,         \
      const void* col_group, void* out, int n_nodes, int dim_in, int sh_dim, int wn,        \
      int mid_dim, void* stream) {                                                          \
    return nequip::launch_tri_fwd<T, ACC>(x, y, w, edge_src, dst_ptr, groups, terms, coef,  \
                                          col_group, out, n_nodes, dim_in, sh_dim, wn,      \
                                          mid_dim, stream);                                 \
  }

NEQUIP_TRI_FWD(nequip_tri_fwd, f32, float, false)
NEQUIP_TRI_FWD(nequip_tri_fwd, f64, double, false)
NEQUIP_TRI_FWD(nequip_tri_fwd_acc, f32, float, true)
NEQUIP_TRI_FWD(nequip_tri_fwd_acc, f64, double, true)
