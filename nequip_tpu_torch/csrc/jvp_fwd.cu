// K6: the trilinear convolution and its tangent in one pass, the forward of
// the fr dual sweep.
//
// Replaces the TPU kernel nequip_tpu/ops/pallas/tp_scatter.py, _jvp_forward
// (kernel body _jvp_kernel_T, CG block _compute_tp_jvp_block_T,
// pallas_call at :2118).  With F(x, y, w) = scatter_dst(TP(x[src], y, w))
// (K4, tri_fwd.cu) it computes
//   msg  = F(x, y, w)
//   tmsg = F(tx, y, w) + F(x, ty, w) + F(x, y, dw)
// for node features x and their tangent tx [N, dim_in], per-edge SH y and
// tangent ty [E, sh_dim], radial weights w and tangent dw [E, WN].  Per edge
// e (source s, destination n) and output column (path, m3, u):
//   m  = sum_terms c * y_e[yi] * x[s, x_row + u]
//   tm = sum_terms c * (ty_e[yi] * x[s, x_row + u] + y_e[yi] * tx[s, x_row + u])
//   msg[n]  += w_e  * m
//   tmsg[n] += w_e * tm + dw_e * m
// so the products of each CG term are shared between the primal and the
// three tangent terms, as in _compute_tp_jvp_block_T.  The _acc entry points
// add onto [N, mid_dim] accumulators in place (one slice of the edge-chunked
// sweep; see K4-acc in tri_fwd.cu for the slice contract).
//
// What bounds it on an H100: bytes, the x[src] and tx[src] gathers and the
// w/dw reads (419,904 x (2 x 288 + 2 x 352) x 4 B ~ 2.1 GB in layer 1 at 23k
// atoms, f32), ~0.65 ms at HBM rate; like K4 it is more likely latency
// bound by its barriers per edge tile.
// Design: K4's, one block per destination node over its CSR segment,
// kEdgeTile edges staged in shared memory (x, tx, y, ty, w, dw), each thread
// owning output columns of both rows, so every sum is in a fixed order and
// needs no atomics.  The TPU's one-hot scatter matmul is not needed: the
// block owns its destination rows.  Shared memory is 2 x mid_dim +
// kEdgeTile x 2 x (dim_in + sh_dim + WN) values, 101 KB in layer 1 in f64,
// so it is allowed above 48 KB.
#include "tp_common.cuh"

namespace nequip {

// groups: int32 [G, 4] = (out_row, w_off, t_begin, t_end), one per (path, m3)
// terms:  int32 [T, 2] = (x_row, y_index) with coef[T] = cg * path_weight
// col_group: int32 [mid_dim], the group owning each output column
template <typename T, bool kAcc>
__global__ void __launch_bounds__(kThreads) jvp_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ tx, const T* __restrict__ y,
    const T* __restrict__ ty, const T* __restrict__ w, const T* __restrict__ dw,
    const int32_t* __restrict__ edge_src, const int32_t* __restrict__ dst_ptr,
    const int32_t* __restrict__ groups, const int32_t* __restrict__ terms,
    const T* __restrict__ coef, const int32_t* __restrict__ col_group,
    T* __restrict__ out, T* __restrict__ tout, int dim_in, int sh_dim, int wn, int mid_dim) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_acc = reinterpret_cast<T*>(smem_raw);  // [mid_dim]
  T* s_tacc = s_acc + mid_dim;                 // [mid_dim]
  T* s_x = s_tacc + mid_dim;                   // [kEdgeTile, dim_in]
  T* s_tx = s_x + kEdgeTile * dim_in;          // [kEdgeTile, dim_in]
  T* s_y = s_tx + kEdgeTile * dim_in;          // [kEdgeTile, sh_dim]
  T* s_ty = s_y + kEdgeTile * sh_dim;          // [kEdgeTile, sh_dim]
  T* s_w = s_ty + kEdgeTile * sh_dim;          // [kEdgeTile, wn]
  T* s_dw = s_w + kEdgeTile * wn;              // [kEdgeTile, wn]

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int e_begin = dst_ptr[n];
  const int e_end = dst_ptr[n + 1];
  if (kAcc && e_begin == e_end) return;  // block-uniform: no barrier is skipped
  const int64_t row = static_cast<int64_t>(n) * mid_dim;
  for (int o = tid; o < mid_dim; o += blockDim.x) {
    s_acc[o] = kAcc ? out[row + o] : T(0);
    s_tacc[o] = kAcc ? tout[row + o] : T(0);
  }

  for (int base = e_begin; base < e_end; base += kEdgeTile) {
    const int cnt = min(kEdgeTile, e_end - base);
    __syncthreads();  // readers of the previous tile are done
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

    for (int o = tid; o < mid_dim; o += blockDim.x) {
      const int32_t* gr = groups + 4 * col_group[o];
      const int u = o - gr[0];
      const int w_col = gr[1] + u;
      const int t0 = gr[2];
      const int t1 = gr[3];
      T total = s_acc[o];
      T ttotal = s_tacc[o];
      for (int e = 0; e < cnt; ++e) {
        const T* xe = s_x + e * dim_in;
        const T* txe = s_tx + e * dim_in;
        const T* ye = s_y + e * sh_dim;
        const T* tye = s_ty + e * sh_dim;
        T m = T(0);
        T tm = T(0);
        for (int k = t0; k < t1; ++k) {
          const int xr = terms[2 * k] + u;
          const int yi = terms[2 * k + 1];
          const T c = coef[k];
          m += c * ye[yi] * xe[xr];
          tm += c * (tye[yi] * xe[xr] + ye[yi] * txe[xr]);
        }
        const T we = s_w[e * wn + w_col];
        total += we * m;
        ttotal += we * tm + s_dw[e * wn + w_col] * m;
      }
      s_acc[o] = total;
      s_tacc[o] = ttotal;
    }
  }
  __syncthreads();
  for (int o = tid; o < mid_dim; o += blockDim.x) {
    out[row + o] = s_acc[o];
    tout[row + o] = s_tacc[o];
  }
}

template <typename T, bool kAcc>
int launch_jvp_fwd(const void* x, const void* tx, const void* y, const void* ty, const void* w,
                   const void* dw, const void* edge_src, const void* dst_ptr, const void* groups,
                   const void* terms, const void* coef, const void* col_group, void* out,
                   void* tout, int n_nodes, int dim_in, int sh_dim, int wn, int mid_dim,
                   void* stream) {
  const size_t smem = sizeof(T) * (2 * static_cast<size_t>(mid_dim) +
                                   2 * static_cast<size_t>(kEdgeTile) * (dim_in + sh_dim + wn));
  cudaError_t err = allow_dynamic_smem(jvp_fwd_kernel<T, kAcc>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_nodes > 0) {
    jvp_fwd_kernel<T, kAcc><<<n_nodes, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(tx), static_cast<const T*>(y),
        static_cast<const T*>(ty), static_cast<const T*>(w), static_cast<const T*>(dw),
        static_cast<const int32_t*>(edge_src), static_cast<const int32_t*>(dst_ptr),
        static_cast<const int32_t*>(groups), static_cast<const int32_t*>(terms),
        static_cast<const T*>(coef), static_cast<const int32_t*>(col_group),
        static_cast<T*>(out), static_cast<T*>(tout), dim_in, sh_dim, wn, mid_dim);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nequip

#define NEQUIP_JVP_FWD(NAME, SUFFIX, T, ACC)                                                  \
  extern "C" int NAME##_##SUFFIX(                                                            \
      const void* x, const void* tx, const void* y, const void* ty, const void* w,           \
      const void* dw, const void* edge_src, const void* dst_ptr, const void* groups,         \
      const void* terms, const void* coef, const void* col_group, void* out, void* tout,     \
      int n_nodes, int dim_in, int sh_dim, int wn, int mid_dim, void* stream) {              \
    return nequip::launch_jvp_fwd<T, ACC>(x, tx, y, ty, w, dw, edge_src, dst_ptr, groups,    \
                                          terms, coef, col_group, out, tout, n_nodes,        \
                                          dim_in, sh_dim, wn, mid_dim, stream);              \
  }

NEQUIP_JVP_FWD(nequip_jvp_fwd, f32, float, false)
NEQUIP_JVP_FWD(nequip_jvp_fwd, f64, double, false)
NEQUIP_JVP_FWD(nequip_jvp_fwd_acc, f32, float, true)
NEQUIP_JVP_FWD(nequip_jvp_fwd_acc, f64, double, true)
