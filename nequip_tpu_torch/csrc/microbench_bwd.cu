// T2 and T4: the conv-block microbenchmark backward, the CG-VJP of one
// constant chunk of `be` edges computed `grid` times.
//
// Replaces the TPU kernels tools/kernel_microbench.py, make_bwd (T2, row
// layout, pallas_call at :189, block _compute_tp_bwd_block) and make_bwd_t
// (T4, feature-major layout, :313, block _compute_tp_bwd_block_T).  For the
// cotangent g of msg = TP(x, y, w), per edge e:
//   dx_e[x_row + u]  = sum_terms w_e[w_off + u] * c * y_e[yi] * g_e[out_row + u]
//   A[p, m2, u]      = sum_terms of path p with m2  c * x_e[x_row + u] * g_e[out_row + u]
//   dw_e[w_off + u]  = sum_m2 y_e[y_off + m2] * A[p, m2, u]
//   dy_e[y_off + m2] = sum_{p, u} w_e[w_off + u] * A[p, m2, u]
// Every step recomputes (dx, dy, dw) of the whole chunk, as each TPU step
// zeroes and rewrites its dx/dy outputs and its dw scratch.  Row layout:
// operands and results [be, width]; feature-major: [width, be].
//
// What bounds it on an H100: operations (the chunk sits in L2); at the
// tool's defaults 2048 x 256 edges x (7 x 2784 + 4 x 1056) ~ 12.4 GFLOP,
// 0.19 ms at 67 TFLOP/s f32, while the per-step results are 600 KB of writes.
// Measured, 13.7 ms row-major and 14.7 ms feature-major (H100 80GB HBM3,
// 700 W): latency of the per-tile loops, as in K5.
// Design: tri_bwd.cu's per-edge VJP (dx one thread per input column; dw and
// the per-path dy partials one warp per (edge, path), reduced by shuffles;
// dy summed over paths in a fixed order), kEdgeTile edges at a time through
// shared memory, over a persistent grid of n_blocks blocks that take the
// steps step = blockIdx.x, + gridDim.x, ...  Each block writes its results
// into its own slot of [n_blocks, ...] outputs, so no two blocks write one
// address; the wrapper returns the slot of the block that ran the last step.
#include "tp_common.cuh"

namespace nequip {
namespace mb {

constexpr int kBwdTS = kEdgeTile + 1;  // stride of a feature-major tile (no bank conflicts)

template <bool kT>
__device__ __forceinline__ int btix(int e, int c, int width) {
  return kT ? c * kBwdTS + e : e * width + c;
}

// global element (edge base + e, feature c) of a [be, width] or [width, be] array
template <bool kT>
__device__ __forceinline__ int64_t gix(int e, int c, int width, int be) {
  return kT ? static_cast<int64_t>(c) * be + e : static_cast<int64_t>(e) * width + c;
}

template <bool kT, typename T>
__device__ __forceinline__ void stage_tile(T* s, const T* __restrict__ g, int base, int width, int be) {
  for (int i = threadIdx.x; i < kEdgeTile * width; i += blockDim.x) {
    int e, c;
    if (kT) {
      c = i / kEdgeTile;
      e = i - c * kEdgeTile;
    } else {
      e = i / width;
      c = i - e * width;
    }
    s[btix<kT>(e, c, width)] = g[gix<kT>(base + e, c, width, be)];
  }
}

// dx_groups: int32 [Gx, 4] = (x_row, unused, t_begin, t_end), one per input row
// dx_terms:  int32 [Tx, 3] = (out_row, y_index, w_off), dx_coef[Tx]
// dx_col_group: int32 [dim_in]
// paths:      int32 [P, 6] = (w_off, mul, y_off, y_dim, t_begin, t_end)
// path_terms: int32 [Tp, 3] = (x_row, out_row, m2), path_coef[Tp]
template <typename T, bool kT>
__global__ void __launch_bounds__(kThreads) mb_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ g,
    const T* __restrict__ w, const int32_t* __restrict__ dx_groups,
    const int32_t* __restrict__ dx_terms, const T* __restrict__ dx_coef,
    const int32_t* __restrict__ dx_col_group, const int32_t* __restrict__ paths,
    const int32_t* __restrict__ path_terms, const T* __restrict__ path_coef, int n_paths,
    T* __restrict__ dx_out, T* __restrict__ dy_out, T* __restrict__ dw_out, int be, int dim_in,
    int sh_dim, int wn, int mid_dim, int grid) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_x = reinterpret_cast<T*>(smem_raw);  // every tile holds kBwdTS x width elements
  T* s_y = s_x + kBwdTS * dim_in;
  T* s_g = s_y + kBwdTS * sh_dim;
  T* s_w = s_g + kBwdTS * mid_dim;
  T* s_dyp = s_w + kBwdTS * wn;  // [kEdgeTile, n_paths, kMaxYDim]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  T* dx = dx_out + static_cast<int64_t>(blockIdx.x) * be * dim_in;
  T* dy = dy_out + static_cast<int64_t>(blockIdx.x) * be * sh_dim;
  T* dw = dw_out + static_cast<int64_t>(blockIdx.x) * be * wn;

  for (int step = blockIdx.x; step < grid; step += gridDim.x) {
    for (int base = 0; base < be; base += kEdgeTile) {
      __syncthreads();  // readers of the previous tile are done
      stage_tile<kT>(s_x, x, base, dim_in, be);
      stage_tile<kT>(s_y, y, base, sh_dim, be);
      stage_tile<kT>(s_g, g, base, mid_dim, be);
      stage_tile<kT>(s_w, w, base, wn, be);
      __syncthreads();

      // dx: one thread per input column
      for (int c = tid; c < dim_in; c += blockDim.x) {
        const int32_t* gr = dx_groups + 4 * dx_col_group[c];
        const int u = c - gr[0];
        const int t0 = gr[2];
        const int t1 = gr[3];
        for (int e = 0; e < kEdgeTile; ++e) {
          T acc = T(0);
          for (int k = t0; k < t1; ++k) {
            const int32_t* tk = dx_terms + 3 * k;
            acc += dx_coef[k] * s_y[btix<kT>(e, tk[1], sh_dim)] * s_g[btix<kT>(e, tk[0] + u, mid_dim)] *
                   s_w[btix<kT>(e, tk[2] + u, wn)];
          }
          dx[gix<kT>(base + e, c, dim_in, be)] = acc;
        }
      }

      // dw and the per-path dy partials: one warp per (edge, path), lanes over channels
      for (int pe = warp; pe < kEdgeTile * n_paths; pe += n_warps) {
        const int e = pe / n_paths;
        const int p = pe - e * n_paths;
        const int32_t* pt = paths + 6 * p;
        const int w_off = pt[0], mul = pt[1], y_off = pt[2], y_dim = pt[3];
        const int t0 = pt[4], t1 = pt[5];
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
              const T v = path_coef[k] * s_x[btix<kT>(e, tk[0] + u, dim_in)] * s_g[btix<kT>(e, tk[1] + u, mid_dim)];
#pragma unroll
              for (int m = 0; m < kMaxYDim; ++m)
                if (m == tk[2]) a[m] += v;
            }
            const T wu = s_w[btix<kT>(e, w_off + u, wn)];
            T dwu = T(0);
#pragma unroll
            for (int m = 0; m < kMaxYDim; ++m)
              if (m < y_dim) {
                dwu += s_y[btix<kT>(e, y_off + m, sh_dim)] * a[m];
                part[m] += wu * a[m];
              }
            dw[gix<kT>(base + e, w_off + u, wn, be)] = dwu;
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
      for (int i = tid; i < kEdgeTile * sh_dim; i += blockDim.x) {
        const int e = i / sh_dim;
        const int c = i - e * sh_dim;
        T acc = T(0);
        for (int p = 0; p < n_paths; ++p) {
          const int m = c - paths[6 * p + 2];
          if (m >= 0 && m < paths[6 * p + 3]) acc += s_dyp[(e * n_paths + p) * kMaxYDim + m];
        }
        dy[gix<kT>(base + e, c, sh_dim, be)] = acc;
      }
    }
  }
}

template <typename T, bool kT>
int launch_mb_bwd_layout(const void* x, const void* y, const void* g, const void* w,
                         const void* dx_groups, const void* dx_terms, const void* dx_coef,
                         const void* dx_col_group, const void* paths, const void* path_terms,
                         const void* path_coef, void* dx, void* dy, void* dw, int n_paths, int be,
                         int dim_in, int sh_dim, int wn, int mid_dim, int grid, int n_blocks,
                         cudaStream_t stream) {
  const size_t smem = sizeof(T) * (static_cast<size_t>(kBwdTS) * (dim_in + sh_dim + mid_dim + wn) +
                                   static_cast<size_t>(kEdgeTile) * n_paths * kMaxYDim);
  cudaError_t err = allow_dynamic_smem(mb_bwd_kernel<T, kT>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mb_bwd_kernel<T, kT><<<n_blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const T*>(g),
      static_cast<const T*>(w), static_cast<const int32_t*>(dx_groups),
      static_cast<const int32_t*>(dx_terms), static_cast<const T*>(dx_coef),
      static_cast<const int32_t*>(dx_col_group), static_cast<const int32_t*>(paths),
      static_cast<const int32_t*>(path_terms), static_cast<const T*>(path_coef), n_paths,
      static_cast<T*>(dx), static_cast<T*>(dy), static_cast<T*>(dw), be, dim_in, sh_dim, wn,
      mid_dim, grid);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_mb_bwd(const void* x, const void* y, const void* g, const void* w, const void* dx_groups,
                  const void* dx_terms, const void* dx_coef, const void* dx_col_group,
                  const void* paths, const void* path_terms, const void* path_coef, void* dx,
                  void* dy, void* dw, int n_paths, int be, int dim_in, int sh_dim, int wn,
                  int mid_dim, int grid, int n_blocks, int layout_t, void* stream) {
  if (be % kEdgeTile != 0 || n_blocks < 1 || n_blocks > grid) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return layout_t
             ? launch_mb_bwd_layout<T, true>(x, y, g, w, dx_groups, dx_terms, dx_coef, dx_col_group,
                                             paths, path_terms, path_coef, dx, dy, dw, n_paths, be,
                                             dim_in, sh_dim, wn, mid_dim, grid, n_blocks, s)
             : launch_mb_bwd_layout<T, false>(x, y, g, w, dx_groups, dx_terms, dx_coef, dx_col_group,
                                              paths, path_terms, path_coef, dx, dy, dw, n_paths, be,
                                              dim_in, sh_dim, wn, mid_dim, grid, n_blocks, s);
}

}  // namespace mb
}  // namespace nequip

#define NEQUIP_MB_BWD(SUFFIX, T)                                                                 \
  extern "C" int nequip_mb_bwd_##SUFFIX(                                                        \
      const void* x, const void* y, const void* g, const void* w, const void* dx_groups,        \
      const void* dx_terms, const void* dx_coef, const void* dx_col_group, const void* paths,   \
      const void* path_terms, const void* path_coef, void* dx, void* dy, void* dw, int n_paths, \
      int be, int dim_in, int sh_dim, int wn, int mid_dim, int grid, int n_blocks, int layout_t, \
      void* stream) {                                                                           \
    return nequip::mb::launch_mb_bwd<T>(x, y, g, w, dx_groups, dx_terms, dx_coef, dx_col_group, \
                                        paths, path_terms, path_coef, dx, dy, dw, n_paths, be,  \
                                        dim_in, sh_dim, wn, mid_dim, grid, n_blocks, layout_t,  \
                                        stream);                                                \
  }

NEQUIP_MB_BWD(f32, float)
NEQUIP_MB_BWD(f64, double)
