// The radial-MLP weight gradients of K2's training variant: a deterministic
// reduction over the edges,
//   out[p, q] = scale * sum_{e < n} a[e, p] * b[e, q]
// with (a, b, scale) = (h_e, dW_e, alpha1) for dW2 [hidden, WN] and
// (emb_e, dh_pre_e, alpha0) for dW1 [n_emb, hidden].
//
// Replaces the dW1/dW2 accumulation inside the TPU kernel
// nequip_tpu/ops/pallas/tp_scatter.py, _make_fused_mlp.kernel_bwd (kernel
// body _bwd_mlp_kernel_T), which carries the two sums in its output blocks
// across its sequential grid.  Hopper's blocks run in no order, so the sum
// is split: pass 1 gives each block a fixed chunk of `chunk` edges and one
// 32 x 32 tile of the output and writes that chunk's partial tile; pass 2
// sums the partials of each output value in chunk order.  No atomics, so
// two calls give bitwise equal results.
//
// What bounds it on an H100: bytes.  Each 32-column slice of a is read once
// per 32-column tile of b and vice versa: for dW2 in layer 1 at 23k atoms
// (f32) that is 11 reads of h_e (215 MB) and 4 of dW_e (591 MB), ~4.7 GB,
// ~1.5 ms at HBM rate, less where L2 serves the repeats; the partials
// (ceil(E / chunk) x hidden x WN) are ~37 MB.
#include <cuda_runtime.h>
#include <stdint.h>

namespace nequip {

constexpr int kOuterTile = 32;      // output tile is kOuterTile x kOuterTile
constexpr int kOuterThreads = 256;  // 8 warps, each owning 4 tile rows

template <typename T>
__global__ void __launch_bounds__(kOuterThreads) outer_partial_kernel(
    const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ partial, int n, int P,
    int Q, int chunk) {
  __shared__ T s_a[kOuterTile][kOuterTile + 1];  // [edge][p]
  __shared__ T s_b[kOuterTile][kOuterTile + 1];  // [edge][q]
  const int c_idx = blockIdx.x;
  const int p0 = blockIdx.y * kOuterTile;
  const int q0 = blockIdx.z * kOuterTile;
  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  constexpr int kRows = kOuterTile / (kOuterThreads / 32);
  T acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = T(0);
  const int e_begin = c_idx * chunk;
  const int e_end = min(n, e_begin + chunk);
  for (int e0 = e_begin; e0 < e_end; e0 += kOuterTile) {
    for (int i = tid; i < kOuterTile * kOuterTile; i += kOuterThreads) {
      const int r = i / kOuterTile;
      const int c = i - r * kOuterTile;
      const int e = e0 + r;
      s_a[r][c] = (e < e_end && p0 + c < P) ? a[static_cast<int64_t>(e) * P + p0 + c] : T(0);
      s_b[r][c] = (e < e_end && q0 + c < Q) ? b[static_cast<int64_t>(e) * Q + q0 + c] : T(0);
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kOuterTile; ++k) {
      const T bv = s_b[k][tx];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] += s_a[k][ty + r * (kOuterThreads / 32)] * bv;
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int p = p0 + ty + r * (kOuterThreads / 32);
    const int q = q0 + tx;
    if (p < P && q < Q) partial[(static_cast<int64_t>(c_idx) * P + p) * Q + q] = acc[r];
  }
}

template <typename T>
__global__ void sum_partials_kernel(const T* __restrict__ partial, T* __restrict__ out,
                                    int n_chunks, int pq, T scale) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= pq) return;
  T acc = T(0);
  for (int c = 0; c < n_chunks; ++c) acc += partial[static_cast<int64_t>(c) * pq + i];
  out[i] = scale * acc;
}

template <typename T>
int launch_dw_reduce(const void* a, const void* b, void* partial, void* out, int n, int P,
                     int Q, int chunk, double scale, void* stream) {
  if (P <= 0 || Q <= 0) return static_cast<int>(cudaSuccess);
  const int n_chunks = n > 0 ? (n + chunk - 1) / chunk : 1;
  const dim3 grid(n_chunks, (P + kOuterTile - 1) / kOuterTile, (Q + kOuterTile - 1) / kOuterTile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  outer_partial_kernel<T><<<grid, kOuterThreads, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(partial), n, P, Q,
      chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pq = P * Q;
  sum_partials_kernel<T><<<(pq + 255) / 256, 256, 0, s>>>(
      static_cast<const T*>(partial), static_cast<T*>(out), n_chunks, pq, static_cast<T>(scale));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nequip

extern "C" int nequip_dw_reduce_f32(const void* a, const void* b, void* partial, void* out,
                                    int n, int P, int Q, int chunk, double scale, void* stream) {
  return nequip::launch_dw_reduce<float>(a, b, partial, out, n, P, Q, chunk, scale, stream);
}

extern "C" int nequip_dw_reduce_f64(const void* a, const void* b, void* partial, void* out,
                                    int n, int P, int Q, int chunk, double scale, void* stream) {
  return nequip::launch_dw_reduce<double>(a, b, partial, out, n, P, Q, chunk, scale, stream);
}
