// K3: row scatter-sum, out[n, :] = sum of v[perm[j], :] over n's CSR segment.
//
// Replaces the TPU kernel nequip_tpu/ops/pallas/tp_scatter.py,
// pallas_scatter_sum.one_pass (kernel body _scatter_rows_kernel), which the
// fused backward calls from _dx_scatter to sum per-edge dx onto source nodes.
// The TPU version scatters through a one-hot matmul on 128-row node tiles;
// on Hopper that is wasted work, so this is a plain segmented reduction.
//
// What bounds it on an H100: memory traffic, one read of the [E, D] values
// (420k x 288 x 4 B ~ 484 MB at 23k atoms, layer 1, f32) in a gathered
// order, and one write of [N, D]; measured, layer 1 takes 0.27 ms
// (~1.8 TB/s, H100 80GB HBM3, 700 W).  Design: one block per output row walks
// the row's segment of the stable source-sorted permutation with threads
// over D, so each gathered row is read as contiguous 4- or 8-byte words
// across a warp; no atomics, and the sum order is the edge order.
//
// bf16 (the fast mode's forces): values and out are bf16, each element is
// widened on its read and summed in a float32 register in the same edge
// order, and the sum is rounded to bf16 once, on its store (the plain
// version, tp_scatter.scatter_rows_plain, rounds at the same point).  Its
// bound is half the f32 one: 2 bytes a value.
#include "tp_common.cuh"

namespace nequip {

// S: the storage type; the sum runs in Acc<S> (tp_common.cuh)
template <typename S>
__global__ void scatter_rows_kernel(const S* __restrict__ v, const int32_t* __restrict__ perm,
                                    const int32_t* __restrict__ ptr, S* __restrict__ out,
                                    int d) {
  using A = Acc<S>;
  const int n = blockIdx.x;
  const int j0 = ptr[n];
  const int j1 = ptr[n + 1];
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    A acc = A(0);
    for (int j = j0; j < j1; ++j) acc += widen(v[static_cast<int64_t>(perm[j]) * d + c]);
    out[static_cast<int64_t>(n) * d + c] = narrow<S>(acc);
  }
}

template <typename T>
int launch_scatter_rows(const void* v, const void* perm, const void* ptr, void* out,
                        int n_rows, int d, void* stream) {
  const int threads = d >= 256 ? 256 : ((d + 31) / 32) * 32;
  if (n_rows > 0 && d > 0) {
    scatter_rows_kernel<T><<<n_rows, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(v), static_cast<const int32_t*>(perm),
        static_cast<const int32_t*>(ptr), static_cast<T*>(out), d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nequip

extern "C" int nequip_scatter_rows_f32(const void* v, const void* perm, const void* ptr,
                                       void* out, int n_rows, int d, void* stream) {
  return nequip::launch_scatter_rows<float>(v, perm, ptr, out, n_rows, d, stream);
}

extern "C" int nequip_scatter_rows_f64(const void* v, const void* perm, const void* ptr,
                                       void* out, int n_rows, int d, void* stream) {
  return nequip::launch_scatter_rows<double>(v, perm, ptr, out, n_rows, d, stream);
}

extern "C" int nequip_scatter_rows_bf16(const void* v, const void* perm, const void* ptr,
                                        void* out, int n_rows, int d, void* stream) {
  return nequip::launch_scatter_rows<__nv_bfloat16>(v, perm, ptr, out, n_rows, d, stream);
}
