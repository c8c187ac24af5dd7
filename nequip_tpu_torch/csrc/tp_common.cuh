// Shared constants and helpers of the convolution kernels (K1-K7).
//
// The term tables the kernels loop over are built on the host from the
// tensor product's instruction list (nequip_tpu_torch/ops/kernels/tp_scatter.py,
// TPPlan); their layouts are documented there and at each kernel.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nequip {

constexpr int kThreads = 256;  // threads per block of the conv kernels
constexpr int kEdgeTile = 8;   // edges staged in shared memory per step
constexpr int kMaxYDim = 9;    // widest SH chunk a path may read (l <= 4)

template <typename T>
__device__ __forceinline__ T sigmoid(T x) {
  return T(1) / (T(1) + exp(-x));
}

// Dynamic shared memory above 48 KB must be allowed per kernel first.
template <typename Kernel>
inline cudaError_t allow_dynamic_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace nequip
