// cp.async staging of global memory into shared memory, and the 16-byte
// loads and stores of V = 16 / sizeof(T) registers: the helpers of the
// kernels that stream a matrix through a shared-memory ring (dw_reduce.cu,
// radial_mlp.cuh) or stage an edge tile (dense_tiles.cuh).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nequip {

// one 16-byte shared load into V = 16 / sizeof(T) consecutive registers
__device__ __forceinline__ void load16(float* d, const float* s) {
  const float4 v = *reinterpret_cast<const float4*>(s);
  d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
}
__device__ __forceinline__ void load16(double* d, const double* s) {
  const double2 v = *reinterpret_cast<const double2*>(s);
  d[0] = v.x, d[1] = v.y;
}

// one 16-byte store of V registers (shared or global memory)
__device__ __forceinline__ void store16(float* d, const float* s) {
  *reinterpret_cast<float4*>(d) = make_float4(s[0], s[1], s[2], s[3]);
}
__device__ __forceinline__ void store16(double* d, const double* s) {
  *reinterpret_cast<double2*>(d) = make_double2(s[0], s[1]);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte copy into shared memory; zeros when !valid
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// one element of BYTES bytes into shared memory; zero when !valid
template <int BYTES>
__device__ __forceinline__ void cp_async_elem(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)), "l"(src), "n"(BYTES),
               "r"(valid ? BYTES : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace nequip
