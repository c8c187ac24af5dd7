// Shared constants and helpers of the convolution kernels (K1-K7).
//
// The term tables the kernels loop over are built on the host from the
// tensor product's instruction list (nequip_tpu_torch/ops/kernels/tp_scatter.py,
// TPPlan); their layouts are documented there and at each kernel.
//
// Storage and sum types: a kernel instantiated for a storage type S reads
// and writes S in device memory and computes in Acc<S> (registers, every
// product and sum, and shared memory but for the bf16 tiles that K1, K4, K5,
// K6 and K7 keep raw and widen as they read): S itself for float and
// double, float for __nv_bfloat16 (K1, K2's inference variant, K3,
// K4/K4-acc, K5, K6 and K7; bf16 sums run in float32, as the TPU kernels'
// _acc_dtype).  widen /
// narrow convert between the two with the intrinsics only; round_as<S>
// rounds a sum to S's precision and keeps it in Acc<S> (a kernel's stated
// rounding points).  SumF32x2 is a compensated float32 sum (the bf16 sums
// over edges of K1, K4 and K6).
#pragma once

#include <cuda_bf16.h>
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

template <typename S>
struct AccOf {
  using type = S;
};
template <>
struct AccOf<__nv_bfloat16> {
  using type = float;
};
template <typename S>
using Acc = typename AccOf<S>::type;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename S>
__device__ __forceinline__ S narrow(Acc<S> v) {
  if constexpr (sizeof(S) == sizeof(Acc<S>))
    return v;
  else
    return __float2bfloat16(v);
}

template <typename S>
__device__ __forceinline__ Acc<S> round_as(Acc<S> v) {
  return widen(narrow<S>(v));
}

// s + e == a + b exactly, s = fl(a + b) (Knuth's TwoSum, in intrinsics so
// that no step is contracted or reassociated)
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float z = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, z)), __fsub_rn(b, z));
}

// A compensated float32 sum, hi + lo: every addition is float32, and the
// value differs from the exact sum by about n 2^-48 of the sum of |terms|,
// so it does not depend on the order or grouping of the additions to far
// below a bf16 ulp (K1's bf16 form: conv_fwd.cu).
struct SumF32x2 {
  float hi = 0.f, lo = 0.f;
  __device__ __forceinline__ void add(float x) {
    float e;
    two_sum(hi, x, hi, e);
    lo = __fadd_rn(lo, e);
  }
  __device__ __forceinline__ void add(const SumF32x2& o) {
    add(o.hi);
    lo = __fadd_rn(lo, o.lo);
  }
};

// a + v rounded to float32 once (a float32 accumulator of the bf16 forms
// of K4-acc and K6-acc taking one slice's compensated sum)
__device__ __forceinline__ float add_onto(float a, const SumF32x2& v) {
  SumF32x2 s{a, 0.f};
  s.add(v);
  return __fadd_rn(s.hi, s.lo);
}

// The bf16 nearest to hi + lo (ties to even): fl(hi + lo) rounded, unless
// it is a bf16 tie that the rest of the sum breaks.
__device__ __forceinline__ __nv_bfloat16 bf16_of_sum(float hi, float lo) {
  float s, r;
  two_sum(hi, lo, s, r);
  const unsigned b = __float_as_uint(s);
  if ((b & 0xffffu) == 0x8000u && r != 0.f) {
    const unsigned rb = (r > 0.f) == (s > 0.f) ? (b + 0x8000u) & 0xffff0000u : b & 0xffff0000u;  // away from 0, or toward
    return __ushort_as_bfloat16(static_cast<unsigned short>(rb >> 16));
  }
  return __float2bfloat16_rn(s);
}

// one value of S through the read-only cache, widened
__device__ __forceinline__ float ldg_widen(const float* p) { return __ldg(p); }
__device__ __forceinline__ double ldg_widen(const double* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_widen(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// Dynamic shared memory above 48 KB must be allowed per kernel first.
template <typename Kernel>
inline cudaError_t allow_dynamic_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace nequip
