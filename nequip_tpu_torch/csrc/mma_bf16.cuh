// The tensor-core pieces of the bf16 kernels: ldmatrix loads of 8 x 8 bf16
// matrices from shared memory, the mma.sync m16n8k16 product with bf16
// operands and float32 accumulators (a bf16 x bf16 product is exact in
// float32), and the conversions that feed a float32 value to it.  Shared by
// dw_reduce.cu (the bf16 dW reduction's pass 1) and radial_mlp.cuh
// (tile_mma: K2's two W2 products in bf16).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace nequip {

// Four 8 x 8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8 (16 bytes), and d[j] receives the values (row
// l / 4, columns 2 (l % 4) and 2 (l % 4) + 1) of matrix j, the lower column
// in the lower half.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&d)[4], const __nv_bfloat16* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(smem_addr(row)));
}

// The same, transposed: d[j] receives the values (row 2 (l % 4), column
// l / 4) and (row 2 (l % 4) + 1, column l / 4) of matrix j, the lower row in
// the lower half.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&d)[4], const __nv_bfloat16* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(smem_addr(row)));
}

// The transposed load of two matrices (lanes 0-15 give the addresses)
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&d)[2], const __nv_bfloat16* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(d[0]), "=r"(d[1])
               : "r"(smem_addr(row)));
}

// c[16 x 8] += a[16 x 16] b[16 x 8] on the tensor cores: bf16 operands,
// float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A row of w bf16 values in shared memory, padded by 16 bytes when its
// 16-byte count is even: the 8 rows of one ldmatrix phase, at an odd count
// of 16 bytes apart, start on 8 different bank groups
__host__ __device__ constexpr int padded_row(int w) { return (w / 8) % 2 ? w : w + 8; }

// Two float32 values as one bf16x2 register, each rounded to nearest (ties
// to even): x0 in the lower half, x1 in the upper
__device__ __forceinline__ uint32_t pack_bf16x2(float x0, float x1) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(x1), "f"(x0));
  return d;
}

// x0 and x1 as two bf16 terms, hi + lo: hi = bf16(x), lo = bf16(x - hi).
// x - hi is exact in float32, so |x - hi - lo| <= 2^-9 |x - hi| <= 2^-18 |x|
// (normal values): a product with a bf16 operand taken as hi b + lo b on the
// tensor cores keeps float32's products to ~2^-17.
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16x2(x0, x1);
  lo = pack_bf16x2(x0 - __uint_as_float(hi << 16), x1 - __uint_as_float(hi & 0xffff0000u));
}

}  // namespace nequip
