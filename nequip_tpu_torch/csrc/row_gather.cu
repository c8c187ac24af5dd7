// T5: row gather, out[i, :] = src[idx[i], :], written once on row bytes.
//
// Replaces the TPU kernel tools/gather_microbench.py, pallas_row_gather
// (pallas_call at :86), which keeps n_buf per-row DMAs in flight over blocks
// of block_e rows and pads rows to 1024 floats for Mosaic's tiling; the
// function has no padding, and here the result is [E, D] as it is.
//
// What bounds it on an H100: bytes, each output row read once from src and
// written once, plus the indices (430,080 x 288 x 4 B x 2 + 1.7 MB ~ 0.99 GB
// at the 23k-atom edge stream, f32), 0.30 ms at 3.35 TB/s.  Measured, 0.40 ms
// for random rows in f32, where torch.index_select takes 0.38 ms, and 0.28
// against 0.30 ms in bf16 (H100 80GB HBM3, 700 W).
// Design: a copy is dtype-free, so the kernel moves units of 16 bytes when
// the row bytes and both pointers allow it (D = 288 in f32 or bf16), else 8,
// 4, 2 or 1.  One warp copies one row with its lanes on consecutive units;
// a block of n_buf warps (n_buf rows in flight) walks block_e rows.  The
// indices must lie in [0, src_rows): the kernel does not check them.
// TMA 1-D bulk copies (cp.async.bulk) are the natural later redesign.
#include <cuda_runtime.h>
#include <stdint.h>

namespace nequip {

template <typename U>
__global__ void row_gather_kernel(const U* __restrict__ src, const int32_t* __restrict__ idx,
                                  U* __restrict__ out, int n_rows, int units, int block_e) {
  const int lane = threadIdx.x & 31;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * block_e;
  const int64_t r_end = r0 + block_e < n_rows ? r0 + block_e : static_cast<int64_t>(n_rows);
  for (int64_t r = r0 + (threadIdx.x >> 5); r < r_end; r += blockDim.x >> 5) {
    const U* s = src + static_cast<int64_t>(idx[r]) * units;
    U* d = out + r * units;
    for (int c = lane; c < units; c += 32) d[c] = s[c];
  }
}

template <typename U>
int launch_row_gather(const void* src, const void* idx, void* out, int n_rows, int row_bytes,
                      int block_e, int n_buf, cudaStream_t stream) {
  const int blocks = static_cast<int>((static_cast<int64_t>(n_rows) + block_e - 1) / block_e);
  row_gather_kernel<U><<<blocks, 32 * n_buf, 0, stream>>>(
      static_cast<const U*>(src), static_cast<const int32_t*>(idx), static_cast<U*>(out), n_rows,
      row_bytes / static_cast<int>(sizeof(U)), block_e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nequip

extern "C" int nequip_row_gather_bytes(const void* src, const void* idx, void* out, int n_rows,
                                       int row_bytes, int block_e, int n_buf, void* stream) {
  if (n_buf < 1 || n_buf > 32 || block_e < 1 || row_bytes < 0) return cudaErrorInvalidValue;
  if (n_rows == 0 || row_bytes == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(row_bytes);
  if (align % 16 == 0) return nequip::launch_row_gather<uint4>(src, idx, out, n_rows, row_bytes, block_e, n_buf, s);
  if (align % 8 == 0) return nequip::launch_row_gather<uint2>(src, idx, out, n_rows, row_bytes, block_e, n_buf, s);
  if (align % 4 == 0) return nequip::launch_row_gather<uint32_t>(src, idx, out, n_rows, row_bytes, block_e, n_buf, s);
  if (align % 2 == 0) return nequip::launch_row_gather<uint16_t>(src, idx, out, n_rows, row_bytes, block_e, n_buf, s);
  return nequip::launch_row_gather<uint8_t>(src, idx, out, n_rows, row_bytes, block_e, n_buf, s);
}
