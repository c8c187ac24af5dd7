// T5: row gather, out[i, :] = src[idx[i], :], written once on row bytes.
//
// Replaces the TPU kernel tools/gather_microbench.py, pallas_row_gather
// (pallas_call at :86), which keeps n_buf per-row DMAs in flight over blocks
// of block_e rows and pads rows to 1024 floats for Mosaic's tiling; the
// function has no padding, and here the result is [E, D] as it is.
//
// What bounds it on an H100: bytes, each output row read once from src and
// written once, plus the indices (430,080 x 288 x 4 B x 2 + 1.7 MB ~ 0.99 GB
// at the 23k-atom edge stream, f32), 0.30 ms at 3.35 TB/s.  To come near it
// the card needs ~2 MB of loads in flight (3.35 TB/s x ~600 ns): ~16 KB per
// SM.  The first design (one warp per row, a block of n_buf warps) kept too few
// bytes in flight: each lane's load waited on its row's index, and a
// 1152-byte f32 row of 72 16-byte units took three passes of 32 lanes with 8
// busy in the third (0.404 ms against torch.index_select's 0.379).
// Design: a copy is dtype-free, so the kernel moves units of 16 bytes when
// the row bytes and both pointers allow it (D = 288 in f32 or bf16), else 8,
// 4, 2 or 1.  A block of 32 n_buf threads copies block_e rows as one flat
// range of (row, unit) pairs, the threads on consecutive units (so a warp
// reads 512 contiguous bytes of a row and writes 512 of the output, and no
// lane idles at a row's end); each thread first loads the indices of its
// kUnroll units, then issues all kUnroll loads, then all stores, so a block
// of 8 warps keeps 8 x 32 x 8 x 16 B = 32 KB in flight.  The source is read
// through the read-only path and the output written with a streaming hint.
// The indices must lie in [0, src_rows): the kernel does not check them.
// Measured (H100 80GB HBM3, 700 W; PERF.md, T5 findings, with the times):
// - f32 random rows: at index_select's time within run-to-run noise, both at
//   ~2.6 TB/s of the 3.35 peak.  At small blocks (32 rows, 8 warps: the
//   wrapper's defaults) the warp-per-row design was as fast; the flat copy
//   gains at the tool's larger blocks (512 rows, 16 warps), where
//   warp-per-row kept one row a warp in flight.
// - bf16 (576-byte rows): faster than index_select and than warp-per-row at
//   every block shape, where a row filled only 36 of a warp's lanes.
// - 4 units in flight per thread measured the same as 8, 16 slower.
// - TMA 1-D bulk copies (cp.async.bulk of each row into a ring of batches in
//   shared memory completing on mbarriers, one bulk store per batch of
//   contiguous output rows) were tried at 2, 4 and 8 stages and 8-32 rows a
//   batch: no faster than this design at its best block shapes in f32 or
//   bf16, so the simpler copy stays.  What is left in f32 is the DRAM's
//   efficiency on 1152-byte random rows, which neither design changes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace nequip {

constexpr int kUnroll = 8;  // units in flight per thread

// __launch_bounds__(1024): n_buf = 32 takes 1024 threads, so at most 64 registers
template <typename U>
__global__ void __launch_bounds__(1024) row_gather_kernel(const U* __restrict__ src, const int32_t* __restrict__ idx,
                                                          U* __restrict__ out, int n_rows, int units, int block_e) {
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * block_e;
  const int rows = static_cast<int>(min(static_cast<int64_t>(block_e), n_rows - r0));
  const int n = rows * units;  // units of this block (the launcher keeps block_e * units < 2^31)
  const int step = blockDim.x;
  const int32_t* ib = idx + r0;
  U* ob = out + r0 * units;
  for (int i0 = threadIdx.x; i0 < n; i0 += kUnroll * step) {
    // (row, column) of unit i0, then of i0 + j * step by increments
    int r = i0 / units, c = i0 - r * units;
    const int dr = step / units, dc = step - dr * units;
    int64_t off[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      off[j] = i0 + j * step < n ? static_cast<int64_t>(__ldg(ib + r)) * units + c : 0;
      r += dr;
      c += dc;
      if (c >= units) c -= units, ++r;
    }
    U v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      if (i0 + j * step < n) v[j] = __ldg(src + off[j]);
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      if (i0 + j * step < n) __stcs(ob + i0 + j * step, v[j]);
  }
}

template <typename U>
int launch_row_gather(const void* src, const void* idx, void* out, int n_rows, int row_bytes, int block_e,
                      int n_buf, cudaStream_t stream) {
  const int units = row_bytes / static_cast<int>(sizeof(U));
  if (static_cast<int64_t>(block_e) * units >= (int64_t{1} << 31) - int64_t{kUnroll} * 32 * n_buf)
    return cudaErrorInvalidValue;
  const int blocks = static_cast<int>((static_cast<int64_t>(n_rows) + block_e - 1) / block_e);
  row_gather_kernel<U><<<blocks, 32 * n_buf, 0, stream>>>(
      static_cast<const U*>(src), static_cast<const int32_t*>(idx), static_cast<U*>(out), n_rows, units, block_e);
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
