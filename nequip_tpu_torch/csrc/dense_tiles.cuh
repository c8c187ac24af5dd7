// Dense edge tiles of the dst-sorted stream on a persistent grid, shared by
// the kernels that take TILE consecutive real slots across node boundaries
// (K1, conv_fwd.cu; K2, conv_bwd.cu): each edge's destination, and the
// launch geometry of a grid of every block that fits on the card at once.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "tp_common.cuh"

namespace nequip {

// the destination of real slot e: dst_ptr[n] <= e < dst_ptr[n + 1]
__device__ __forceinline__ int find_dst(const int32_t* __restrict__ dst_ptr, int n_nodes, int e) {
  int lo = 0, hi = n_nodes;  // dst_ptr[lo] <= e < dst_ptr[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(dst_ptr + mid) <= e)
      lo = mid;
    else
      hi = mid;
  }
  return lo;
}

// The destination of real slot base + lane for the lanes < cnt of a warp
// (cnt <= 32; -1 for the other lanes), as find_dst gives it, with ~4
// dependent loads instead of ~log2(n_nodes): a 32-ary search for base's
// destination lo, then each lane's rank among the next 32 row pointers
// dst_ptr[lo + 1 ..] (a binary search over the warp's registers).  A lane
// whose slot lies past that window (more than 31 nodes begin inside the
// tile: empty nodes) falls back to find_dst.  Every lane of the warp calls it.
__device__ __forceinline__ int tile_dst(const int32_t* __restrict__ dst_ptr, int n_nodes, int base, int cnt) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n_nodes;  // dst_ptr[lo] <= base < dst_ptr[hi]
  while (hi - lo > 1) {
    const int stride = (hi - lo + 31) / 32;
    const int c = lo + lane * stride;
    const bool le = c < hi && __ldg(dst_ptr + c) <= base;  // true on lane 0, monotone in the lane
    lo += (31 - __clz(__ballot_sync(kAll, le))) * stride;
    hi = min(lo + stride, hi);
  }
  const int w = lo + 1 + lane;
  const int p = w <= n_nodes ? __ldg(dst_ptr + w) : INT_MAX;
  const int e = base + lane;
  int rank = 0;  // window entries <= e, if fewer than 32
#pragma unroll
  for (int step = 16; step >= 1; step >>= 1)
    if (__shfl_sync(kAll, p, rank + step - 1) <= e) rank += step;
  const bool past = __shfl_sync(kAll, p, 31) <= e;
  if (lane >= cnt) return -1;
  return past ? find_dst(dst_ptr, n_nodes, e) : lo + rank;
}

// Shared memory of one device: what a block may opt in to, and what an SM
// holds for resident blocks (each also reserves `reserved` bytes).
struct SmemLimits {
  int dev = -1, optin = 0, per_sm = 0, reserved = 0;

  // true when `blocks` blocks of `bytes` each fit on one SM
  bool fit(size_t bytes, int blocks) const {
    return bytes <= static_cast<size_t>(optin) &&
           blocks * (bytes + static_cast<size_t>(reserved)) <= static_cast<size_t>(per_sm);
  }
};

// The limits of the current device, read once per thread and device.
inline cudaError_t smem_limits(SmemLimits& out) {
  static thread_local SmemLimits cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (cache.dev != dev) {
    SmemLimits l;
    l.dev = dev;
    if ((err = cudaDeviceGetAttribute(&l.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&l.per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&l.reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev)) != cudaSuccess)
      return err;
    cache = l;
  }
  out = cache;
  return cudaSuccess;
}

// The persistent grid of `kernel` at `threads` threads and `smem` bytes of
// dynamic shared memory: SMs x resident blocks.  Set up once per thread,
// kernel, device and size (a model has a few layer shapes), so a repeat
// launch makes no other CUDA call.  The kernel's shared-memory opt-in is
// the largest size asked of it so far, so no size set later can refuse a
// size cached before.
template <typename Kernel>
inline cudaError_t persistent_grid(Kernel kernel, int threads, int dev, size_t smem, int& grid) {
  struct Entry {
    const void* fn = nullptr;
    int dev = -1, grid = 0;
    size_t smem = 0;
  };
  constexpr int kEntries = 16;
  static thread_local Entry cache[kEntries];
  static thread_local int next = 0;
  const void* fn = reinterpret_cast<const void*>(kernel);
  size_t opted = 0;  // the opt-in set for this kernel and device, as far as the cache knows
  for (const Entry& g : cache) {
    if (g.fn != fn || g.dev != dev) continue;
    if (g.smem == smem) {
      grid = g.grid;
      return cudaSuccess;
    }
    opted = g.smem > opted ? g.smem : opted;
  }
  cudaError_t err = cudaSuccess;
  if (smem > opted) err = allow_dynamic_smem(kernel, smem);
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  Entry& g = cache[next];
  next = (next + 1) % kEntries;
  g.fn = fn, g.dev = dev, g.smem = smem, g.grid = sms * (per_sm > 0 ? per_sm : 1);
  grid = g.grid;
  return cudaSuccess;
}

}  // namespace nequip
