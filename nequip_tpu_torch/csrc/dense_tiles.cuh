// Dense edge tiles of the dst-sorted stream on a persistent grid, shared by
// the kernels that take TILE consecutive real slots across node boundaries
// (K1, conv_fwd.cu; K2, conv_bwd.cu; K5, tri_bwd.cu; K7, jvp_bwd.cu): each
// edge's destination, the cp.async staging of a tile's rows and the stores
// of its per-edge outputs, and the launch geometry of a grid of every block
// that fits on the card at once.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "cp_async.cuh"
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

// The 16-byte phase of p in elements: p - phase16(p) is 16-byte aligned.
template <typename T>
__device__ __forceinline__ int phase16(const T* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(T));
}

// Starts the copy of the n contiguous elements src[0, n) to dst[ph + k]
// (ph = phase16(src); dst 16-byte aligned with room for n_fill + 16 /
// sizeof(T) - 1 elements), so both sides of each 16-byte copy are aligned
// whatever src's alignment (an operand that is a row slice of a larger
// tensor): element copies for the head and tail, 16-byte copies between.
// dst[ph + k] for k in [n, n_fill) is set to zero.  The readers find the
// rows at dst + phase16(src).
template <typename T, int NT>
__device__ __forceinline__ void stage_flat(T* dst, const T* __restrict__ src, int n, int n_fill, int tid) {
  constexpr int V = 16 / sizeof(T);
  const int ph = phase16(src);
  T* d = dst + ph;
  const int head = min(n, (V - ph) % V), n_vec = (n - head) / V, tail = head + n_vec * V;
  for (int k = tid; k < head; k += NT) cp_async_elem<sizeof(T)>(d + k, src + k, true);
  for (int j = tid; j < n_vec; j += NT) cp_async_16(d + head + j * V, src + head + j * V, true);
  for (int k = tail + tid; k < n; k += NT) cp_async_elem<sizeof(T)>(d + k, src + k, true);
  for (int k = n + tid; k < n_fill; k += NT) d[k] = T(0);
}

// Starts the gather of TILE rows of n elements, dst[e * n + c] = src[idx[e]
// * n + c] for the edges e < cnt and zero for the others: 16-byte copies
// where every row is 16-byte aligned, element copies otherwise.
template <typename T, int TILE, int NT>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src, const int32_t* __restrict__ idx,
                                           int cnt, int n, int tid) {
  constexpr int V = 16 / sizeof(T);
  if ((n % V) == 0 && phase16(src) == 0) {
    const int per_row = n / V;
    for (int i = tid; i < TILE * per_row; i += NT) {
      const int e = i / per_row, c = (i - e * per_row) * V;
      const bool ok = e < cnt;
      cp_async_16(dst + e * n + c, ok ? src + static_cast<int64_t>(__ldg(idx + e)) * n + c : src, ok);
    }
  } else {
    for (int i = tid; i < TILE * n; i += NT) {
      const int e = i / n, c = i - e * n;
      const bool ok = e < cnt;
      cp_async_elem<sizeof(T)>(dst + i, ok ? src + static_cast<int64_t>(__ldg(idx + e)) * n + c : src, ok);
    }
  }
}

// dst[0, n) = src[0, n) from shared to global memory: 16-byte stores for
// the 16-byte aligned body of dst, element stores for its head and tail.
template <typename T, int NT>
__device__ __forceinline__ void store_flat(T* __restrict__ dst, const T* src, int n, int tid) {
  constexpr int V = 16 / sizeof(T);
  const int head = min(n, (V - phase16(dst)) % V), n_vec = (n - head) / V, tail = head + n_vec * V;
  for (int k = tid; k < head; k += NT) dst[k] = src[k];
  for (int j = tid; j < n_vec; j += NT) {
    T v[V];
#pragma unroll
    for (int q = 0; q < V; ++q) v[q] = src[head + j * V + q];
    store16(dst + head + j * V, v);
  }
  for (int k = tail + tid; k < n; k += NT) dst[k] = src[k];
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
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused size must not resurface as the next launch's error
    return err;
  }
  Entry& g = cache[next];
  next = (next + 1) % kEntries;
  g.fn = fn, g.dev = dev, g.smem = smem, g.grid = sms * (per_sm > 0 ? per_sm : 1);
  grid = g.grid;
  return cudaSuccess;
}

}  // namespace nequip
