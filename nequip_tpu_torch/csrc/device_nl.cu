// device_nl: fixed-capacity periodic cell-list neighbour list on the card.
//
// Replaces the XLA function nequip_tpu/ops/device_nl.py:54,
// device_neighbor_list (no pl.pallas_call: the JAX package builds the list
// from argsort, searchsorted, gathers and lax.top_k inside jit), which the
// JAX MD driver runs at every skin rebuild with nl_backend="device".
// Semantics (nequip_tpu_torch/ops/device_nl.py keeps the plain twin):
// positions are wrapped into the cell, binned into a grid of >= 3 buckets a
// side, each bucket holds at most cell_cap atoms (the lowest indices), every
// atom scans the 27 neighbouring buckets with their image shifts, self-pairs
// are excluded in the zero image only, and at most k_max neighbours (the
// nearest) are kept an atom.  Overflow of a bucket, of k_max or of the
// output stream's capacity sets a flag, never clears it.
//
// Phases, all on the caller's stream:
//  (a) bin_kernel: wrap, wrapped positions, bucket of each atom, counts;
//      scan_kernel: bucket starts; place_kernel + sort_buckets: a counting
//      sort of atoms into buckets, each bucket then sorted by atom index, so
//      the table does not depend on the order of the atomics;
//  (b) search_kernel: one warp a destination atom walks the 27 x cell_cap
//      candidate slots 32 at a time, computes d^2 and writes its valid
//      neighbours in slot order (ballot + prefix count) into [N, k_max]
//      slots; an atom with more than k_max takes its k_max nearest by rank;
//  (c) scan_kernel over the per-atom counts, compact_kernel and pad_kernel:
//      the real edges into the first slots of the [E] stream in destination
//      order (kernel order of the fused convs), padding edges after them.
// The geometry (fractional coordinates, wrapped positions, image vectors,
// d^2) is written as single roundings (__dmul_rn/__dadd_rn, no contraction
// into FMAs), the same operations in the same order as the plain twin, so
// kernel and twin decide every cutoff test alike, in float64 or float32.
// Nothing depends on timing: the same positions give a bitwise-equal stream.
//
// What bounds it on an H100: memory, a few bytes an atom in and the edge
// stream out (~40 B an edge: int64 dst and src, three shifts, a mask byte);
// the distance tests are ~11 operations on 27 x cell_cap candidates an
// atom, ~2% of the card's float64 rate at the MD frame.  The simple design
// is latency-bound (single-block scans, one thread a bucket for the sort).
#include <cuda_runtime.h>
#include <stdint.h>

namespace nequip {
namespace nl {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

// out[k] = (v0 * m[0][k] + v1 * m[1][k]) + v2 * m[2][k], each step rounded
template <typename T>
__device__ __forceinline__ void vecmat(const T v[3], const T* __restrict__ m, T out[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = add(add(mul(v[0], m[k]), mul(v[1], m[3 + k])), mul(v[2], m[6 + k]));
}

template <typename T>
__global__ void bin_kernel(const T* __restrict__ pos, const T* __restrict__ cell, const T* __restrict__ inv, int n,
                           int d0, int d1, int d2, T* __restrict__ wpos, int* __restrict__ wrap,
                           int* __restrict__ cid, int* __restrict__ count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int dims[3] = {d0, d1, d2};
  T p[3] = {pos[3 * i], pos[3 * i + 1], pos[3 * i + 2]};
  T frac[3], fw[3], wp[3];
  int c3[3];
  vecmat(p, inv, frac);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T w = floor(frac[k]);
    wrap[3 * i + k] = static_cast<int>(w);
    fw[k] = sub(frac[k], w);
    int c = static_cast<int>(mul(fw[k], static_cast<T>(dims[k])));
    c3[k] = c < 0 ? 0 : (c > dims[k] - 1 ? dims[k] - 1 : c);
  }
  vecmat(fw, cell, wp);
#pragma unroll
  for (int k = 0; k < 3; ++k) wpos[3 * i + k] = wp[k];
  const int id = (c3[0] * d1 + c3[1]) * d2 + c3[2];
  cid[i] = id;
  atomicAdd(&count[id], 1);
}

// Exclusive scan of in[0, m) into out[0, m] (out[m] = total) by one block of
// 1024 threads, each over a contiguous chunk.  Sets *flag when an entry
// exceeds limit_each or the total exceeds limit_total (a limit < 0: none).
__global__ void scan_kernel(const int* __restrict__ in, int m, int* __restrict__ out, int limit_each,
                            int limit_total, int* __restrict__ flag) {
  __shared__ int part[1024];
  const int t = threadIdx.x;
  const int chunk = (m + blockDim.x - 1) / blockDim.x;
  const int lo = min(m, t * chunk), hi = min(m, lo + chunk);
  int sum = 0;
  bool over = false;
  for (int j = lo; j < hi; ++j) {
    sum += in[j];
    over |= limit_each >= 0 && in[j] > limit_each;
  }
  part[t] = sum;
  __syncthreads();
  for (int off = 1; off < blockDim.x; off <<= 1) {  // Hillis-Steele inclusive scan
    const int v = t >= off ? part[t - off] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  int run = part[t] - sum;
  for (int j = lo; j < hi; ++j) {
    out[j] = run;
    run += in[j];
  }
  if (t == blockDim.x - 1) {
    out[m] = part[t];
    over |= limit_total >= 0 && part[t] > limit_total;
  }
  if (over) *flag = 1;
}

__global__ void place_kernel(const int* __restrict__ cid, int n, const int* __restrict__ start,
                             int* __restrict__ cursor, int* __restrict__ sorted) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c = cid[i];
  sorted[start[c] + atomicAdd(&cursor[c], 1)] = i;
}

// each bucket's atoms by index: the table no longer depends on the atomics' order
__global__ void sort_buckets(const int* __restrict__ start, int n_cells, int* __restrict__ sorted) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_cells) return;
  const int lo = start[b], hi = start[b + 1];
  for (int j = lo + 1; j < hi; ++j) {
    const int v = sorted[j];
    int k = j - 1;
    while (k >= lo && sorted[k] > v) {
      sorted[k + 1] = sorted[k];
      --k;
    }
    sorted[k + 1] = v;
  }
}

template <typename T>
struct Search {
  const T* wpos;
  const int* wrap;
  const T* cell;
  const int* start;
  const int* sorted;
  int d0, d1, d2, cap;
  T r2;

  // candidate slot f = bucket * cap + r of destination i (bucket coordinates c3,
  // wrapped position wd): is it a valid neighbour, and its source, image, d^2
  __device__ bool candidate(int i, const int c3[3], const T wd[3], int f, int* src, int img[3], T* d2out) const {
    const int b = f / cap, r = f - b * cap;
    const int off[3] = {b / 9 - 1, (b / 3) % 3 - 1, b % 3 - 1};
    const int dims[3] = {d0, d1, d2};
    int w[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int nc = c3[k] + off[k];
      img[k] = nc < 0 ? -1 : (nc >= dims[k] ? 1 : 0);
      w[k] = nc - img[k] * dims[k];
    }
    const int nb = (w[0] * d1 + w[1]) * d2 + w[2];
    const int s = start[nb];
    const int m = min(start[nb + 1] - s, cap);
    if (r >= m) return false;
    const int j = sorted[s + r];
    if (j == i && img[0] == 0 && img[1] == 0 && img[2] == 0) return false;
    const T imgf[3] = {static_cast<T>(img[0]), static_cast<T>(img[1]), static_cast<T>(img[2])};
    T ic[3];
    vecmat(imgf, cell, ic);
    T dl[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) dl[k] = sub(add(wpos[3 * j + k], ic[k]), wd[k]);
    const T d2 = add(add(mul(dl[0], dl[0]), mul(dl[1], dl[1])), mul(dl[2], dl[2]));
    *src = j;
    *d2out = d2;
    return d2 <= r2;
  }
};

template <typename T>
__global__ void search_kernel(Search<T> s, const int* __restrict__ cid, int n, int k_max, int* __restrict__ nbr_src,
                              int* __restrict__ nbr_shift, int* __restrict__ cnt, int* __restrict__ overflow) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= n) return;  // warp-uniform
  const int c = cid[i];
  const int c3[3] = {c / (s.d1 * s.d2), (c / s.d2) % s.d1, c % s.d2};
  const T wd[3] = {s.wpos[3 * i], s.wpos[3 * i + 1], s.wpos[3 * i + 2]};
  const int wi[3] = {s.wrap[3 * i], s.wrap[3 * i + 1], s.wrap[3 * i + 2]};
  const int n_cand = 27 * s.cap;
  int* src_row = nbr_src + static_cast<int64_t>(i) * k_max;
  int* shift_row = nbr_shift + static_cast<int64_t>(i) * k_max * 3;
  const unsigned below = (1u << lane) - 1u;

  auto write = [&](int q, int j, const int img[3]) {
    src_row[q] = j;
#pragma unroll
    for (int k = 0; k < 3; ++k) shift_row[3 * q + k] = (wi[k] - s.wrap[3 * j + k]) + img[k];
  };

  int found = 0;  // valid candidates so far (warp-uniform)
  for (int f0 = 0; f0 < n_cand; f0 += 32) {
    const int f = f0 + lane;
    int j = 0, img[3] = {0, 0, 0};
    T d2 = T(0);
    const bool valid = f < n_cand && s.candidate(i, c3, wd, f, &j, img, &d2);
    const unsigned ballot = __ballot_sync(0xffffffffu, valid);
    const int q = found + __popc(ballot & below);
    if (valid && q < k_max) write(q, j, img);
    found += __popc(ballot);
  }
  if (found > k_max) {
    // more than k_max: keep the k_max nearest, ties to the lower slot, in slot order
    if (lane == 0) *overflow = 1;
    int kept = 0;
    for (int f0 = 0; f0 < n_cand; f0 += 32) {
      const int f = f0 + lane;
      int j = 0, img[3] = {0, 0, 0};
      T d2 = T(0);
      bool keep = f < n_cand && s.candidate(i, c3, wd, f, &j, img, &d2);
      if (keep) {
        int rank = 0;
        for (int g = 0; g < n_cand && rank < k_max; ++g) {
          int jg, ig[3];
          T dg;
          if (s.candidate(i, c3, wd, g, &jg, ig, &dg) && (dg < d2 || (dg == d2 && g < f))) ++rank;
        }
        keep = rank < k_max;
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, keep);
      if (keep) write(kept + __popc(ballot & below), j, img);
      kept += __popc(ballot);
    }
  }
  const int n_i = found < k_max ? found : k_max;
  const int zero[3] = {0, 0, 0};
  for (int q = n_i + lane; q < k_max; q += 32) write(q, i, zero);  // empty slots: src = dst, no shift
  if (lane == 0) cnt[i] = n_i;
}

template <typename T>
__global__ void compact_kernel(const int* __restrict__ nbr_src, const int* __restrict__ nbr_shift,
                               const int* __restrict__ cnt, const int* __restrict__ off, int n, int k_max, int e_cap,
                               int64_t* __restrict__ edge_index, T* __restrict__ shift, bool* __restrict__ mask) {
  const int64_t slot = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (slot >= static_cast<int64_t>(n) * k_max) return;
  const int i = static_cast<int>(slot / k_max), q = static_cast<int>(slot - static_cast<int64_t>(i) * k_max);
  if (q >= cnt[i]) return;
  const int e = off[i] + q;
  if (e >= e_cap) return;
  edge_index[e] = i;
  edge_index[e_cap + e] = nbr_src[slot];
#pragma unroll
  for (int k = 0; k < 3; ++k) shift[3 * e + k] = static_cast<T>(nbr_shift[3 * slot + k]);
  mask[e] = true;
}

template <typename T>
__global__ void pad_kernel(const int* __restrict__ total, int e_cap, int pad_index, int64_t* __restrict__ edge_index,
                           T* __restrict__ shift, bool* __restrict__ mask) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= e_cap || e < *total) return;
  edge_index[e] = pad_index;
  edge_index[e_cap + e] = pad_index;
#pragma unroll
  for (int k = 0; k < 3; ++k) shift[3 * e + k] = T(0);
  mask[e] = false;
}

inline int blocks(int64_t work, int threads) { return static_cast<int>((work + threads - 1) / threads); }

template <typename T>
int launch(const void* pos, const void* cell, const void* inv, int n, int d0, int d1, int d2, double r_max, int cap,
           int k_max, void* wpos, void* wrap, void* cid, void* count, void* start, void* cursor, void* sorted,
           void* nbr_src, void* nbr_shift, void* cnt, void* off, int e_cap, int pad_index, void* edge_index,
           void* shift, void* mask, void* overflow, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_cells = d0 * d1 * d2;
  int* flag = static_cast<int*>(overflow);
  if (n > 0) {
    bin_kernel<T><<<blocks(n, 256), 256, 0, stream>>>(
        static_cast<const T*>(pos), static_cast<const T*>(cell), static_cast<const T*>(inv), n, d0, d1, d2,
        static_cast<T*>(wpos), static_cast<int*>(wrap), static_cast<int*>(cid), static_cast<int*>(count));
  }
  scan_kernel<<<1, 1024, 0, stream>>>(static_cast<const int*>(count), n_cells, static_cast<int*>(start), cap, -1,
                                      flag);
  if (n > 0) {
    place_kernel<<<blocks(n, 256), 256, 0, stream>>>(static_cast<const int*>(cid), n, static_cast<const int*>(start),
                                                     static_cast<int*>(cursor), static_cast<int*>(sorted));
    sort_buckets<<<blocks(n_cells, 128), 128, 0, stream>>>(static_cast<const int*>(start), n_cells,
                                                          static_cast<int*>(sorted));
    T r = static_cast<T>(r_max);
    Search<T> s{static_cast<const T*>(wpos), static_cast<const int*>(wrap), static_cast<const T*>(cell),
                static_cast<const int*>(start), static_cast<const int*>(sorted), d0, d1, d2, cap, r * r};
    search_kernel<T><<<blocks(static_cast<int64_t>(n) * 32, 128), 128, 0, stream>>>(
        s, static_cast<const int*>(cid), n, k_max, static_cast<int*>(nbr_src), static_cast<int*>(nbr_shift),
        static_cast<int*>(cnt), flag);
  }
  if (e_cap > 0) {
    scan_kernel<<<1, 1024, 0, stream>>>(static_cast<const int*>(cnt), n, static_cast<int*>(off), -1, e_cap, flag);
    if (n > 0) {
      compact_kernel<T><<<blocks(static_cast<int64_t>(n) * k_max, 256), 256, 0, stream>>>(
          static_cast<const int*>(nbr_src), static_cast<const int*>(nbr_shift), static_cast<const int*>(cnt),
          static_cast<const int*>(off), n, k_max, e_cap, static_cast<int64_t*>(edge_index), static_cast<T*>(shift),
          static_cast<bool*>(mask));
    }
    pad_kernel<T><<<blocks(e_cap, 256), 256, 0, stream>>>(static_cast<const int*>(off) + n, e_cap, pad_index,
                                                          static_cast<int64_t*>(edge_index), static_cast<T*>(shift),
                                                          static_cast<bool*>(mask));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nl
}  // namespace nequip

#define NEQUIP_DEVICE_NL(SUFFIX, T)                                                                                 \
  extern "C" int nequip_device_nl_##SUFFIX(                                                                         \
      const void* pos, const void* cell, const void* inv, int n, int d0, int d1, int d2, double r_max, int cap,     \
      int k_max, void* wpos, void* wrap, void* cid, void* count, void* start, void* cursor, void* sorted,           \
      void* nbr_src, void* nbr_shift, void* cnt, void* off, int e_cap, int pad_index, void* edge_index,             \
      void* shift, void* mask, void* overflow, void* stream) {                                                      \
    return nequip::nl::launch<T>(pos, cell, inv, n, d0, d1, d2, r_max, cap, k_max, wpos, wrap, cid, count, start,   \
                                 cursor, sorted, nbr_src, nbr_shift, cnt, off, e_cap, pad_index, edge_index, shift, \
                                 mask, overflow, stream);                                                           \
  }

NEQUIP_DEVICE_NL(f32, float)
NEQUIP_DEVICE_NL(f64, double)
