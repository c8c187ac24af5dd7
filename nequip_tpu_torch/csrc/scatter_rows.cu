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
// bf16 (the fast mode's forces): a kernel of its own, scatter_rows_bf16_kernel.
// Each element is widened on its read, summed in a float32 register in edge
// order j0 -> j1 starting from +0, and rounded to bf16 once on its store: the
// same additions in the same order as the float design above makes, so its
// outputs are bitwise those of that design instantiated for bf16
// (tp_scatter.scatter_rows_edge_order is the reference).  What bounds it: bytes, 2 a value (0.164 ms over the
// flagship's three layers at 23k atoms, 3.35 TB/s).  The float design at 2
// bytes a thread was held back by instructions and latency instead (0.553
// ms, 30% of the bound): a warp pulled 64 B a load, a row of 288 took a
// second pass in which one warp of eight worked, D = 32 ran blocks of one
// warp (half the SM's warps resident), every thread reloaded perm[j] for each
// of its columns, and few gathered rows were in flight.  The design:
// - 16 bytes a lane: a row is D / V vectors of V = 8 bf16 when v's base is
//   16-byte aligned and D % 8 == 0 (every shape of the flagship and preset M),
//   loaded through the read-only path without allocating in L1 (each row of v
//   is read once a call; 7% faster than without the hint at D = 288); else
//   (a view that starts off 16-byte alignment, odd D) V = 1, the same kernel
//   on 2-byte loads.
// - rows packed into warps: a row takes `lanes` lanes of a warp, each holding
//   K <= 4 of its vectors (lane `sub` vectors sub, sub + lanes, ...; more
//   passes only for rows wider than 32 K vectors), and a warp 32 / lanes rows,
//   chosen on the host from D and the alignment alone
//   (tp_scatter.scatter_rows_geometry: D = 32 is 8 rows of 4 lanes, D = 288 is
//   3 rows of 9 lanes x 4 vectors, D = 480 one row of 30 lanes x 2).  Blocks
//   are four warps, so residency is capped by registers (at most 64), not by
//   blocks.
// - indices read once: a row's lanes load its perm segment together, U
//   consecutive entries a lane, and hand them round with __shfl_sync; the
//   warp walks its longest segment (a warp-uniform loop, shorter segments
//   masked), U edges a step (8 for K = 1, else 4), issuing all U x K loads of a
//   step before their adds.
// Measured (H100 80GB HBM3, 700 W; chip_k3_profile.py, calls back to back):
// 0.016-0.021 ms at D = 32, 0.109-0.111 ms at D = 288 (2.35 TB/s, 70% of the
// bound; the float design 0.198 ms) and 0.166 ms at D = 480 (77%).  Other
// geometries and L2 prefetch-size hints came within 3% of it at D = 288 and
// 480, loads without the L1 hint 7% and 256-thread blocks 23% slower at
// D = 288; so what is left there is the DRAM's efficiency on 576-byte rows
// gathered at random.  At D = 32, whose values stay in L2 between calls, 16
// edges a step ran level in one run and up to 43% faster in two.  The launch
// reads nothing on the host but D and the values' alignment, so it runs
// inside captured CUDA graphs and exported programs.
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

// --- bf16 ---------------------------------------------------------------------------------

constexpr int kScatterThreads = 128;  // threads of a bf16 block (tp_scatter.SCATTER_THREADS)
constexpr int kScatterMaxK = 4;       // vectors a lane holds (tp_scatter.SCATTER_MAX_PER_LANE)

// V = 8 or 1 consecutive bf16 values as 32-bit words, value 2w in the low half of word w
template <int V>
struct Bf16Vec {
  static constexpr int kWords = V == 8 ? 4 : 1;
  uint32_t w[kWords];
};

// one load of V values at p (aligned to 2 V bytes); 16 bytes go through the
// read-only path without allocating in L1
template <int V>
__device__ __forceinline__ Bf16Vec<V> load_bf16(const __nv_bfloat16* p) {
  Bf16Vec<V> r;
  if constexpr (V == 8) {
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(r.w[0]), "=r"(r.w[1]), "=r"(r.w[2]), "=r"(r.w[3])
        : "l"(p));
  } else {
    r.w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  return r;
}

// value i of a vector, widened exactly (the value of __bfloat162float)
template <int V>
__device__ __forceinline__ float bf16_at(const Bf16Vec<V>& x, int i) {
  const uint32_t w = x.w[i / 2];
  return __uint_as_float(i % 2 ? w & 0xffff0000u : w << 16);
}

// the V sums rounded to bf16 once each, stored with one write
template <int V>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* p, const float* acc) {
  Bf16Vec<V> r;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const uint32_t b = __bfloat16_as_ushort(__float2bfloat16(acc[i]));
    r.w[i / 2] = i % 2 ? r.w[i / 2] | (b << 16) : b;
  }
  if constexpr (V == 8) {
    *reinterpret_cast<uint4*>(p) = make_uint4(r.w[0], r.w[1], r.w[2], r.w[3]);
  } else {
    *reinterpret_cast<unsigned short*>(p) = static_cast<unsigned short>(r.w[0]);
  }
}

// V values a load, K vectors a lane a pass, `lanes` lanes a row, 32 / lanes rows a warp
template <int V, int K>
__global__ void __launch_bounds__(kScatterThreads)
    scatter_rows_bf16_kernel(const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ perm,
                             const int32_t* __restrict__ ptr, __nv_bfloat16* __restrict__ out, int n_rows,
                             int d, int lanes) {
  constexpr int U = K == 1 ? 8 : 4;  // edges a step
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int rows_per_warp = 32 / lanes;
  const int group = lane / lanes;
  const int sub = lane - group * lanes;
  const int lane0 = group * lanes;
  const int n = (blockIdx.x * (kScatterThreads / 32) + static_cast<int>(threadIdx.x >> 5)) * rows_per_warp + group;
  const bool live = group < rows_per_warp && n < n_rows;
  const int j0 = live ? ptr[n] : 0;
  const int m = live ? ptr[n + 1] - j0 : 0;
  const int m_max = __reduce_max_sync(kAll, m);  // the warp walks its longest segment
  const int nv = d / V;
  for (int c0 = 0; c0 < nv; c0 += lanes * K) {
    float acc[K][V];
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int i = 0; i < V; ++i) acc[k][i] = 0.f;
    for (int e0 = 0; e0 < m_max; e0 += lanes * U) {
      // lane sub of the row holds its edges e0 + sub U + u
      int idx[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + sub * U + u;
        idx[u] = e < m ? perm[j0 + e] : -1;
      }
      const int steps = min(lanes, (m_max - e0 + U - 1) / U);
      for (int s = 0; s < steps; ++s) {
        Bf16Vec<V> x[U][K];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int src = __shfl_sync(kAll, idx[u], lane0 + s);  // edge e0 + s U + u
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int c = c0 + k * lanes + sub;
            if (live && src >= 0 && c < nv) {
              x[u][k] = load_bf16<V>(v + static_cast<int64_t>(src) * d + c * V);
            } else {
#pragma unroll
              for (int w = 0; w < Bf16Vec<V>::kWords; ++w) x[u][k].w[w] = 0u;  // adds +0: the sum is unchanged
            }
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int k = 0; k < K; ++k)
#pragma unroll
            for (int i = 0; i < V; ++i) acc[k][i] += bf16_at<V>(x[u][k], i);
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = c0 + k * lanes + sub;
      if (live && c < nv) store_bf16<V>(out + static_cast<int64_t>(n) * d + c * V, acc[k]);
    }
  }
}

template <int V>
void launch_scatter_rows_bf16_vec(const __nv_bfloat16* v, const int32_t* perm, const int32_t* ptr,
                                  __nv_bfloat16* out, int n_rows, int d, int lanes, int per_lane,
                                  cudaStream_t stream) {
  const int rows_per_block = kScatterThreads / 32 * (32 / lanes);
  const int blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  switch (per_lane) {
    case 1:
      scatter_rows_bf16_kernel<V, 1><<<blocks, kScatterThreads, 0, stream>>>(v, perm, ptr, out, n_rows, d, lanes);
      break;
    case 2:
      scatter_rows_bf16_kernel<V, 2><<<blocks, kScatterThreads, 0, stream>>>(v, perm, ptr, out, n_rows, d, lanes);
      break;
    case 3:
      scatter_rows_bf16_kernel<V, 3><<<blocks, kScatterThreads, 0, stream>>>(v, perm, ptr, out, n_rows, d, lanes);
      break;
    default:
      scatter_rows_bf16_kernel<V, 4><<<blocks, kScatterThreads, 0, stream>>>(v, perm, ptr, out, n_rows, d, lanes);
  }
}

// the launch at the host's geometry (vec, lanes, per_lane: tp_scatter.scatter_rows_geometry);
// cudaErrorInvalidValue for a geometry the kernel does not take, cudaErrorMisalignedAddress
// for pointers not aligned to a vector
int launch_scatter_rows_bf16(const void* v, const void* perm, const void* ptr, void* out, int n_rows, int d,
                             int vec, int lanes, int per_lane, void* stream) {
  if (n_rows <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  if ((vec != 8 && vec != 1) || d % vec != 0 || lanes < 1 || lanes > 32 || per_lane < 1 ||
      per_lane > kScatterMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) % (2 * vec) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const auto* vv = static_cast<const __nv_bfloat16*>(v);
  const auto* pp = static_cast<const int32_t*>(perm);
  const auto* qq = static_cast<const int32_t*>(ptr);
  auto* oo = static_cast<__nv_bfloat16*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec == 8)
    launch_scatter_rows_bf16_vec<8>(vv, pp, qq, oo, n_rows, d, lanes, per_lane, s);
  else
    launch_scatter_rows_bf16_vec<1>(vv, pp, qq, oo, n_rows, d, lanes, per_lane, s);
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

extern "C" int nequip_scatter_rows_bf16(const void* v, const void* perm, const void* ptr, void* out,
                                        int n_rows, int d, int vec, int lanes, int per_lane, void* stream) {
  return nequip::launch_scatter_rows_bf16(v, perm, ptr, out, n_rows, d, vec, lanes, per_lane, stream);
}
