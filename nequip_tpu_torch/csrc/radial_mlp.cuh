// Block-GEMM routines of the radial MLP on a dense tile of edges, shared by
// the convolution kernels that compute the MLP in-kernel (K1, conv_fwd.cu;
// K2, conv_bwd.cu).
//
// The MLP is W = alpha1 * silu(alpha0 * emb . W1) . W2 with W1 [n_emb, H]
// and W2 [H, WN].  On a tile of TILE edges the two products with H and WN
// inside are block GEMMs: A [TILE, K] lives in shared memory, B [K, N] is a
// weight matrix in global memory (L2-resident: at most a few hundred KB)
// that streams through a small cp.async ring in k-slabs and is reused by
// every edge of the tile.  The products run on f32 (or f64) FFMA: no
// tensor-core form is f32-exact, and the kernels are held to plain f32 at
// 1e-4 of max|ref|.
//
// Thread layout of tile_gemm (8 warps): warp w owns the TE = TILE / 8 rows
// [w * TE, w * TE + TE) of A and C; B is cut into column chunks of CW = 32 V
// columns (V = 16 / sizeof(T)), and lane l owns the V columns l * V + [0, V)
// of each chunk.  Per V values of k a thread reads its TE rows of A as TE
// 16-byte loads (every lane of a warp the same address: a broadcast) and B
// as V 16-byte loads (a warp reads 512 contiguous bytes: no bank conflicts),
// then does TE * V * V FMAs.  Every output is summed over k in increasing
// order, so results are bitwise repeatable.  (Measured on an H100: a
// layout with warps over columns and lanes over 8 rows x 4 column groups,
// which reads B with 2.5 times fewer shared-memory wavefronts, was no faster.)
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cp_async.cuh"
#include "tp_common.cuh"

namespace nequip {
namespace mlp {

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int V = 4;
};
template <>
struct Vec<double> {
  static constexpr int V = 2;
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int round_up(int a, int b) { return cdiv(a, b) * b; }

// True when B [*, n] (row-major) can be staged by 16-byte copies.
template <typename T>
__device__ __forceinline__ bool vec_ok(const T* b, int n) {
  return (n * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

// Starts the copy of rows [k0, k0 + BK) x columns [c0, c0 + CW) of the
// row-major b [k, n] into dst [BK][CW]; rows >= k and columns >= n read as
// zero.  A b of another type S than T (bf16 weights into a float ring) is
// widened by plain loads and stores, in place when the call returns.
template <typename T, int BK, int CW, int NT, typename S>
__device__ __forceinline__ void stage_slab(T* dst, const S* __restrict__ b, int k0, int k, int c0, int n, bool vec,
                                           int tid) {
  constexpr int V = Vec<T>::V;
  if constexpr (!std::is_same<S, T>::value) {
    for (int i = tid; i < BK * CW; i += NT) {
      const int r = i / CW, c = i % CW;
      dst[i] = k0 + r < k && c0 + c < n ? widen(b[static_cast<int64_t>(k0 + r) * n + c0 + c]) : T(0);
    }
  } else if (vec) {
    constexpr int kCopies = BK * CW / V;
#pragma unroll
    for (int j = 0; j < (kCopies + NT - 1) / NT; ++j) {
      const int i = tid + j * NT;
      if (kCopies % NT == 0 || i < kCopies) {
        const int r = i / (CW / V), c = (i % (CW / V)) * V;
        const bool ok = k0 + r < k && c0 + c < n;
        cp_async_16(dst + r * CW + c, ok ? b + static_cast<int64_t>(k0 + r) * n + c0 + c : b, ok);
      }
    }
  } else {
    for (int i = tid; i < BK * CW; i += NT) {
      const int r = i / CW, c = i % CW;
      const bool ok = k0 + r < k && c0 + c < n;
      cp_async_elem<sizeof(T)>(dst + i, ok ? b + static_cast<int64_t>(k0 + r) * n + c0 + c : b, ok);
    }
  }
}

// Shared-memory elements of tile_gemm's ring.
template <typename T, int BK, int STAGES>
__host__ __device__ constexpr int ring_elems() {
  return STAGES * BK * 32 * Vec<T>::V;
}

// C [TILE, round_up(n, CW)] = A [TILE, k] . B [k, n], chunk by chunk of CW
// columns.  A: shared memory, row stride lda (a multiple of V), with zeros
// in its columns [k, round_up(k, BK)).  B: global, row-major [k, n],
// streamed through ring (ring_elems<T, BK, STAGES>() elements of shared
// memory) and read as zero past row k and column n.  For each chunk every
// thread calls epi(row0, col0, acc) with acc[i][j] the value of row row0 + i
// and column col0 + j.  Starts with a barrier (the caller's writes of A,
// and its reads of whatever shared the ring's memory, are done) and ends at
// one with no copy in flight, so the caller may reuse the ring at once.  B
// may be stored as bf16 (S = __nv_bfloat16, T = float): its slabs are
// widened into the float ring by plain loads and stores, which the ring's
// barriers order as they order the copies.  Where B's rows are 16-byte
// aligned, slab q + STAGES - 1 is loaded into registers (16-byte words of
// 8 values) before slab q's products and stored after them, into the slot
// every thread finished reading before this iteration's barrier, so the
// loads' latency hides behind the products; otherwise stage_slab loads
// element by element where the copy would be issued.
template <typename T, int TILE, int BK, int STAGES, typename S, typename Epi>
__device__ __forceinline__ void tile_gemm(const T* a, int lda, const S* __restrict__ b, int k, int n, T* ring,
                                          Epi&& epi) {
  constexpr int V = Vec<T>::V, CW = 32 * V, NT = 256, TE = TILE / 8;
  static_assert(TILE % 8 == 0 && BK % V == 0 && STAGES >= 2, "tile_gemm shape");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nk = cdiv(k, BK), nq = nk * cdiv(n, CW);
  const bool vec = vec_ok(b, n);
  __syncthreads();  // A is complete, and every reader of what the ring's memory held before is done
  auto load = [&](int q) {
    const int c = q / nk, s = q - c * nk;
    stage_slab<T, BK, CW, NT>(ring + (q % STAGES) * BK * CW, b, s * BK, k, c * CW, n, vec, tid);
  };
  constexpr bool kWiden = !std::is_same<S, T>::value;
  constexpr int kWords = BK * CW / 8, kWordsPerThread = (kWords + NT - 1) / NT;  // 16-byte words of 8 bf16 a slab
  const bool prefetch = kWiden && n % 8 == 0 && (reinterpret_cast<uintptr_t>(b) & 15) == 0;
  uint4 pre[kWordsPerThread];  // prefetch: the next slab's words
  auto fetch = [&](int q) {
    const int c = q / nk, s = q - c * nk;
#pragma unroll
    for (int j = 0; j < kWordsPerThread; ++j) {
      const int i = tid + j * NT, r = i / (CW / 8), cc = (i % (CW / 8)) * 8;
      pre[j] = make_uint4(0u, 0u, 0u, 0u);
      if ((kWords % NT == 0 || i < kWords) && s * BK + r < k && c * CW + cc < n)
        pre[j] = __ldg(reinterpret_cast<const uint4*>(b + static_cast<int64_t>(s * BK + r) * n + c * CW + cc));
    }
  };
  auto put = [&](int q) {
    T* dst = ring + (q % STAGES) * BK * CW;
#pragma unroll
    for (int j = 0; j < kWordsPerThread; ++j) {
      const int i = tid + j * NT, r = i / (CW / 8), cc = (i % (CW / 8)) * 8;
      if (kWords % NT == 0 || i < kWords) {
        if constexpr (kWiden) {
          float f[8];
          widen8(pre[j], f);
          store16(dst + r * CW + cc, f);
          store16(dst + r * CW + cc + 4, f + 4);
        }
      }
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nq) load(s);
    cp_async_commit();
  }
  T acc[TE][V];
#pragma unroll
  for (int i = 0; i < TE; ++i)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[i][j] = T(0);
  const T* a_rows = a + warp * TE * lda;
  const int col = lane * V;  // the thread's columns within a chunk
  for (int q = 0; q < nq; ++q) {
    cp_async_wait<STAGES - 2>();  // slab q has landed
    __syncthreads();              // ... for every thread, and slab q - 1 is consumed
    const bool next = q + STAGES - 1 < nq;
    if (next) {
      if (prefetch)
        fetch(q + STAGES - 1);
      else
        load(q + STAGES - 1);
    }
    cp_async_commit();
    const int c = q / nk, s = q - c * nk;
    const T* sb = ring + (q % STAGES) * BK * CW + col;
    const T* sa = a_rows + s * BK;
#pragma unroll
    for (int kk = 0; kk < BK; kk += V) {
      T fa[TE][V];
#pragma unroll
      for (int i = 0; i < TE; ++i) load16(fa[i], sa + i * lda + kk);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        T fb[V];
        load16(fb, sb + (kk + v) * CW);
#pragma unroll
        for (int i = 0; i < TE; ++i)
#pragma unroll
          for (int j = 0; j < V; ++j) acc[i][j] += fa[i][v] * fb[j];
      }
    }
    if (next && prefetch) put(q + STAGES - 1);
    if (s == nk - 1) {  // the chunk's sums are complete
      epi(warp * TE, c * CW + col, acc);
#pragma unroll
      for (int i = 0; i < TE; ++i)
#pragma unroll
        for (int j = 0; j < V; ++j) acc[i][j] = T(0);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// h_pre[j] = alpha0 * emb_e . W1[:, c0 + j] for the V columns j < V of
// one edge, each summed over i in increasing order; w1 points at W1[0][c0]
// of a shared copy with row stride ldw1 (c0 and ldw1 multiples of V).
template <typename T>
__device__ __forceinline__ void hidden_pre(const T* emb_e, const T* w1, int ldw1, int n_emb, T alpha0,
                                           T (&hp)[Vec<T>::V]) {
  constexpr int V = Vec<T>::V;
  T acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = T(0);
  for (int i = 0; i < n_emb; ++i) {
    T wv[V];
    load16(wv, w1 + i * ldw1);
    const T ev = emb_e[i];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] += ev * wv[j];
  }
#pragma unroll
  for (int j = 0; j < V; ++j) hp[j] = alpha0 * acc[j];
}

}  // namespace mlp
}  // namespace nequip
