// Block-GEMM routines of the radial MLP on a dense tile of edges, shared by
// the convolution kernels that compute the MLP in-kernel (K1, conv_fwd.cu;
// K2, conv_bwd.cu).
//
// The MLP is W = alpha1 * silu(alpha0 * emb . W1) . W2 with W1 [n_emb, H]
// and W2 [H, WN].  On a tile of TILE edges the two products with H and WN
// inside are block GEMMs: A [TILE, K] lives in shared memory, B [K, N] is a
// weight matrix in global memory (L2-resident: at most a few hundred KB)
// that streams through a small cp.async ring in k-slabs and is reused by
// every edge of the tile.  tile_gemm, the f32 and f64 form, runs on FFMA:
// no tensor-core form is f32-exact, and the kernels are held to plain f32 at
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
//
// tile_mma, the bf16 form (the bf16 instantiations of K1, conv_fwd.cu: w =
// alpha1 h . W2 with h float32 as MmaRowsSplit; and of K2, conv_bwd.cu, its
// two W2 products): the same C = A . B on the tensor cores,
// mma.sync m16n8k16 with bf16 operands and float32 accumulators.  A bf16 x
// bf16 product is exact in float32, so only the sums differ from FFMA's:
// the tensor core's float32 sum of one k16 group is not a sequential IEEE
// sum, and its error grows with the k16 steps an accumulator runs, which
// here are K / 16 (8 at K = hidden = 128, 22 at WN = 352, 48 at preset M's
// 768; dw_reduce.cu caps its own runs at 256 steps).
// - B (bf16 in device memory, row-major [k, n]) streams through a ring of
//   STAGES slabs of BK rows x kMmaCols columns by 16-byte cp.async copies,
//   raw, with no widening, so the ring keeps its asynchrony.  Rows are
//   padded by 16 bytes (padded_row), so ldmatrix.trans takes the B
//   fragments of a row-major slab without bank conflicts.  B whose rows are not 16-byte aligned is copied 2 bytes
//   at a time (cp.async has no 2-byte form), ordered by the same barriers.
// - A comes from shared memory through a fragment policy: MmaRowsBf16 (a
//   bf16 tile, by ldmatrix) or MmaRowsSplit (a float32 tile, each value
//   split into two bf16 terms hi + lo in registers, cvt.rn.bf16x2.f32, two
//   MMAs per fragment into the same accumulators: float32's product to
//   ~2^-17 relative, mma_bf16.cuh split_bf16x2).
// - Warps: a 32-row tile takes 2 m16 tiles x 4 column groups of 32 (4 n8
//   tiles a warp, 16 accumulators a thread); 16 or 8 rows take 1 x 8 groups
//   of 16 (an 8-row tile's m16 tile reads its rows again past row 8, whose
//   products are not stored).
// - Why mma.sync and not wgmma: a K2 tile is 32 edges and wgmma takes 64
//   rows; K2's 64-edge tiles were slower (conv_bwd.cu).
// - epi(row, col, v0, v1) takes the accumulator pairs (columns col and col
//   + 1 of a row; rows g and g + 8, columns 2t and 2t + 1 of each m16n8
//   tile, g = lane / 4, t = lane % 4) once a chunk's k steps are done.
//   Every sum runs in a fixed order: bitwise repeatable.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cp_async.cuh"
#include "mma_bf16.cuh"
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
// zero.
template <typename T, int BK, int CW, int NT>
__device__ __forceinline__ void stage_slab(T* dst, const T* __restrict__ b, int k0, int k, int c0, int n, bool vec,
                                           int tid) {
  constexpr int V = Vec<T>::V;
  if (vec) {
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
// one with no copy in flight, so the caller may reuse the ring at once.
template <typename T, int TILE, int BK, int STAGES, typename Epi>
__device__ __forceinline__ void tile_gemm(const T* a, int lda, const T* __restrict__ b, int k, int n, T* ring,
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
    if (q + STAGES - 1 < nq) load(q + STAGES - 1);
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
// of a shared copy with row stride ldw1 (c0 and ldw1 multiples of V).  emb
// and W1 may be bf16 copies (S = __nv_bfloat16, T = float: K1's bf16 form),
// each value widened where it is read (exact: the float copies' sums).
template <typename T, typename S = T>
__device__ __forceinline__ void hidden_pre(const S* emb_e, const S* w1, int ldw1, int n_emb, T alpha0,
                                           T (&hp)[Vec<T>::V]) {
  constexpr int V = Vec<T>::V;
  T acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = T(0);
  for (int i = 0; i < n_emb; ++i) {
    T wv[V];
    if constexpr (std::is_same<S, T>::value) {
      load16(wv, w1 + i * ldw1);
    } else {  // 4 bf16 values, one 8-byte load (a float's upper half is its bf16)
      static_assert(V == 4, "bf16 W1 into float columns");
      const uint2 q = *reinterpret_cast<const uint2*>(w1 + i * ldw1);
      wv[0] = __uint_as_float(q.x << 16), wv[1] = __uint_as_float(q.x & 0xffff0000u);
      wv[2] = __uint_as_float(q.y << 16), wv[3] = __uint_as_float(q.y & 0xffff0000u);
    }
    const T ev = widen(emb_e[i]);
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] += ev * wv[j];
  }
#pragma unroll
  for (int j = 0; j < V; ++j) hp[j] = alpha0 * acc[j];
}

// hidden_pre for the 2 columns c0, c0 + 1 of one edge (c0 even; the same
// sum in the same order per column): tile_mma's epilogues hold column pairs
template <typename T>
__device__ __forceinline__ void hidden_pre2(const T* emb_e, const T* w1, int ldw1, int n_emb, T alpha0,
                                            T (&hp)[2]) {
  T acc[2] = {T(0), T(0)};
  for (int i = 0; i < n_emb; ++i) {
    const T ev = emb_e[i];
    acc[0] += ev * w1[i * ldw1];
    acc[1] += ev * w1[i * ldw1 + 1];
  }
  hp[0] = alpha0 * acc[0];
  hp[1] = alpha0 * acc[1];
}

constexpr int kMmaCols = 128;  // tile_mma's column chunk: the B columns of a ring slab

// Shared-memory bytes of tile_mma's ring
template <int BK, int STAGES>
__host__ __device__ constexpr int mma_ring_bytes() {
  return STAGES * BK * padded_row(kMmaCols) * static_cast<int>(sizeof(__nv_bfloat16));
}

// A for tile_mma from a bf16 tile [TILE][ld] in shared memory (ld a
// multiple of 8), by ldmatrix
template <int TILE>
struct MmaRowsBf16 {
  static constexpr int kTerms = 1;
  const __nv_bfloat16* a;
  int ld;
  // the m16 x k16 fragment at (row0, k0): matrices (rows 0-7, k 0-7), (8-15,
  // 0-7), (0-7, 8-15), (8-15, 8-15)
  __device__ __forceinline__ void frags(int row0, int k0, uint32_t (&f)[kTerms][4]) const {
    const int lane = threadIdx.x & 31, q = lane >> 3;
    const int r = min(row0 + (lane & 7) + (q & 1) * 8, TILE - 1);  // rows past the tile are not stored
    ldmatrix_x4(f[0], a + r * ld + k0 + (q >> 1) * 8);
  }
};

// A for tile_mma from a float32 tile [TILE][ld] in shared memory (ld even):
// each value as two bf16 terms hi + lo (split_bf16x2), two MMAs a fragment
template <int TILE>
struct MmaRowsSplit {
  static constexpr int kTerms = 2;
  const float* a;
  int ld;
  // registers a0..a3 hold (row g, k 2t, 2t + 1), (g + 8, 2t), (g, 2t + 8), (g + 8, 2t + 8)
  __device__ __forceinline__ void frags(int row0, int k0, uint32_t (&f)[kTerms][4]) const {
    const int lane = threadIdx.x & 31;
    const int r0 = min(row0 + (lane >> 2), TILE - 1), r1 = min(row0 + (lane >> 2) + 8, TILE - 1);
    const int c = k0 + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = *reinterpret_cast<const float2*>(a + ((i & 1) ? r1 : r0) * ld + c + (i >> 1) * 8);
      split_bf16x2(v.x, v.y, f[0][i], f[1][i]);
    }
  }
};

// C [TILE, round_up(n, kMmaCols)] = A [TILE, k] . B [k, n] on the tensor
// cores (the header above), chunk by chunk of kMmaCols columns.  A: a
// fragment policy (MmaRowsBf16 or MmaRowsSplit) over a tile whose columns
// [k, round_up(k, 16)) are zero.  B: bf16, global, row-major [k, n], read as
// zero past row k and column n, streamed through ring (mma_ring_bytes<BK,
// STAGES>() bytes of shared memory).  For each chunk every thread calls
// epi(row, col, v0, v1) for its accumulator pairs of rows < TILE.  Starts
// with a barrier (A is complete, and every reader of what the ring's memory
// held before is done) and ends at one with no copy in flight.
template <int TILE, int BK, int STAGES, typename A, typename Epi>
__device__ __forceinline__ void tile_mma(const A a, const __nv_bfloat16* __restrict__ b, int k, int n,
                                         __nv_bfloat16* ring, Epi&& epi) {
  constexpr int NT = 256, CW = kMmaCols, LDB = padded_row(CW);
  constexpr int WM = TILE >= 32 ? 2 : 1, NTW = CW / 8 / (8 / WM);  // warps over m16 tiles; n8 tiles a warp
  static_assert(TILE == 32 || TILE == 16 || TILE == 8, "tile_mma takes 32-, 16- or 8-row tiles");
  static_assert(BK % 16 == 0 && STAGES >= 2 && NTW % 2 == 0, "tile_mma shape");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = (warp % WM) * 16, col_w = (warp / WM) * NTW * 8;  // the warp's rows and chunk columns
  const int nk = cdiv(k, BK), nq = nk * cdiv(n, CW);
  const bool vec = n % 8 == 0 && (reinterpret_cast<uintptr_t>(b) & 15) == 0;
  __syncthreads();  // A is complete, and every reader of what the ring's memory held before is done
  auto load = [&](int q) {  // slab q: rows [s BK, s BK + BK) x the columns of chunk c
    const int c = q / nk, s = q - c * nk, k0 = s * BK, c0 = c * CW;
    __nv_bfloat16* dst = ring + (q % STAGES) * BK * LDB;
    if (vec) {
      constexpr int kCopies = BK * CW / 8;
#pragma unroll
      for (int j = 0; j < (kCopies + NT - 1) / NT; ++j) {
        const int i = tid + j * NT;
        if (kCopies % NT == 0 || i < kCopies) {
          const int r = i / (CW / 8), cc = (i % (CW / 8)) * 8;
          const bool ok = k0 + r < k && c0 + cc < n;
          cp_async_16(dst + r * LDB + cc, ok ? b + static_cast<int64_t>(k0 + r) * n + c0 + cc : b, ok);
        }
      }
    } else {
      for (int i = tid; i < BK * CW; i += NT) {
        const int r = i / CW, cc = i % CW;
        const bool ok = k0 + r < k && c0 + cc < n;
        dst[r * LDB + cc] = ok ? b[static_cast<int64_t>(k0 + r) * n + c0 + cc] : __float2bfloat16(0.f);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nq) load(s);
    cp_async_commit();
  }
  float acc[NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int h = 0; h < 4; ++h) acc[j][h] = 0.f;
  // the lane's row of an x4.trans load of B (k16 x two n8 tiles): matrices
  // (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
  const int r8 = lane & 7, quad = lane >> 3;
  const int b_lane = (r8 + (quad & 1) * 8) * LDB + col_w + (quad >> 1) * 8;
  for (int q = 0; q < nq; ++q) {
    cp_async_wait<STAGES - 2>();  // slab q has landed
    __syncthreads();              // ... for every thread, and slab q - 1 is consumed
    if (q + STAGES - 1 < nq) load(q + STAGES - 1);
    cp_async_commit();
    const int c = q / nk, s = q - c * nk;
    const __nv_bfloat16* sb = ring + (q % STAGES) * BK * LDB + b_lane;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      if (s * BK + kk < k) {  // block-uniform: the k16 steps that cover k
        uint32_t fa[A::kTerms][4];
        a.frags(row0, s * BK + kk, fa);
#pragma unroll
        for (int j = 0; j < NTW; j += 2) {
          uint32_t d[4];
          ldmatrix_x4_trans(d, sb + kk * LDB + j * 8);
          const uint32_t b0[2] = {d[0], d[1]}, b1[2] = {d[2], d[3]};
#pragma unroll
          for (int t = 0; t < A::kTerms; ++t) {
            mma_bf16(acc[j], fa[t], b0);
            mma_bf16(acc[j + 1], fa[t], b1);
          }
        }
      }
    }
    if (s == nk - 1) {  // the chunk's sums are complete
      const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + g + 8 * h;
          if (r < TILE) epi(r, c * CW + col_w + j * 8 + t2, acc[j][2 * h], acc[j][2 * h + 1]);
          acc[j][2 * h] = acc[j][2 * h + 1] = 0.f;
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

}  // namespace mlp
}  // namespace nequip
