// The radial-MLP weight gradients of K2's training variant: a deterministic
// reduction over the edges,
//   out[p, q] = scale * sum_{e < n} a[e, p] * b[e, q]
// with (a, b, scale) = (h_e, dW_e, alpha1) for dW2 [hidden, WN] and
// (emb_e, dh_pre_e, alpha0) for dW1 [n_emb, hidden]; a [M, P] and b [M, Q]
// row-major, M >= n.
//
// Replaces the dW accumulation of the TPU kernel
// nequip_tpu/ops/pallas/tp_scatter.py, _bwd_mlp_kernel_T (:1488-1495:
// dw2 += alpha1 * h_t dw_t^T, dw1 += alpha0 * emb_t dh_pre_t^T), which
// carries the two sums in its output blocks across the sequential grid of
// kernel_bwd's pallas_call (:1733).  Hopper's blocks run in no order, so
// the sum is split in two fixed-order passes, with no atomics: two calls
// give bitwise equal results.
//
// What bounds it on an H100, at the flagship's shapes (23k atoms, 419,904
// edges, f32): dW2 (P = 128, Q = 96, 352, 96) by operations, 2 n P Q =
// 58.4 GFLOP over the three layers, 0.87 ms at 67 TFLOP/s of FFMA; dW1
// (P = 8, Q = 128) by bytes, n (P + Q) 4 B = 228 MB per layer, 0.068 ms
// at 3.35 TB/s.  No tensor-core form is f32-exact (TF32 would change the
// numbers the f32 gates hold), so the product runs on FFMA.
//
// Design (a split-K outer-product sum):
// - Pass 1: the edges are cut into S contiguous chunks of `chunk` edges;
//   S and chunk come from the wrapper (tp_scatter.py _dw_split, a pure
//   function of n, P and Q sized for one full wave of 132 SMs).  The grid
//   is (ceil(Q / BN), S, ceil(P / BM)); a block sums its chunk into one
//   BM x BN tile of the output and writes it as the chunk's partial.
// - One block tile covers every row of the output (BM = 128 for dW2), so
//   b is read from HBM once and a once per BN-column slice (4 times for
//   Q = 352); the column tiles of one chunk are neighbours in the grid, so
//   the repeats of a tend to hit L2.
// - A slab of BK edges is BK contiguous rows of a and of b: it is staged as
//   [BK][BM] and [BK][BN] in shared memory with no transpose, through a ring
//   of STAGES slabs filled by 16-byte cp.async.cg copies, so the next slabs
//   load while this one computes (one __syncthreads per slab).
// - Register micro-tiles: thread (tx, ty) owns a TM x TN patch, rows
//   r * THR_M * V + ty * V + [0, V) and columns j * THR_N * V + tx * V +
//   [0, V) (V = 16 B / sizeof(T)); per edge it reads its TM values of a and
//   TN of b as 16-byte shared loads (a warp's 8 threads of one phase share
//   ty, so the a loads broadcast and the b loads cover 128 contiguous bytes:
//   no bank conflicts) and does TM x TN FMAs (f32 dW2: 5 loads per 96 FMAs).
// - Every accumulator sums its chunk's edges in increasing order; pass 2
//   sums the S partials of each output value in chunk order, with
//   coalesced loads, and applies `scale`.
// - Two tile configurations of one template, chosen by P: "wide" (BM 128,
//   BN 96) for dW2 and "narrow" (BM 8, BN 128: the whole dW1 output, every
//   thread keeping a few columns for all 8 rows) for P <= 8.
// - The 16-byte copies need P and Q times sizeof(T) to be multiples of 16
//   and 16-byte aligned bases (true at every shape of the flagship); any
//   other shape is staged element by element (cp.async.ca of sizeof(T)) in
//   the same kernel.  Rows past the chunk's end and columns past P or Q are
//   filled with zeros.  n = 0 gives zeros.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace nequip {
namespace {

// Starts the copy of rows [e0, e0 + BK) x columns [c0, c0 + W) of the
// row-major src [*, ld] into dst [BK][W]; rows >= e_end and columns >= ld
// read as zero.
template <typename T, int BK, int W, int THREADS>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src, int e0, int e_end, int c0, int ld,
                                      bool vec, int tid) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    constexpr int kCopies = BK * W / V;
#pragma unroll
    for (int j = 0; j < (kCopies + THREADS - 1) / THREADS; ++j) {
      const int i = tid + j * THREADS;
      if (kCopies % THREADS == 0 || i < kCopies) {
        const int r = i / (W / V), c = (i % (W / V)) * V;
        const bool ok = e0 + r < e_end && c0 + c < ld;
        cp_async_16(dst + r * W + c, ok ? src + static_cast<int64_t>(e0 + r) * ld + c0 + c : src, ok);
      }
    }
  } else {
    for (int i = tid; i < BK * W; i += THREADS) {
      const int r = i / W, c = i % W;
      const bool ok = e0 + r < e_end && c0 + c < ld;
      cp_async_elem<sizeof(T)>(dst + i, ok ? src + static_cast<int64_t>(e0 + r) * ld + c0 + c : src, ok);
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN, int STAGES, int MIN_BLOCKS>
struct Tile {
  static constexpr int V = 16 / sizeof(T);
  static constexpr int THR_M = BM / TM, THR_N = BN / TN, THREADS = THR_M * THR_N;
  static constexpr int SMEM = STAGES * BK * (BM + BN) * static_cast<int>(sizeof(T));
  static_assert(TM % V == 0 && TN % V == 0, "micro-tiles are whole 16-byte vectors");
  static_assert(BM % TM == 0 && BN % TN == 0, "micro-tiles divide the block tile");
  static_assert(STAGES >= 3, "the ring keeps at least two slabs in flight");
};

// Pass 1: block (x, c, z) writes partial[c][p][q] = sum over the edges
// [c * chunk, min(n, (c + 1) * chunk)) of a[e, p] b[e, q] for its tile,
// p in [z BM, z BM + BM), q in [x BN, x BN + BN).
template <typename T, int BM, int BN, int BK, int TM, int TN, int STAGES, int MIN_BLOCKS>
__global__ void __launch_bounds__((BM / TM) * (BN / TN), MIN_BLOCKS)
    outer_partial_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ partial, int n, int P,
                         int Q, int chunk, bool vec) {
  using C = Tile<T, BM, BN, BK, TM, TN, STAGES, MIN_BLOCKS>;
  constexpr int V = C::V, THR_M = C::THR_M, THR_N = C::THR_N, THREADS = C::THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_a = reinterpret_cast<T*>(smem_raw);  // [STAGES][BK][BM]
  T* s_b = s_a + STAGES * BK * BM;          // [STAGES][BK][BN]

  const int tid = threadIdx.x;
  const int tx = tid % THR_N, ty = tid / THR_N;
  const int q0 = blockIdx.x * BN, c_idx = blockIdx.y, p0 = blockIdx.z * BM;
  const int e_begin = min(n, c_idx * chunk);
  const int e_end = min(n, e_begin + chunk);
  const int n_slabs = (e_end - e_begin + BK - 1) / BK;

  auto load = [&](int slab) {
    const int st = slab % STAGES, e0 = e_begin + slab * BK;
    stage<T, BK, BM, THREADS>(s_a + st * BK * BM, a, e0, e_end, p0, P, vec, tid);
    stage<T, BK, BN, THREADS>(s_b + st * BK * BN, b, e0, e_end, q0, Q, vec, tid);
  };

  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = T(0);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_slabs) load(s);
    cp_async_commit();
  }
  for (int t = 0; t < n_slabs; ++t) {
    cp_async_wait<STAGES - 2>();  // slab t has landed
    __syncthreads();              // ... for every thread, and slab t - 1 is consumed
    if (t + STAGES - 1 < n_slabs) load(t + STAGES - 1);
    cp_async_commit();
    const T* sa = s_a + (t % STAGES) * BK * BM + ty * V;
    const T* sb = s_b + (t % STAGES) * BK * BN + tx * V;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      T fa[TM], fb[TN];
#pragma unroll
      for (int r = 0; r < TM / V; ++r) load16(fa + r * V, sa + k * BM + r * THR_M * V);
#pragma unroll
      for (int j = 0; j < TN / V; ++j) load16(fb + j * V, sb + k * BN + j * THR_N * V);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += fa[i] * fb[j];
    }
  }
  cp_async_wait<0>();

  T* out = partial + static_cast<int64_t>(c_idx) * P * Q;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int p = p0 + (i / V) * THR_M * V + ty * V + i % V;
    if (p >= P) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int q = q0 + (j / V) * THR_N * V + tx * V + j % V;
      if (q < Q) out[static_cast<int64_t>(p) * Q + q] = acc[i][j];
    }
  }
}

// Pass 2: out[i] = scale * sum_{c < n_chunks} partial[c][i], in chunk order.
template <typename T>
__global__ void __launch_bounds__(128) sum_partials_kernel(const T* __restrict__ partial, T* __restrict__ out,
                                                           int n_chunks, int pq, T scale) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= pq) return;
  T acc = T(0);
#pragma unroll 16
  for (int c = 0; c < n_chunks; ++c) acc += partial[static_cast<int64_t>(c) * pq + i];
  out[i] = scale * acc;
}

template <typename T, int BM, int BN, int BK, int TM, int TN, int STAGES, int MIN_BLOCKS>
cudaError_t launch_partials(const T* a, const T* b, T* partial, int n, int P, int Q, int chunk, int n_chunks,
                            bool vec, cudaStream_t s) {
  using C = Tile<T, BM, BN, BK, TM, TN, STAGES, MIN_BLOCKS>;
  auto kernel = outer_partial_kernel<T, BM, BN, BK, TM, TN, STAGES, MIN_BLOCKS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((Q + BN - 1) / BN, n_chunks, (P + BM - 1) / BM);
  kernel<<<grid, C::THREADS, C::SMEM, s>>>(a, b, partial, n, P, Q, chunk, vec);
  return cudaGetLastError();
}

constexpr int kNarrowRows = 8;  // P <= kNarrowRows takes the narrow tile (dW1)

// The tile configurations (tp_scatter.py _DW_NARROW and _DW_WIDE hold the
// f32 ones' BM, BN and resident blocks per SM, which size the split).  The
// f32 wide tile was measured on an H100 against 8 x 12 at 3 blocks per SM
// (168 registers, spills), 8 x 8 and 16 x 8 micro-tiles, 128-column tiles
// with 8 x 16, slabs of 8 and 32 edges, 4 or 8 stages, and a copy of the
// loop without the dead column groups of layer 1's last tile (slower: three
// loop copies, 227 registers), and was fastest:
//   f32 wide:   BM 128, BN 96, BK 16, 8 x 12 per thread, 128 threads, 6 stages, 86,016 B, 2 per SM
//   f32 narrow: BM 8, BN 128, BK 32, 8 x 4 per thread, 32 threads, 4 stages, 69,632 B, 3 per SM
//   f64 wide:   BM 128, BN 96, BK 16, 8 x 6 per thread, 256 threads, 3 stages, 86,016 B
//   f64 narrow: BM 8, BN 128, BK 16, 8 x 2 per thread, 64 threads, 4 stages, 69,632 B
template <typename T>
cudaError_t launch_pass1(const T* a, const T* b, T* partial, int n, int P, int Q, int chunk, int n_chunks,
                         bool vec, cudaStream_t s);

template <>
cudaError_t launch_pass1<float>(const float* a, const float* b, float* partial, int n, int P, int Q, int chunk,
                                int n_chunks, bool vec, cudaStream_t s) {
  if (P <= kNarrowRows)
    return launch_partials<float, 8, 128, 32, 8, 4, 4, 3>(a, b, partial, n, P, Q, chunk, n_chunks, vec, s);
  return launch_partials<float, 128, 96, 16, 8, 12, 6, 2>(a, b, partial, n, P, Q, chunk, n_chunks, vec, s);
}

template <>
cudaError_t launch_pass1<double>(const double* a, const double* b, double* partial, int n, int P, int Q,
                                 int chunk, int n_chunks, bool vec, cudaStream_t s) {
  if (P <= kNarrowRows)
    return launch_partials<double, 8, 128, 16, 8, 2, 4, 3>(a, b, partial, n, P, Q, chunk, n_chunks, vec, s);
  return launch_partials<double, 128, 96, 16, 8, 6, 3, 1>(a, b, partial, n, P, Q, chunk, n_chunks, vec, s);
}

template <typename T>
int launch_dw_reduce(const void* a, const void* b, void* partial, void* out, int n, int P, int Q, int chunk,
                     int n_chunks, double scale, void* stream) {
  if (P <= 0 || Q <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (P * sizeof(T)) % 16 == 0 && (Q * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a) % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  cudaError_t err = launch_pass1<T>(static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(partial),
                                    n, P, Q, chunk, n_chunks, vec, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pq = P * Q;
  sum_partials_kernel<T><<<(pq + 127) / 128, 128, 0, s>>>(static_cast<const T*>(partial), static_cast<T*>(out),
                                                          n_chunks, pq, static_cast<T>(scale));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace nequip

extern "C" int nequip_dw_reduce_f32(const void* a, const void* b, void* partial, void* out, int n, int P, int Q,
                                    int chunk, int n_chunks, double scale, void* stream) {
  return nequip::launch_dw_reduce<float>(a, b, partial, out, n, P, Q, chunk, n_chunks, scale, stream);
}

extern "C" int nequip_dw_reduce_f64(const void* a, const void* b, void* partial, void* out, int n, int P, int Q,
                                    int chunk, int n_chunks, double scale, void* stream) {
  return nequip::launch_dw_reduce<double>(a, b, partial, out, n, P, Q, chunk, n_chunks, scale, stream);
}
