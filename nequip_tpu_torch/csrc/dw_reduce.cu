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
//   other shape is staged element by element (cp.async.ca of sizeof(T); a
//   plain copy for bf16, which cp.async cannot move alone) in the same
//   kernel.  Rows past the chunk's end and columns past P or Q are filled
//   with zeros.  n = 0 gives zeros.
//
// bf16 (the fast mode's training: nequip_dw_reduce_bf16): a and b are bf16,
// the partials, out and scale float32.  Its bound at the flagship's shapes
// is bytes, n (P + Q) 2 B: 0.335 ms over the three layers and both shapes
// at 3.35 TB/s, against 0.059 ms for the product at 989 TFLOP/s of bf16
// tensor cores.  So pass 1 runs its product on the tensor cores, with no
// value widened: mma.sync m16n8k16 with bf16 operands and float32
// accumulators (a bf16 x bf16 product is exact in float32).
// - The contraction runs over the edges: the block tile of x^T y (x [*, MX],
//   y [*, NY]) is the M = MX side by the N = NY side, K = the chunk's edges.
//   The ring stages both slabs edge-major as f32's does ([BK][BM],
//   [BK][BN]: BK contiguous rows of x and of y, 16-byte cp.async.cg), and
//   ldmatrix.x4.trans hands each warp its A (x^T) and B (y) fragments
//   straight from those rows: no transpose in memory.
// - Rows whose 16-byte count is even are padded by 16 bytes (LDX, LDY), so
//   the 8 rows of one ldmatrix phase start on 8 different bank groups (a
//   128-value row is 256 bytes: unpadded, all 8 on the same banks).
// - dW2 (P > 8): x = a, y = b.  16 warps as 4 x 4, each 32 x 8 NT of the
//   output (two m16 tiles by NT n8 tiles, 8 NT float32 accumulators a
//   thread), BN = 32 NT up to 352: one block an SM.  An SM takes in about
//   23 GB/s through cp.async, from L2 as from HBM (~3 TB/s over the card),
//   so every extra read of a costs as much as one from HBM: the tile is as
//   wide as the registers allow (NT 11), and a is read once at Q <= 352.
//   The column tiles of one chunk (Q > 352) are neighbours in the grid.
// - dW1 (P <= 8): the transpose, out^T [Q, P] = b^T a: x = b, y = a, the 8
//   warps each one m16 tile of Q and the whole of P as one n8 tile, the
//   partial stored transposed.  There is nothing to compute: the ring's
//   depth keeps the bytes in flight.
// - A block sums its chunk's slabs in increasing edge order, and the MMAs
//   of a slab in a fixed order; pass 2 is f32's.  The tensor core's float32
//   sum of one k16 group is not a sequential IEEE sum (it may align the
//   products to the largest before adding), so the result is not the FFMA
//   form's bit for bit, but two calls are.  Its error grows faster than the
//   number of k16 steps an accumulator runs over, so a chunk is at most
//   4,096 edges (chip_dw_profile.py --one-wave shows longer chunks leave
//   phase 2's f32 gate).  JAX's kernel_bwd instead adds each 256-edge
//   chunk's product, rounded to bf16, onto bf16 dw1/dw2 blocks.
// - _dw_split(n, P, Q, bfloat16) sizes the chunks for these tiles (one wave
//   of 132 blocks, or whole waves where one wave's chunks would be longer
//   than 4,096 edges; chunks whole 64-edge slabs).  Operands the 16-byte copies
//   cannot take go to kernels of their own (VEC false: 2-byte plain copies,
//   cp.async cannot move them alone; dW2 in 64-column tiles), which sum each
//   value in the same order.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "mma_bf16.cuh"
#include "tp_common.cuh"

namespace nequip {
namespace {

// Starts the copy of rows [e0, e0 + BK) x columns [c0, c0 + W) of the
// row-major src [*, ld] into dst [BK][LD] (LD >= W: bf16 pads its rows);
// rows >= e_end and columns >= ld read as zero.
template <typename T, int BK, int W, int THREADS, int LD = W>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src, int e0, int e_end, int c0, int ld,
                                      bool vec, int tid) {
  constexpr int V = 16 / sizeof(T);  // T: the storage type
  if (vec) {
    constexpr int kCopies = BK * W / V;
#pragma unroll
    for (int j = 0; j < (kCopies + THREADS - 1) / THREADS; ++j) {
      const int i = tid + j * THREADS;
      if (kCopies % THREADS == 0 || i < kCopies) {
        const int r = i / (W / V), c = (i % (W / V)) * V;
        const bool ok = e0 + r < e_end && c0 + c < ld;
        cp_async_16(dst + r * LD + c, ok ? src + static_cast<int64_t>(e0 + r) * ld + c0 + c : src, ok);
      }
    }
  } else {
    for (int i = tid; i < BK * W; i += THREADS) {
      const int r = i / W, c = i % W;
      const bool ok = e0 + r < e_end && c0 + c < ld;
      if constexpr (sizeof(T) >= 4) {
        cp_async_elem<sizeof(T)>(dst + i, ok ? src + static_cast<int64_t>(e0 + r) * ld + c0 + c : src, ok);
      } else {  // a 2-byte copy (bf16: LD may pad); the barrier before the slab is read orders it
        *reinterpret_cast<unsigned short*>(dst + r * LD + c) =
            ok ? *reinterpret_cast<const unsigned short*>(src + static_cast<int64_t>(e0 + r) * ld + c0 + c) : 0;
      }
    }
  }
}

// V values of S at s (16 bytes of shared memory) into d
__device__ __forceinline__ void load16w(float* d, const float* s) { load16(d, s); }
__device__ __forceinline__ void load16w(double* d, const double* s) { load16(d, s); }

// S: the storage type of a and b (the ring's type); the sums run in Acc<S>
template <typename S, int BM, int BN, int BK, int TM, int TN, int STAGES, int MIN_BLOCKS>
struct Tile {
  static constexpr int V = 16 / sizeof(S);
  static constexpr int THR_M = BM / TM, THR_N = BN / TN, THREADS = THR_M * THR_N;
  static constexpr int SMEM = STAGES * BK * (BM + BN) * static_cast<int>(sizeof(S));
  static_assert(TM % V == 0 && TN % V == 0, "micro-tiles are whole 16-byte vectors");
  static_assert(BM % TM == 0 && BN % TN == 0, "micro-tiles divide the block tile");
  static_assert(STAGES >= 3, "the ring keeps at least two slabs in flight");
};

// Pass 1: block (x, c, z) writes partial[c][p][q] = sum over the edges
// [c * chunk, min(n, (c + 1) * chunk)) of a[e, p] b[e, q] for its tile,
// p in [z BM, z BM + BM), q in [x BN, x BN + BN).
template <typename S, int BM, int BN, int BK, int TM, int TN, int STAGES, int MIN_BLOCKS>
__global__ void __launch_bounds__((BM / TM) * (BN / TN), MIN_BLOCKS)
    outer_partial_kernel(const S* __restrict__ a, const S* __restrict__ b, Acc<S>* __restrict__ partial, int n,
                         int P, int Q, int chunk, bool vec) {
  using T = Acc<S>;
  using C = Tile<S, BM, BN, BK, TM, TN, STAGES, MIN_BLOCKS>;
  constexpr int V = C::V, THR_M = C::THR_M, THR_N = C::THR_N, THREADS = C::THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* s_a = reinterpret_cast<S*>(smem_raw);  // [STAGES][BK][BM]
  S* s_b = s_a + STAGES * BK * BM;          // [STAGES][BK][BN]

  const int tid = threadIdx.x;
  const int tx = tid % THR_N, ty = tid / THR_N;
  const int q0 = blockIdx.x * BN, c_idx = blockIdx.y, p0 = blockIdx.z * BM;
  const int e_begin = min(n, c_idx * chunk);
  const int e_end = min(n, e_begin + chunk);
  const int n_slabs = (e_end - e_begin + BK - 1) / BK;

  auto load = [&](int slab) {
    const int st = slab % STAGES, e0 = e_begin + slab * BK;
    stage<S, BK, BM, THREADS>(s_a + st * BK * BM, a, e0, e_end, p0, P, vec, tid);
    stage<S, BK, BN, THREADS>(s_b + st * BK * BN, b, e0, e_end, q0, Q, vec, tid);
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
    const S* sa = s_a + (t % STAGES) * BK * BM + ty * V;
    const S* sb = s_b + (t % STAGES) * BK * BN + tx * V;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      T fa[TM], fb[TN];
#pragma unroll
      for (int r = 0; r < TM / V; ++r) load16w(fa + r * V, sa + k * BM + r * THR_M * V);
#pragma unroll
      for (int j = 0; j < TN / V; ++j) load16w(fb + j * V, sb + k * BN + j * THR_N * V);
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

// bf16's block tile: WARPS_M x WARPS_N warps, each MT m16 tiles by NT n8
// tiles of the output; slabs of BK edges in a ring of STAGES
template <int MT, int NT, int WARPS_M, int WARPS_N, int BK, int STAGES>
struct MmaTile {
  static constexpr int BM = 16 * MT * WARPS_M, BN = 8 * NT * WARPS_N, THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int LDX = padded_row(BM), LDY = padded_row(BN);
  static constexpr int SMEM = STAGES * BK * (LDX + LDY) * static_cast<int>(sizeof(__nv_bfloat16));
  static_assert(BK % 16 == 0, "a slab is whole k16 steps");
  static_assert(STAGES >= 3, "the ring keeps at least two slabs in flight");
};

// bf16 pass 1: block (x, c, z) writes the chunk's sum of x[e, m] y[e, k]
// for m in [z BM, z BM + BM), k in [x BN, x BN + BN) as partial[c][m][k]
// ([c][k][m] when T_OUT); x [*, MX] and y [*, NY] bf16, staged by 16-byte
// copies when VEC, else element by element (a kernel of its own: the
// element path's registers would make the widest tile spill).
template <int MT, int NT, int WARPS_M, int WARPS_N, int BK, int STAGES, bool T_OUT, bool VEC>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N, 1)
    mma_partial_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ y,
                       float* __restrict__ partial, int n, int MX, int NY, int chunk) {
  using C = MmaTile<MT, NT, WARPS_M, WARPS_N, BK, STAGES>;
  constexpr int BM = C::BM, BN = C::BN, LDX = C::LDX, LDY = C::LDY, THREADS = C::THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* s_x = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [STAGES][BK][LDX]
  __nv_bfloat16* s_y = s_x + STAGES * BK * LDX;                      // [STAGES][BK][LDY]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int n0 = blockIdx.x * BN, c_idx = blockIdx.y, m0 = blockIdx.z * BM;
  const int e_begin = min(n, c_idx * chunk);
  const int e_end = min(n, e_begin + chunk);
  const int n_slabs = (e_end - e_begin + BK - 1) / BK;

  auto load = [&](int slab) {
    const int st = slab % STAGES, e0 = e_begin + slab * BK;
    stage<__nv_bfloat16, BK, BM, THREADS, LDX>(s_x + st * BK * LDX, x, e0, e_end, m0, MX, VEC, tid);
    stage<__nv_bfloat16, BK, BN, THREADS, LDY>(s_y + st * BK * LDY, y, e0, e_end, n0, NY, VEC, tid);
  };

  // The lane's row of an x4 load within a k16 step: A (x^T, m16 x k16)
  // takes matrices (k 0-7, m 0-7), (k 0-7, m 8-15), (k 8-15, m 0-7), (k
  // 8-15, m 8-15); B (y, k16 x two n8 tiles) (k 0-7, n 0-7), (k 8-15, n
  // 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15); an x2 load the first two.
  const int r8 = lane & 7, quad = lane >> 3;
  const int a_off = (r8 + (quad >> 1) * 8) * LDX + wm * 16 * MT + (quad & 1) * 8;
  const int b_off = (r8 + (quad & 1) * 8) * LDY + wn * 8 * NT + (quad >> 1) * 8;

  float acc[MT][NT][4] = {};
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
    const __nv_bfloat16* sx = s_x + (t % STAGES) * BK * LDX + a_off;
    const __nv_bfloat16* sy = s_y + (t % STAGES) * BK * LDY + b_off;
#pragma unroll
    for (int k = 0; k < BK; k += 16) {
      uint32_t fa[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) ldmatrix_x4_trans(fa[i], sx + k * LDX + i * 16);
      // each pair of n8 tiles' B fragments just before its MMAs: 4 registers
      // live instead of 2 NT (NT = 11 fits in 128 registers)
#pragma unroll
      for (int j = 0; j + 1 < NT; j += 2) {
        uint32_t d[4];
        ldmatrix_x4_trans(d, sy + k * LDY + j * 8);
        const uint32_t b0[2] = {d[0], d[1]}, b1[2] = {d[2], d[3]};
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][j], fa[i], b0);
          mma_bf16(acc[i][j + 1], fa[i], b1);
        }
      }
      if constexpr (NT % 2 == 1) {
        uint32_t b0[2];
        ldmatrix_x2_trans(b0, sy + k * LDY + (NT - 1) * 8);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_bf16(acc[i][NT - 1], fa[i], b0);
      }
    }
  }
  cp_async_wait<0>();

  // accumulator h of an m16n8 tile: row gid + 8 (h / 2), column 2 tig + h % 2
  const int gid = lane >> 2, tig = lane & 3;
  float* out = partial + static_cast<int64_t>(c_idx) * MX * NY;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 16 * MT + i * 16 + h * 8 + gid;
      if (m >= MX) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int k = n0 + wn * 8 * NT + j * 8 + 2 * tig;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if constexpr (T_OUT) {
          if (k < NY) out[static_cast<int64_t>(k) * MX + m] = v0;
          if (k + 1 < NY) out[static_cast<int64_t>(k + 1) * MX + m] = v1;
        } else if (NY % 2 == 0) {  // k even: k < NY holds k + 1 too, and the pair is 8-byte aligned
          if (k < NY) *reinterpret_cast<float2*>(out + static_cast<int64_t>(m) * NY + k) = make_float2(v0, v1);
        } else {
          if (k < NY) out[static_cast<int64_t>(m) * NY + k] = v0;
          if (k + 1 < NY) out[static_cast<int64_t>(m) * NY + k + 1] = v1;
        }
      }
    }
  }
}

template <int MT, int NT, int WARPS_M, int WARPS_N, int BK, int STAGES, bool T_OUT, bool VEC>
cudaError_t launch_mma_partials(const __nv_bfloat16* x, const __nv_bfloat16* y, float* partial, int n, int MX,
                                int NY, int chunk, int n_chunks, cudaStream_t s) {
  using C = MmaTile<MT, NT, WARPS_M, WARPS_N, BK, STAGES>;
  auto kernel = mma_partial_kernel<MT, NT, WARPS_M, WARPS_N, BK, STAGES, T_OUT, VEC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((NY + C::BN - 1) / C::BN, n_chunks, (MX + C::BM - 1) / C::BM);
  kernel<<<grid, C::THREADS, C::SMEM, s>>>(x, y, partial, n, MX, NY, chunk);
  return cudaGetLastError();
}

template <typename S, int BM, int BN, int BK, int TM, int TN, int STAGES, int MIN_BLOCKS>
cudaError_t launch_partials(const S* a, const S* b, Acc<S>* partial, int n, int P, int Q, int chunk, int n_chunks,
                            bool vec, cudaStream_t s) {
  using C = Tile<S, BM, BN, BK, TM, TN, STAGES, MIN_BLOCKS>;
  auto kernel = outer_partial_kernel<S, BM, BN, BK, TM, TN, STAGES, MIN_BLOCKS>;
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
// bf16's tensor-core tiles, at one block an SM (tp_scatter.py _dw_tile
// mirrors the choice; chunks are whole 64-edge slabs, at most 4,096 edges):
//   bf16 narrow: out^T, BM 128 of Q by BN 8 of P, 8 warps of one m16 x n8 tile, BK 64, 8 stages, 147,456 B
//   bf16 wide:   BM 128 by BN = 32 NT, 16 warps (4 x 4) of 32 x 8 NT, BK 32, 6 stages, up to 190,464 B
//                (the element path: NT 2 whatever Q, a grid wider than one wave)
// The wide tile takes the fewest column tiles of at most 352 columns (NT
// <= 11: 88 accumulators a thread, the most that fit 128 registers), each
// the narrowest multiple of 32 that covers Q: 96 -> 96, 352 -> 352, 768 ->
// 3 x 256.  At Q = 352 a is then read once; measured on an H100 against
// narrower and wider column tiles, 8 warps of 32 x 8 NT, slabs of 64 edges
// and 3 to 8 stages (chip_dw_profile.py), and against B fragments all
// loaded before the MMAs (which spills at NT = 11).
constexpr int kBf16MaxNT = 11;

template <int NT>
cudaError_t launch_wide_bf16(int nt, const __nv_bfloat16* a, const __nv_bfloat16* b, float* partial, int n, int P,
                             int Q, int chunk, int n_chunks, cudaStream_t s) {
  if constexpr (NT > 1)
    if (nt < NT) return launch_wide_bf16<NT - 1>(nt, a, b, partial, n, P, Q, chunk, n_chunks, s);
  return launch_mma_partials<2, NT, 4, 4, 32, 6, false, true>(a, b, partial, n, P, Q, chunk, n_chunks, s);
}

template <typename S>
cudaError_t launch_pass1(const S* a, const S* b, Acc<S>* partial, int n, int P, int Q, int chunk, int n_chunks,
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

template <>
cudaError_t launch_pass1<__nv_bfloat16>(const __nv_bfloat16* a, const __nv_bfloat16* b, float* partial, int n,
                                        int P, int Q, int chunk, int n_chunks, bool vec, cudaStream_t s) {
  if (P <= kNarrowRows) {  // out^T [Q, P] = b^T a
    if (vec) return launch_mma_partials<1, 1, 8, 1, 64, 8, true, true>(b, a, partial, n, Q, P, chunk, n_chunks, s);
    return launch_mma_partials<1, 1, 8, 1, 64, 8, true, false>(b, a, partial, n, Q, P, chunk, n_chunks, s);
  }
  if (!vec)  // the element path: 64-column tiles, the same chunks and the same order a value sums in
    return launch_mma_partials<2, 2, 4, 4, 32, 6, false, false>(a, b, partial, n, P, Q, chunk, n_chunks, s);
  const int tiles = (Q + 32 * kBf16MaxNT - 1) / (32 * kBf16MaxNT);
  const int nt = ((Q + tiles - 1) / tiles + 31) / 32;
  return launch_wide_bf16<kBf16MaxNT>(nt, a, b, partial, n, P, Q, chunk, n_chunks, s);
}

// S the storage type of a and b; partial, out and scale are Acc<S>
template <typename S>
int launch_dw_reduce(const void* a, const void* b, void* partial, void* out, int n, int P, int Q, int chunk,
                     int n_chunks, double scale, void* stream) {
  using T = Acc<S>;
  if (P <= 0 || Q <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (P * sizeof(S)) % 16 == 0 && (Q * sizeof(S)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a) % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  cudaError_t err = launch_pass1<S>(static_cast<const S*>(a), static_cast<const S*>(b), static_cast<T*>(partial),
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

// a and b bf16; partial [n_chunks][P][Q] and out [P][Q] float32
extern "C" int nequip_dw_reduce_bf16(const void* a, const void* b, void* partial, void* out, int n, int P, int Q,
                                     int chunk, int n_chunks, double scale, void* stream) {
  return nequip::launch_dw_reduce<__nv_bfloat16>(a, b, partial, out, n, P, Q, chunk, n_chunks, scale, stream);
}
