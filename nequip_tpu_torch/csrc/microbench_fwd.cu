// T1 and T3: the conv-block microbenchmark forward, one constant chunk of
// `be` edges computed `grid` times and accumulated into out [rows, mid_dim].
//
// Replaces the TPU kernels tools/kernel_microbench.py, make (T1, row layout,
// pallas_call at :142) and make_t (T3, feature-major layout, :271).  Each
// step computes the whole block of its variant:
//   dot        out += S^T broadcast(x[:, 0])          S[e, r] = (rel[e] == r)
//   mlp        w = silu(emb . W1) . W2;               out[0, :WN] += w[0]
//   cg         msg = TP(x, y, broadcast(x[:, 0]));    out[0] += msg[0]
//   full       out += S^T TP(x, y, silu(emb . W1) . W2)
//   xpose      x staged feature-major (the transpose alone); out[0, 0] += x[0, 0]
//   cg_t       msg = TP(x_t, y_t, w_t);               out[0, 0] += msg[0, 0]
//   full_t     full, with x, y transposed in the kernel, W1 [H, n_emb], W2 [WN, H]
//   full_t_pre full_t with x, y given feature-major [dim, be]
// The scatter is the sum over the chunk's edges into their `rel` rows (the
// TPU's one-hot matmul is its algorithm, not its function).  Where only row 0
// reaches `out` (mlp, cg, xpose, cg_t), the whole block is still written to
// shared memory every step, as the TPU writes it to VMEM, so the work stays.
//
// Precision: HIGHEST is f32 (or f64) FMA throughout.  DEFAULT (f32 only)
// runs the two radial-MLP products on the tensor cores as TF32
// mma.sync.m16n8k8 with f32 accumulation (operands rounded with
// cvt.rna.tf32.f32): M over hidden units / radial weights, N = the 8 edges
// of a tile, K over n_emb / hidden.  CG and scatter stay f32 at both.
//
// What bounds it on an H100: operations (the chunk's inputs and out sit in
// L2); `full` at the tool's defaults is 2048 x (19.4 MFLOP of MLP products + 2.8
// MFLOP of CG, scatter and silu) ~ 45 GFLOP, 0.68 ms at 67 TFLOP/s f32.  Measured, it
// takes 13.7 ms (6.7 us per chunk; H100 80GB HBM3, 700 W), 20x that, of
// which the MLP's per-tile loops are 8.3 ms (3.4 ms on TF32): latency of
// the per-tile loops and barriers, as in K1.  `dot` (3.7 ms) is mostly the
// read-modify-writes of the block's partial in global memory.
// Design: the TPU runs the grid in order on one core and carries out in
// VMEM; here a persistent grid of n_blocks blocks takes the steps
// step = blockIdx.x, + gridDim.x, ...  Each block adds its steps into its own
// [rows, mid_dim] partial in global memory (thread o owns column o, so the
// edge order of every sum is fixed), and a second kernel sums the partials in
// block order: no atomics, two runs are bitwise equal.  Within a step the
// chunk goes kEdgeTile edges at a time through shared memory with the loops
// of K1's first design, before its dense edge tiles (MLP: one thread per
// hidden unit, then per radial weight; CG: one thread per output column,
// term tables from TPPlan).
#include <type_traits>

#include "tp_common.cuh"

namespace nequip {
namespace mb {

enum Variant : int { kDot = 0, kMlp, kCg, kFull, kXpose, kCgT, kFullT, kFullTPre };

__host__ __device__ constexpr bool has_mlp(int v) { return v == kMlp || v == kFull || v == kFullT || v == kFullTPre; }
__host__ __device__ constexpr bool has_cg(int v) { return v == kCg || v == kFull || v == kCgT || v == kFullT || v == kFullTPre; }
__host__ __device__ constexpr bool has_scatter(int v) { return v == kDot || v == kFull || v == kFullT || v == kFullTPre; }
__host__ __device__ constexpr bool smem_t(int v) { return v >= kXpose; }                   // T3: feature-major tiles
__host__ __device__ constexpr bool x_global_t(int v) { return v == kCgT || v == kFullTPre; }  // x, y given [dim, be]
__host__ __device__ constexpr bool w_global_t(int v) { return v == kFullT || v == kFullTPre; }  // W1 [H, n_emb], W2 [WN, H]
constexpr int kTS = kEdgeTile + 1;  // stride of a feature-major tile (no bank conflicts)

// element (edge e, feature c) of a shared tile `width` features wide
template <bool kT>
__device__ __forceinline__ int tix(int e, int c, int width) {
  return kT ? c * kTS + e : e * width + c;
}

// stage kEdgeTile edges from `base` of a [be, width] (or, kGlobalT, [width, be])
// array into a shared tile; consecutive threads read consecutive addresses
template <bool kSmemT, bool kGlobalT, typename T>
__device__ __forceinline__ void stage(T* s, const T* __restrict__ g, int base, int width, int be) {
  for (int i = threadIdx.x; i < kEdgeTile * width; i += blockDim.x) {
    int e, c;
    if (kGlobalT) {
      c = i / kEdgeTile;
      e = i - c * kEdgeTile;
    } else {
      e = i / width;
      c = i - e * width;
    }
    s[tix<kSmemT>(e, c, width)] =
        kGlobalT ? g[static_cast<int64_t>(c) * be + base + e] : g[static_cast<int64_t>(base + e) * width + c];
  }
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// c[16x8] += A[16x8] B[8x8], TF32 operands, f32 accumulators (PTX fragment layout)
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// out^T[M, 8 edges] = A[M, K] . in^T[K, 8 edges] on the tensor cores, one warp
// per 16-row tile of M; a(m, k) reads A, `in` is a shared tile K wide, the
// result goes through `store(edge, m, value)`.
template <bool kT, typename ReadA, typename Store>
__device__ __forceinline__ void mma_tile_product(int m_total, int k_total, ReadA a_at, const float* in,
                                                 Store store) {
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  for (int mt = threadIdx.x >> 5; mt < m_total / 16; mt += blockDim.x >> 5) {
    const int m0 = mt * 16;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < k_total; k0 += 8) {
      const uint32_t a[4] = {to_tf32(a_at(m0 + gid, k0 + tig)), to_tf32(a_at(m0 + gid + 8, k0 + tig)),
                             to_tf32(a_at(m0 + gid, k0 + tig + 4)), to_tf32(a_at(m0 + gid + 8, k0 + tig + 4))};
      const uint32_t b[2] = {to_tf32(in[tix<kT>(gid, k0 + tig, k_total)]),
                             to_tf32(in[tix<kT>(gid, k0 + tig + 4, k_total)])};
      mma_tf32(c, a, b);
    }
    store(2 * tig, m0 + gid, c[0]);
    store(2 * tig + 1, m0 + gid, c[1]);
    store(2 * tig, m0 + gid + 8, c[2]);
    store(2 * tig + 1, m0 + gid + 8, c[3]);
  }
}

// groups: int32 [G, 4] = (out_row, w_off, t_begin, t_end), one per (path, m3)
// terms:  int32 [T, 2] = (x_row, y_index) with coef[T] = cg * path_weight
// col_group: int32 [mid_dim], the group owning each output column
template <typename T, int V, bool kTf32>
__global__ void __launch_bounds__(kThreads) mb_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ emb,
    const int32_t* __restrict__ rel, const T* __restrict__ w1, const T* __restrict__ w2,
    const T* __restrict__ w_in, const int32_t* __restrict__ groups,
    const int32_t* __restrict__ terms, const T* __restrict__ coef,
    const int32_t* __restrict__ col_group, T* __restrict__ partial, int rows, int be, int dim_in,
    int sh_dim, int n_emb, int hidden, int wn, int mid_dim, int grid) {
  constexpr bool kT = smem_t(V);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_x = reinterpret_cast<T*>(smem_raw);  // every tile holds kTS x width elements
  T* s_y = s_x + kTS * dim_in;
  T* s_emb = s_y + kTS * sh_dim;
  T* s_h = s_emb + kTS * n_emb;
  T* s_w = s_h + kTS * hidden;
  T* s_msg = s_w + kTS * wn;
  __shared__ int s_rel[kEdgeTile];

  const int tid = threadIdx.x;
  T* part = partial + static_cast<int64_t>(blockIdx.x) * rows * mid_dim;
  for (int64_t i = tid; i < static_cast<int64_t>(rows) * mid_dim; i += blockDim.x) part[i] = T(0);

  for (int step = blockIdx.x; step < grid; step += gridDim.x) {
    for (int base = 0; base < be; base += kEdgeTile) {
      __syncthreads();  // the partial is zeroed; readers of the previous tile are done
      if (V == kDot) {
        if (tid < kEdgeTile) s_x[tid] = x[static_cast<int64_t>(base + tid) * dim_in];
      } else if (V != kMlp) {
        stage<kT, x_global_t(V)>(s_x, x, base, dim_in, be);
      }
      if (has_cg(V)) stage<kT, x_global_t(V)>(s_y, y, base, sh_dim, be);
      if (has_mlp(V)) stage<kT, false>(s_emb, emb, base, n_emb, be);
      if (V == kCgT) stage<kT, true>(s_w, w_in, base, wn, be);
      if (has_scatter(V) && tid < kEdgeTile) s_rel[tid] = rel[base + tid];
      __syncthreads();

      if constexpr (has_mlp(V)) {
        auto w1_at = [&](int t, int i) {  // W1[i, t]
          return w_global_t(V) ? w1[t * n_emb + i] : w1[i * hidden + t];
        };
        auto w2_at = [&](int j, int t) {  // W2[t, j]
          return w_global_t(V) ? w2[static_cast<int64_t>(j) * hidden + t] : w2[static_cast<int64_t>(t) * wn + j];
        };
        if constexpr (kTf32) {
          mma_tile_product<kT>(hidden, n_emb, w1_at, s_emb, [&](int e, int t, float a) {
            s_h[tix<kT>(e, t, hidden)] = a * sigmoid(a);
          });
          __syncthreads();
          mma_tile_product<kT>(wn, hidden, w2_at, s_h, [&](int e, int j, float v) {
            s_w[tix<kT>(e, j, wn)] = v;
          });
        } else {
          // hidden layer: h = silu(emb . W1)
          for (int t = tid; t < hidden; t += blockDim.x) {
            T acc[kEdgeTile];
#pragma unroll
            for (int e = 0; e < kEdgeTile; ++e) acc[e] = T(0);
            for (int i = 0; i < n_emb; ++i) {
              const T wv = w1_at(t, i);
#pragma unroll
              for (int e = 0; e < kEdgeTile; ++e) acc[e] += s_emb[tix<kT>(e, i, n_emb)] * wv;
            }
#pragma unroll
            for (int e = 0; e < kEdgeTile; ++e) s_h[tix<kT>(e, t, hidden)] = acc[e] * sigmoid(acc[e]);
          }
          __syncthreads();
          // radial weights: w = h . W2
          for (int j = tid; j < wn; j += blockDim.x) {
            T acc[kEdgeTile];
#pragma unroll
            for (int e = 0; e < kEdgeTile; ++e) acc[e] = T(0);
            for (int t = 0; t < hidden; ++t) {
              const T wv = w2_at(j, t);
#pragma unroll
              for (int e = 0; e < kEdgeTile; ++e) acc[e] += s_h[tix<kT>(e, t, hidden)] * wv;
            }
#pragma unroll
            for (int e = 0; e < kEdgeTile; ++e) s_w[tix<kT>(e, j, wn)] = acc[e];
          }
        }
        __syncthreads();
        if (V == kMlp && base == 0)
          for (int j = tid; j < wn; j += blockDim.x) part[j] += s_w[tix<kT>(0, j, wn)];
      }

      if constexpr (has_cg(V)) {
        // each thread owns its output columns: no races, fixed edge order
        for (int o = tid; o < mid_dim; o += blockDim.x) {
          const int32_t* gr = groups + 4 * col_group[o];
          const int u = o - gr[0];
          const int w_col = gr[1] + u;
          const int t0 = gr[2];
          const int t1 = gr[3];
          for (int e = 0; e < kEdgeTile; ++e) {
            T m = T(0);
            for (int k = t0; k < t1; ++k)
              m += coef[k] * s_y[tix<kT>(e, terms[2 * k + 1], sh_dim)] *
                   s_x[tix<kT>(e, terms[2 * k] + u, dim_in)];
            const T we = V == kCg ? s_x[tix<kT>(e, 0, dim_in)] : s_w[tix<kT>(e, w_col, wn)];
            const T msg = we * m;
            if (has_scatter(V)) {
              part[static_cast<int64_t>(s_rel[e]) * mid_dim + o] += msg;
            } else {
              s_msg[tix<kT>(e, o, mid_dim)] = msg;
              if (base == 0 && e == 0 && (V == kCg || o == 0)) part[o] += msg;
            }
          }
        }
      }

      if (V == kDot) {
        for (int o = tid; o < mid_dim; o += blockDim.x)
          for (int e = 0; e < kEdgeTile; ++e) part[static_cast<int64_t>(s_rel[e]) * mid_dim + o] += s_x[e];
      }
      if (V == kXpose && base == 0 && tid == 0) part[0] += s_x[tix<kT>(0, 0, dim_in)];
    }
  }
}

// out[i] = sum over blocks b, in order, of partial[b, i]
template <typename T>
__global__ void mb_reduce_kernel(const T* __restrict__ partial, T* __restrict__ out, int n_blocks, int64_t n) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    T acc = T(0);
    for (int b = 0; b < n_blocks; ++b) acc += partial[b * n + i];
    out[i] = acc;
  }
}

template <typename T, int V, bool kTf32>
cudaError_t launch_variant(const void* x, const void* y, const void* emb, const void* rel,
                           const void* w1, const void* w2, const void* w_in, const void* groups,
                           const void* terms, const void* coef, const void* col_group,
                           void* partial, int rows, int be, int dim_in, int sh_dim, int n_emb,
                           int hidden, int wn, int mid_dim, int grid, int n_blocks,
                           cudaStream_t stream) {
  const size_t smem =
      sizeof(T) * kTS * static_cast<size_t>(dim_in + sh_dim + n_emb + hidden + wn + mid_dim);
  cudaError_t err = allow_dynamic_smem(mb_fwd_kernel<T, V, kTf32>, smem);
  if (err != cudaSuccess) return err;
  mb_fwd_kernel<T, V, kTf32><<<n_blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const T*>(emb),
      static_cast<const int32_t*>(rel), static_cast<const T*>(w1), static_cast<const T*>(w2),
      static_cast<const T*>(w_in), static_cast<const int32_t*>(groups),
      static_cast<const int32_t*>(terms), static_cast<const T*>(coef),
      static_cast<const int32_t*>(col_group), static_cast<T*>(partial), rows, be, dim_in, sh_dim,
      n_emb, hidden, wn, mid_dim, grid);
  return cudaGetLastError();
}

template <typename T, bool kTf32>
cudaError_t dispatch(int variant, const void* x, const void* y, const void* emb, const void* rel,
                     const void* w1, const void* w2, const void* w_in, const void* groups,
                     const void* terms, const void* coef, const void* col_group, void* partial,
                     int rows, int be, int dim_in, int sh_dim, int n_emb, int hidden, int wn,
                     int mid_dim, int grid, int n_blocks, cudaStream_t stream) {
#define NEQUIP_MB_CASE(V)                                                                        \
  case V:                                                                                        \
    return launch_variant<T, V, kTf32>(x, y, emb, rel, w1, w2, w_in, groups, terms, coef,       \
                                       col_group, partial, rows, be, dim_in, sh_dim, n_emb,     \
                                       hidden, wn, mid_dim, grid, n_blocks, stream);
  switch (variant) {
    NEQUIP_MB_CASE(kDot)
    NEQUIP_MB_CASE(kMlp)
    NEQUIP_MB_CASE(kCg)
    NEQUIP_MB_CASE(kFull)
    NEQUIP_MB_CASE(kXpose)
    NEQUIP_MB_CASE(kCgT)
    NEQUIP_MB_CASE(kFullT)
    NEQUIP_MB_CASE(kFullTPre)
    default:
      return cudaErrorInvalidValue;
  }
#undef NEQUIP_MB_CASE
}

template <typename T>
int launch_mb_fwd(const void* x, const void* y, const void* emb, const void* rel, const void* w1,
                  const void* w2, const void* w_in, const void* groups, const void* terms,
                  const void* coef, const void* col_group, void* partial, void* out, int rows,
                  int be, int dim_in, int sh_dim, int n_emb, int hidden, int wn, int mid_dim,
                  int grid, int n_blocks, int variant, int tf32, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (be % kEdgeTile != 0 || n_blocks < 1 || n_blocks > grid) return cudaErrorInvalidValue;
  cudaError_t err;
  if (tf32) {
    if constexpr (std::is_same<T, float>::value) {
      // m16n8k8 tiles: hidden and WN in 16-row tiles, n_emb and hidden in 8-deep steps
      if (hidden % 16 || wn % 16 || n_emb % 8) return cudaErrorInvalidValue;
      err = dispatch<T, true>(variant, x, y, emb, rel, w1, w2, w_in, groups, terms, coef,
                              col_group, partial, rows, be, dim_in, sh_dim, n_emb, hidden, wn,
                              mid_dim, grid, n_blocks, s);
    } else {
      return cudaErrorInvalidValue;  // TF32 has no f64 form
    }
  } else {
    err = dispatch<T, false>(variant, x, y, emb, rel, w1, w2, w_in, groups, terms, coef,
                             col_group, partial, rows, be, dim_in, sh_dim, n_emb, hidden, wn,
                             mid_dim, grid, n_blocks, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = static_cast<int64_t>(rows) * mid_dim;
  mb_reduce_kernel<T><<<static_cast<int>((n + 255) / 256), 256, 0, s>>>(
      static_cast<const T*>(partial), static_cast<T*>(out), n_blocks, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mb
}  // namespace nequip

#define NEQUIP_MB_FWD(SUFFIX, T)                                                                 \
  extern "C" int nequip_mb_fwd_##SUFFIX(                                                        \
      const void* x, const void* y, const void* emb, const void* rel, const void* w1,           \
      const void* w2, const void* w_in, const void* groups, const void* terms, const void* coef, \
      const void* col_group, void* partial, void* out, int rows, int be, int dim_in,            \
      int sh_dim, int n_emb, int hidden, int wn, int mid_dim, int grid, int n_blocks,           \
      int variant, int tf32, void* stream) {                                                    \
    return nequip::mb::launch_mb_fwd<T>(x, y, emb, rel, w1, w2, w_in, groups, terms, coef,      \
                                        col_group, partial, out, rows, be, dim_in, sh_dim,      \
                                        n_emb, hidden, wn, mid_dim, grid, n_blocks, variant,    \
                                        tf32, stream);                                          \
  }

NEQUIP_MB_FWD(f32, float)
NEQUIP_MB_FWD(f64, double)
