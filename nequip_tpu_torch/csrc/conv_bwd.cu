// K2: first-order backward of the fused convolution (K1): the per-edge
// cotangents that the forces need and, in the training variant, the per-edge
// factors of the radial-MLP weight gradients.
//
// Replaces the TPU kernel nequip_tpu/ops/pallas/tp_scatter.py,
// _make_fused_mlp.kernel_bwd (kernel body _bwd_mlp_kernel_T, CG-VJP block
// _compute_tp_bwd_block_T).  For each edge e (source s, destination n) with
// the node cotangent g = dL/dout[n]:
//   recompute h_pre = alpha0 * emb_e . W1, h = silu(h_pre), w = alpha1 * h . W2
//   dx_e[x_row + u]  = sum_terms w[w_off + u] * c * sh_e[y] * g[out_row + u]
//   A[p, m2, u]      = sum_terms of path p with m2  c * x[s, x_row + u] * g[out_row + u]
//   dW_e[w_off + u]  = sum_m2 sh_e[y_off + m2] * A[p, m2, u]
//   dsh_e[y_off + m2] = sum_{p, u} w[w_off + u] * A[p, m2, u]
//   dh_pre = alpha1 * (dW_e . W2^T) * silu'(h_pre),  demb_e = alpha0 * dh_pre . W1^T
// dx_e goes to an [E, dim_in] buffer that K3 (scatter_rows.cu) sums onto the
// source nodes.  The TPU kernel also accumulates dW1/dW2 over all edges by
// carrying them across its sequential grid; Hopper's blocks run in no order,
// so the training variant (nequip_conv_bwd_train) instead writes the per-edge
// dW_e [E, WN], h_e [E, hidden] and dh_pre_e [E, hidden], and dw_reduce.cu
// forms dW2 = alpha1 * sum_e h_e (x) dW_e, dW1 = alpha0 * sum_e emb_e (x)
// dh_pre_e in a second, fixed-order pass.  The inference variant passes null
// pointers: like the TPU kernel it keeps w, dW_e and the hidden layer in
// shared memory and writes no per-edge [E, WN] or [E, hidden] buffer.
//
// What bounds it on an H100 (flagship, 23k atoms, 419,904 edges, f32):
// operations, the radial MLP's two products with W2 (2 x 2 x 128 x WN FMAs
// per edge, WN = 96 / 352 / 96) and the CG-VJP, 2.03 ms over the three
// layers at 67 TFLOP/s of FFMA; its bytes (x[src], the dx write) take less.
// The first design, one block per destination node stepping 8 edges at a time,
// took 30.55 ms: ~18-edge segments left its tiles 75% full, the MLP loops ran
// half the block and re-read W2 and W2^T from L2 for every 8 edges.
// Design (dense edge tiles):
// - A block takes TILE = 32 consecutive real slots of the dst-sorted stream,
//   across node boundaries, on a persistent grid of (SMs x resident blocks)
//   that walks the ceil(n_real / TILE) tiles (n_real = dst_ptr[n_nodes] is
//   read on the card, so the entry point needs no edge count).  Each edge's
//   destination is its own binary search in dst_ptr, so any degree
//   distribution (empty nodes, segments longer than a tile, a tile boundary
//   inside a segment) is the same case; g rows are read through L1, where the
//   tile's few destinations stay.
// - The radial MLP is two block GEMMs on the tile (radial_mlp.cuh): h =
//   silu(alpha0 emb . W1) straight from shared memory (K = n_emb), then
//   w = alpha1 h . W2 and, after the CG-VJP, dh = dW_e . W2^T (from w2t) with
//   W2 / W2^T streamed in 16-row slabs through a 3-stage cp.async ring and
//   reused by every edge of the tile; 4 x 4 register micro-tiles per thread.
//   h_pre is recomputed (n_emb FMAs, in the same order) where silu' needs it.
// - The CG-VJP (cg_vjp.cuh, shared with K5 and K7) runs over (8-edge group,
//   32-column block) items for dx and (8-edge group, path) items for dW_e
//   and dsh, lanes over channels, each term's table entry read once for 8
//   edges, whose x and g loads are in flight together (a g value once where
//   the 8 edges share a destination).  TPPlan sorts each path's terms by m2,
//   so A[p, m2] is one run of terms, folded into dW_e and into the dsh
//   partial (a reduce-scatter over the channels) when the run ends; the
//   (group, path) items go to the warps heaviest path first.
// - dW_e overwrites w in shared memory in place (one thread reads w[e][j]
//   before it writes dW_e[e][j]; dx is done by then), and the dsh partials
//   share the ring's memory, so a 32-edge f32 tile of layer 1 needs ~97 KB
//   and two blocks share an SM, registers capped at 128 for them.  Where two
//   tiles do not fit an SM (f64 of layer 1: ~169 KB), one block an SM keeps
//   up to 255 registers.  Tiles of 16 or 8 edges are taken when a shape does
//   not fit one block (f64 of wide models).
// - Every output element is written by one thread from sums in a fixed
//   order: two calls give bitwise equal results.
// Measured (H100 80GB HBM3, 700 W; PERF.md, K2 findings): 2.4 / 6.8 / 2.4 ms for
// the three layers, ~5.7x its bound (PR 7; since the shared CG-VJP of PR 9
// about 8% less, PERF.md PR 9).  clock64 marks per phase (PR 7, layer 1,
// cycles per tile of one block, two blocks an SM): the CG-VJP ~47% (dW_e
// and dsh 88k, dx 30k; short runs of ~2.4 terms, each ending in 8 shuffle
// reductions, and L2 latency), the two GEMMs ~41% (~50% of FFMA issue with
// 16 warps an SM and a barrier per 16-row slab), the hidden layer, the
// destination search and demb the rest.  Tried and slower or no faster:
// 64-edge tiles, 16-edge CG items (they spill), the tile's g rows and half
// its x rows staged in shared memory (one block an SM then, or extra
// barriers), an L2 prefetch of the tile's rows, 32-row slabs, 4 stages, and
// the column-split GEMM layout noted in radial_mlp.cuh.
// Registers and spills (nvcc -Xptxas -v, 32-edge tiles): f32 128 (two blocks
// an SM), 8 bytes of spill; f64 one block an SM 255, 12 bytes (two blocks:
// 128, 88-272 bytes); PERF.md lists every tile.
#include "cg_vjp.cuh"
#include "dense_tiles.cuh"
#include "radial_mlp.cuh"

namespace nequip {
namespace {

constexpr int kBwdWarps = 8;  // K2's own block: 256 threads
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kBwdBK = 16;    // W2 rows per slab of the ring
constexpr int kBwdStages = 3;
constexpr int kCgEdges = 8;  // edges of one CG-VJP item: its loads per term in flight

template <typename T>
struct ConvBwdArgs {
  const T *x, *sh, *emb, *w1, *w2, *w2t;
  const int32_t *edge_src, *dst_ptr;
  const T* g;
  const int32_t *dx_groups, *dx_terms;
  const T* dx_coef;
  const int32_t *dx_col_group, *paths, *path_terms;
  const T* path_coef;
  T *dx_edge, *dsh, *demb, *dw_edge, *h_edge, *dh_edge;
  int n_paths, n_nodes, dim_in, sh_dim, n_emb, hidden, wn, mid_dim;
  T alpha0, alpha1;
};

// Shared-memory carve-up of one tile, in elements of T from the base (every
// region starts on 16 bytes), then two int32 [TILE] arrays and int32
// [n_paths] (the paths' order of cg::order_paths).
struct BwdSmem {
  int ldw, ldh, ldw1;  // row strides of s_w [TILE][ldw], s_h [TILE][ldh], s_w1 [n_emb][ldw1]
  int o_h, o_ring, o_emb, o_y, o_w1, o_idx;
  size_t bytes;
};

template <typename T>
__host__ __device__ inline BwdSmem bwd_smem(int tile, int wn, int hidden, int n_emb, int sh_dim, int n_paths) {
  constexpr int V = mlp::Vec<T>::V, CW = 32 * V;
  BwdSmem L;
  L.ldw = mlp::round_up(wn, CW);          // whole column chunks: the w GEMM writes them
  L.ldh = mlp::round_up(hidden, CW) + V;  // + 16 bytes: the demb loop's rows fall on other banks
  L.ldw1 = mlp::round_up(hidden, V) + V;  // 16-byte rows; the demb loop's 8 rows of W1 fall on other banks
  int o = tile * L.ldw;
  L.o_h = o;
  o += tile * L.ldh;
  L.o_ring = o;  // the ring, or the dsh partials [TILE][n_paths][kMaxYDim] between the GEMMs
  const int ring = mlp::ring_elems<T, kBwdBK, kBwdStages>(), part = tile * n_paths * kMaxYDim;
  o += mlp::round_up(ring > part ? ring : part, V);
  L.o_emb = o;
  o += mlp::round_up(tile * n_emb, V);
  L.o_y = o;
  o += mlp::round_up(tile * sh_dim, V);
  L.o_w1 = o;
  o += mlp::round_up(n_emb * L.ldw1, V);
  L.o_idx = o;
  L.bytes = static_cast<size_t>(o) * sizeof(T) + sizeof(int32_t) * (2 * tile + n_paths);
  return L;
}

template <typename T, int TILE, int MIN_BLOCKS>
__global__ void __launch_bounds__(kBwdThreads, MIN_BLOCKS) conv_bwd_kernel(const ConvBwdArgs<T> a) {
  constexpr int NW = kBwdWarps, NT = kBwdThreads, TE = TILE / 8, V = mlp::Vec<T>::V;  // TE: rows a thread owns in the GEMMs
  constexpr int TC = TILE < kCgEdges ? TILE : kCgEdges;  // edges per CG item
  static_assert(NW == 8 && TILE % 8 == 0 && TILE % TC == 0, "tile_gemm takes 8 warps with whole rows each");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hidden = a.hidden, wn = a.wn, n_emb = a.n_emb, sh_dim = a.sh_dim, dim_in = a.dim_in;
  const int mid_dim = a.mid_dim, n_paths = a.n_paths;
  const BwdSmem L = bwd_smem<T>(TILE, wn, hidden, n_emb, sh_dim, n_paths);
  T* base_t = reinterpret_cast<T*>(smem_raw);
  T* s_w = base_t;                 // [TILE][ldw]: w, then dW_e in place
  T* s_h = base_t + L.o_h;         // [TILE][ldh]: h, then dh_pre
  T* s_ring = base_t + L.o_ring;   // the W2 / W2^T ring
  T* s_dshp = s_ring;              // [TILE][n_paths][kMaxYDim], between the GEMMs
  T* s_emb = base_t + L.o_emb;     // [TILE][n_emb]
  T* s_y = base_t + L.o_y;         // [TILE][sh_dim]
  T* s_w1 = base_t + L.o_w1;       // [n_emb][ldw1]
  int32_t* s_src = reinterpret_cast<int32_t*>(base_t + L.o_idx);  // [TILE]
  int32_t* s_dst = s_src + TILE;                                  // [TILE]
  int32_t* s_order = s_dst + TILE;                                // [n_paths]

  const cg::Tables<T> tab{a.dx_groups, a.dx_terms, a.dx_coef, a.dx_col_group, a.paths, a.path_terms,
                          a.path_coef, n_paths};
  const int tid = threadIdx.x;
  const int n_real = __ldg(a.dst_ptr + a.n_nodes);
  const int n_tiles = mlp::cdiv(n_real, TILE);
  if (static_cast<int>(blockIdx.x) >= n_tiles) return;
  for (int i = tid; i < n_emb * hidden; i += NT) s_w1[(i / hidden) * L.ldw1 + i % hidden] = a.w1[i];
  cg::order_paths(tab, s_order);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int base = tile * TILE;
    const int cnt = min(TILE, n_real - base);
    __syncthreads();  // s_w1 is staged; the previous tile's readers are done
    if (tid < TILE) {
      const bool real = tid < cnt;  // rows past cnt compute finite values that are not written
      s_src[tid] = real ? __ldg(a.edge_src + base + tid) : 0;
      s_dst[tid] = find_dst(a.dst_ptr, a.n_nodes, base + min(tid, cnt - 1));  // sorted, as cg_vjp.cuh needs
    }
    for (int i = tid; i < TILE * n_emb; i += NT)
      s_emb[i] = i < cnt * n_emb ? a.emb[static_cast<int64_t>(base) * n_emb + i] : T(0);
    for (int i = tid; i < TILE * sh_dim; i += NT)
      s_y[i] = i < cnt * sh_dim ? a.sh[static_cast<int64_t>(base) * sh_dim + i] : T(0);
    __syncthreads();

    // hidden layer h = silu(h_pre), V columns of one edge per step, zero in the padding columns
    for (int i = tid; i < TILE * (L.ldh / V); i += NT) {
      const int e = i / (L.ldh / V), t0 = (i - e * (L.ldh / V)) * V;
      T hp[V] = {};
      if (t0 < hidden) mlp::hidden_pre(s_emb + e * n_emb, s_w1 + t0, L.ldw1, n_emb, a.alpha0, hp);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int t = t0 + j;
        T v = T(0);
        if (t < hidden) {
          v = hp[j] * sigmoid(hp[j]);
          if (a.h_edge != nullptr && e < cnt) a.h_edge[static_cast<int64_t>(base + e) * hidden + t] = v;
        }
        s_h[e * L.ldh + t] = v;
      }
    }
    // w = alpha1 * h . W2 (tile_gemm starts at a barrier: s_h is complete)
    mlp::tile_gemm<T, TILE, kBwdBK, kBwdStages>(
        s_h, L.ldh, a.w2, hidden, wn, s_ring, [&](int r0, int c0, T (&acc)[TE][V]) {
#pragma unroll
          for (int i = 0; i < TE; ++i) {
            T v[V];
#pragma unroll
            for (int j = 0; j < V; ++j) v[j] = a.alpha1 * acc[i][j];
            store16(s_w + (r0 + i) * L.ldw + c0, v);
          }
        });

    // the CG-VJP (cg_vjp.cuh): dx, then dW_e in place of w and the dsh partials, then dsh
    for (int i = tid; i < TILE * n_paths * kMaxYDim; i += NT) s_dshp[i] = T(0);
    const cg::GRows<T, false> gr{a.g, 0, mid_dim};
    cg::dx_items<T, TILE, TC, NW>(tab, gr, s_dst, s_y, sh_dim, s_w, L.ldw, cnt, dim_in,
                                  a.dx_edge + static_cast<int64_t>(base) * dim_in);
    __syncthreads();  // dx has read w; the dsh partials are zero
    cg::dw_items<T, TILE, TC, NW>(
        tab, s_order, cg::XRows<T, false>{a.x, s_src, dim_in}, gr, s_dst, s_y, sh_dim, s_w, L.ldw, cnt, s_dshp,
        a.dw_edge == nullptr ? nullptr : a.dw_edge + static_cast<int64_t>(base) * wn, wn);
    __syncthreads();
    cg::path_sum<T, NT>(tab, s_dshp, cnt, sh_dim, a.dsh + static_cast<int64_t>(base) * sh_dim);
    // dh_pre = alpha1 * (dW_e . W2^T) * silu'(h_pre), W2^T is [wn, hidden]
    // (tile_gemm starts at a barrier: the dsh partials are read, the ring is free)
    mlp::tile_gemm<T, TILE, kBwdBK, kBwdStages>(
        s_w, L.ldw, a.w2t, wn, hidden, s_ring, [&](int r0, int c0, T (&acc)[TE][V]) {
#pragma unroll
          for (int i = 0; i < TE; ++i) {
            const int e = r0 + i;
            T hp[V] = {};
            if (c0 < hidden) mlp::hidden_pre(s_emb + e * n_emb, s_w1 + c0, L.ldw1, n_emb, a.alpha0, hp);
#pragma unroll
            for (int j = 0; j < V; ++j) {
              const int t = c0 + j;
              T v = T(0);
              if (t < hidden) {
                const T sg = sigmoid(hp[j]);
                v = a.alpha1 * acc[i][j] * (sg * (T(1) + hp[j] * (T(1) - sg)));
                if (a.dh_edge != nullptr && e < cnt) a.dh_edge[static_cast<int64_t>(base + e) * hidden + t] = v;
              }
              s_h[e * L.ldh + t] = v;
            }
          }
        });
    // demb = alpha0 * dh_pre . W1^T (tile_gemm ended at a barrier: dh_pre is complete)
    for (int i = tid; i < cnt * n_emb; i += NT) {
      const int e = i / n_emb, c = i - e * n_emb;
      const T* he = s_h + e * L.ldh;
      const T* wc = s_w1 + c * L.ldw1;
      T acc = T(0);
      for (int t = 0; t < hidden; ++t) acc += he[t] * wc[t];
      a.demb[static_cast<int64_t>(base) * n_emb + i] = a.alpha0 * acc;
    }
  }
}

// One tile shape launched on the persistent grid (dense_tiles.cuh).
template <typename T, int TILE, int MIN_BLOCKS>
cudaError_t launch_tile(const ConvBwdArgs<T>& args, int dev, size_t smem, cudaStream_t stream) {
  auto kernel = conv_bwd_kernel<T, TILE, MIN_BLOCKS>;
  int grid = 0;
  const cudaError_t err = persistent_grid(kernel, kBwdThreads, dev, smem, grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kBwdThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

// The largest tile whose shared memory fits one block.  The 32-edge tile
// caps registers at 128 for two blocks an SM only where two fit in shared
// memory (f32 at the flagship's widths); where one fits (f64), it keeps
// all 255 and spills nothing.
template <typename T>
int launch_conv_bwd(const ConvBwdArgs<T>& args, void* stream) {
  if (args.n_nodes <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t rows = args.n_nodes + 1;  // x and g offsets are int32
  if (rows * args.dim_in >= (int64_t{1} << 31) || rows * args.mid_dim >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  SmemLimits lim;
  const cudaError_t err = smem_limits(lim);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto smem = [&](int tile) {
    return bwd_smem<T>(tile, args.wn, args.hidden, args.n_emb, args.sh_dim, args.n_paths).bytes;
  };
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lim.fit(smem(32), 1)) {
    if (lim.fit(smem(32), 2)) return static_cast<int>(launch_tile<T, 32, 2>(args, lim.dev, smem(32), s));
    return static_cast<int>(launch_tile<T, 32, 1>(args, lim.dev, smem(32), s));
  }
  if (lim.fit(smem(16), 1)) return static_cast<int>(launch_tile<T, 16, 1>(args, lim.dev, smem(16), s));
  return static_cast<int>(launch_tile<T, 8, 1>(args, lim.dev, smem(8), s));  // refused if it does not fit either
}

}  // namespace
}  // namespace nequip

#define NEQUIP_CONV_BWD(SUFFIX, T)                                                                               \
  extern "C" int nequip_conv_bwd_train_##SUFFIX(                                                                \
      const void* x, const void* sh, const void* emb, const void* w1, const void* w2, const void* w2t,          \
      const void* edge_src, const void* dst_ptr, const void* g, const void* dx_groups, const void* dx_terms,     \
      const void* dx_coef, const void* dx_col_group, const void* paths, const void* path_terms,                 \
      const void* path_coef, void* dx_edge, void* dsh, void* demb, void* dw_edge, void* h_edge, void* dh_edge,   \
      int n_paths, int n_nodes, int dim_in, int sh_dim, int n_emb, int hidden, int wn, int mid_dim,              \
      double alpha0, double alpha1, void* stream) {                                                             \
    const nequip::ConvBwdArgs<T> args{                                                                          \
        static_cast<const T*>(x),           static_cast<const T*>(sh),                                          \
        static_cast<const T*>(emb),         static_cast<const T*>(w1),                                          \
        static_cast<const T*>(w2),          static_cast<const T*>(w2t),                                         \
        static_cast<const int32_t*>(edge_src), static_cast<const int32_t*>(dst_ptr),                            \
        static_cast<const T*>(g),           static_cast<const int32_t*>(dx_groups),                             \
        static_cast<const int32_t*>(dx_terms), static_cast<const T*>(dx_coef),                                  \
        static_cast<const int32_t*>(dx_col_group), static_cast<const int32_t*>(paths),                         \
        static_cast<const int32_t*>(path_terms), static_cast<const T*>(path_coef),                              \
        static_cast<T*>(dx_edge),           static_cast<T*>(dsh),                                               \
        static_cast<T*>(demb),              static_cast<T*>(dw_edge),                                           \
        static_cast<T*>(h_edge),            static_cast<T*>(dh_edge),                                           \
        n_paths, n_nodes, dim_in, sh_dim, n_emb, hidden, wn, mid_dim,                                           \
        static_cast<T>(alpha0),             static_cast<T>(alpha1)};                                            \
    return nequip::launch_conv_bwd<T>(args, stream);                                                            \
  }                                                                                                             \
  extern "C" int nequip_conv_bwd_##SUFFIX(                                                                      \
      const void* x, const void* sh, const void* emb, const void* w1, const void* w2, const void* w2t,          \
      const void* edge_src, const void* dst_ptr, const void* g, const void* dx_groups, const void* dx_terms,     \
      const void* dx_coef, const void* dx_col_group, const void* paths, const void* path_terms,                 \
      const void* path_coef, void* dx_edge, void* dsh, void* demb, int n_paths, int n_nodes, int dim_in,        \
      int sh_dim, int n_emb, int hidden, int wn, int mid_dim, double alpha0, double alpha1, void* stream) {     \
    return nequip_conv_bwd_train_##SUFFIX(x, sh, emb, w1, w2, w2t, edge_src, dst_ptr, g, dx_groups, dx_terms,   \
                                          dx_coef, dx_col_group, paths, path_terms, path_coef, dx_edge, dsh,    \
                                          demb, nullptr, nullptr, nullptr, n_paths, n_nodes, dim_in, sh_dim,    \
                                          n_emb, hidden, wn, mid_dim, alpha0, alpha1, stream);                  \
  }

NEQUIP_CONV_BWD(f32, float)
NEQUIP_CONV_BWD(f64, double)
