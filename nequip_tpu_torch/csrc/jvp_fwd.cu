// K6: the trilinear convolution and its tangent in one pass, the forward of
// the fr dual sweep.
//
// Replaces the TPU kernel nequip_tpu/ops/pallas/tp_scatter.py, _jvp_forward
// (kernel body _jvp_kernel_T, CG block _compute_tp_jvp_block_T,
// pallas_call at :2118).  With F(x, y, w) = scatter_dst(TP(x[src], y, w))
// (K4, tri_fwd.cu) it computes
//   msg  = F(x, y, w)
//   tmsg = F(tx, y, w) + F(x, ty, w) + F(x, y, dw)
// for node features x and their tangent tx [N, dim_in], per-edge SH y and
// tangent ty [E, sh_dim], radial weights w and tangent dw [E, WN].  Per edge
// e (source s, destination n) and output column (path, m3, u):
//   m  = sum_terms c * y_e[yi] * x[s, x_row + u]
//   tm = sum_terms c * (ty_e[yi] * x[s, x_row + u] + y_e[yi] * tx[s, x_row + u])
//   msg[n]  += w_e  * m
//   tmsg[n] += w_e * tm + dw_e * m
// so the products of each CG term are shared between the primal and the
// three tangent terms, as in _compute_tp_jvp_block_T.  The _acc entry points
// add onto [N, mid_dim] accumulators in place (one slice of the edge-chunked
// sweep; K4-acc in tri_fwd.cu states the slice contract).
//
// What bounds it on an H100: bytes, the x[src] and tx[src] gathers and the
// w/dw reads (419,904 x (2 x 288 + 2 x 352) x 4 B ~ 2.1 GB in layer 1 at
// 23k atoms, f32; a quarter of that on one of the fr sweep's 4 slices).
// The first design was K4's first: one block per destination node,
// 8 edges a step, the term table re-read for every column.
// Design: K4's (tri_fwd.cu) with two of every operand, on the pieces of
// cg_fwd.cuh (cg_forward_jvp).  Tiles of TILE real slots on a persistent
// grid; each tile stages x[src] and tx[src] rows, y, ty, w and dw rows by
// cp.async (at each operand's 16-byte phase), forms c * y and c * ty per
// (term, edge) once, and each thread keeps m and tm of its column for every
// edge of the tile in registers.  Destinations split across tiles as in K4:
// carry rows [ceil(n_real / TILE)][2][mid_dim] and a second launch
// (finish_split_rows) summing both outputs' parts in tile order; no
// atomics, bitwise repeatable.  Owner-computes was timed too and was slower
// (1.44 against 0.96-0.97 ms on one of 4 fr slices, PERF.md).  Shared
// memory (f32, layer 1): a 16-edge tile ~92 KB, two blocks an SM (0.60 ms;
// 32-edge tiles at one block 0.71, 8-edge 0.73), so 16 is taken (f64: 8).
// f64 tiles stop at 16 edges: m and tm of 32 f64 edges are 128 registers
// (so f64 layer 0, 16-edge tiles of 32 columns, is slower than the first
// design: 0.31 against 0.25 ms).
// Measured (chip_smoke.py phase 2; H100 80GB HBM3, 700 W; PERF.md):
// f32 on one of 4 slices 0.19 / 0.66 / 0.20 ms for the three layers, 4.3x
// the bound (1.24 before, same call).
// Registers (nvcc -Xptxas -v): f32 125-128 at two blocks an SM (8-edge
// tiles 103, 4-edge 96); f64 122-128; no spills.  Four blocks an SM (K4's
// choice in the narrow layers) gained K6 at most ~0.03 ms there, inside
// the noise, so K6 keeps two.
//
// bf16 (nequip_jvp_fwd_bf16, nequip_jvp_fwd_acc_bf16): the six operands
// are bf16 in device memory, and so are msg and tmsg; the _acc form's two
// accumulators are float32.  Every product and sum is taken in float32;
// msg and tmsg are both compensated sums (hi + lo,
// cg_forward_jvp_compensated), split destinations wait in float32 carry
// rows [n_tiles][2][2][2][mid_dim] (slot, hi/lo, msg/tmsg: cg_fwd.cuh
// carry_slots) and the second launch adds them in tile order.  Each output
// is rounded once (the _acc form: added onto its float32 accumulator,
// rounded to float32 once; tp_scatter.ChunkedJvpConv rounds the
// accumulators to bf16 after the last slice), as in K4's bf16 form
// (tri_fwd.cu).  The plain version (tp_scatter.jvp_fwd_plain) rounds at
// the same points.  Design (the first bf16 form ran the f32 design on
// float32 tiles, widened as staged, in 16-edge tiles: its walk spilled at
// 32; 1.648 ms on one of 4 slices against f32's 0.971):
// - As K4's bf16 form: x[src], tx[src], y, ty, w and dw stay bf16 in shared
//   memory, staged raw by cp.async (jvp_fwd_smem in elements of S), c * y
//   and c * ty float32 tiles, each value widened where it is read; every
//   output is the float32-tile form's bit for bit (chip_cg_profile.py
//   --fwd --dtype bf16 --parent).
// - The walk forms m and tm kWalkPart = 8 edges at a time (rolled loop),
//   under an 80-register cap (kMinBlocks = 3): 32-edge tiles, three blocks
//   an SM in layers 0 and 2, two in layer 1, where a tile takes 104 KB.
// - Launch shapes tried (chip_cg_profile.py --fwd --dtype bf16, K6 on one
//   of 4 slices, the three layers summed; H100 80GB HBM3, 700 W): 32 edges
//   under the 3-block cap, parts of 8: 0.947-0.984 ms; parts of 16 (32
//   bytes of spill) 1.044-1.048; 32 at two blocks (128 registers) parts of
//   8: 1.039-1.091, parts of 16 1.086, the whole tile 1.431 (116 bytes of
//   spill); 16 at four blocks 1.029-1.054; 16 at two 1.267.
// - Registers (nvcc -Xptxas -v): 78-80 under the cap, 96-104 for 4-edge
//   tiles at one block; no spills.
// Measured (chip_cg_profile.py --fwd --dtype bf16 --parent, both builds in
// turns in one process; H100 80GB HBM3, 700 W): 1.648 -> 0.984 ms on one of
// 4 slices over the three layers (f32, in another run:
// 0.971), the _acc form 1.582 -> 0.976 (f32 1.010).  Layer 1, cycles per
// tile of thread 0 (this: 32-edge tiles; the parent: 16): staging,
// destinations and y 11.8k (24.6k), the CG phase 54.1k (28.2k), of which
// the products 25.3k (9.1k) and the compensated walk 28.4k (18.7k).
#include <type_traits>

#include "cg_fwd.cuh"
#include "dense_tiles.cuh"

namespace nequip {
namespace {

// S: the storage type of the operands and outputs; the kernel computes in
// T = Acc<S> (tp_common.cuh), the type of the tables, the carry rows and
// the _acc form's accumulators
template <typename S>
struct JvpFwdArgs {
  using T = Acc<S>;
  const S *x, *tx, *y, *ty, *w, *dw;
  const int32_t *edge_src, *dst_ptr;
  cgf::Tables<T> tab;
  void *out, *tout;  // [N, mid_dim] of S, or the _acc form's accumulators of T
  T* carry;
  int n_nodes, dim_in, sh_dim, wn, mid_dim;
};

// Shared-memory carve-up, in elements of S (the operand tiles' storage
// type; 16-byte phases of V = 16 / sizeof(S) elements): w, dw [TILE][wn] and
// y, ty [TILE][sh_dim] (each with room for a 16-byte phase), x, tx
// [TILE][dim_in], c * y, c * ty [n_terms][TILE] of T = Acc<S>, then int32
// s_dst [TILE] and two flags.
struct JvpFwdSmem {
  int o_dw, o_y, o_ty, o_x, o_tx, o_cy, o_cty, o_idx;
  size_t bytes;
};

template <typename T, typename S = T>
__host__ __device__ inline JvpFwdSmem jvp_fwd_smem(int tile, int dim_in, int sh_dim, int wn, int n_terms) {
  constexpr int V = 16 / sizeof(S);
  constexpr int R = static_cast<int>(sizeof(T) / sizeof(S));  // elements of S a value of T takes
  auto up = [](int a) { return (a + V - 1) / V * V; };
  JvpFwdSmem L;
  L.o_dw = up(tile * wn + V - 1);
  L.o_y = L.o_dw + up(tile * wn + V - 1);
  L.o_ty = L.o_y + up(tile * sh_dim + V - 1);
  L.o_x = L.o_ty + up(tile * sh_dim + V - 1);
  L.o_tx = L.o_x + up(tile * dim_in);
  L.o_cy = L.o_tx + up(tile * dim_in);
  L.o_cty = L.o_cy + up(tile * n_terms * R);
  L.o_idx = L.o_cty + up(tile * n_terms * R);
  L.bytes = static_cast<size_t>(L.o_idx) * sizeof(S) + sizeof(int32_t) * (tile + 2);
  return L;
}

// bf16: the edges whose column products (m and tm) a thread holds at once
// (the compensated walk runs over the tile part by part)
constexpr int kWalkPart = 8;

template <int TILE>
constexpr int kPart = TILE < kWalkPart ? TILE : kWalkPart;

template <typename S, int TILE, bool kAcc, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS) jvp_fwd_kernel(const JvpFwdArgs<S> a) {
  using T = Acc<S>;  // c * y, c * ty, registers and sums; the operand tiles are S
  using O = typename std::conditional<kAcc, T, S>::type;
  constexpr bool kRound = !std::is_same<S, T>::value;  // bf16: compensated sums, rounded once (see the header)
  constexpr int NT = kThreads;
  static_assert(TILE <= 32, "one warp finds the destinations");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dim_in = a.dim_in, sh_dim = a.sh_dim, wn = a.wn, mid_dim = a.mid_dim;
  const JvpFwdSmem L = jvp_fwd_smem<T, S>(TILE, dim_in, sh_dim, wn, a.tab.n_terms);
  S* base_s = reinterpret_cast<S*>(smem_raw);
  S* s_x = base_s + L.o_x;                              // [TILE][dim_in]
  S* s_tx = base_s + L.o_tx;                            // [TILE][dim_in]
  T* s_cy = reinterpret_cast<T*>(base_s + L.o_cy);    // [n_terms][TILE]
  T* s_cty = reinterpret_cast<T*>(base_s + L.o_cty);  // [n_terms][TILE]
  int32_t* s_dst = reinterpret_cast<int32_t*>(base_s + L.o_idx);  // [TILE]
  int32_t* s_flags = s_dst + TILE;  // [0]: where segments end in the tile; [1]: the last one continues
  O* const out = static_cast<O*>(a.out);
  O* const tout = static_cast<O*>(a.tout);

  const int tid = threadIdx.x;
  const int n_real = __ldg(a.dst_ptr + a.n_nodes);
  const int n_tiles = (n_real + TILE - 1) / TILE;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int base = tile * TILE, cnt = min(TILE, n_real - base);
    const int64_t oy = static_cast<int64_t>(base) * sh_dim, ow = static_cast<int64_t>(base) * wn;
    __syncthreads();  // the previous tile's readers are done
    stage_flat<S, NT>(base_s + L.o_y, a.y + oy, cnt * sh_dim, TILE * sh_dim, tid);
    stage_flat<S, NT>(base_s + L.o_ty, a.ty + oy, cnt * sh_dim, TILE * sh_dim, tid);
    cp_async_commit();
    stage_flat<S, NT>(base_s, a.w + ow, cnt * wn, TILE * wn, tid);
    stage_flat<S, NT>(base_s + L.o_dw, a.dw + ow, cnt * wn, TILE * wn, tid);
    stage_rows<S, TILE, NT>(s_x, a.x, a.edge_src + base, cnt, dim_in, tid);
    stage_rows<S, TILE, NT>(s_tx, a.tx, a.edge_src + base, cnt, dim_in, tid);
    cp_async_commit();
    if (tid < 32) cgf::tile_segments<TILE>(a.dst_ptr, a.n_nodes, base, cnt, s_dst, s_flags);  // warp 0
    cp_async_wait<1>();  // y and ty have landed
    __syncthreads();
    cgf::scale_y<T, TILE, NT>(a.tab, base_s + L.o_y + staged_phase<S>(a.y + oy), sh_dim, s_cy, tid);
    cgf::scale_y<T, TILE, NT>(a.tab, base_s + L.o_ty + staged_phase<S>(a.ty + oy), sh_dim, s_cty, tid);
    cp_async_wait<0>();
    __syncthreads();

    const S* const s_w = base_s + staged_phase<S>(a.w + ow);
    const S* const s_dw = base_s + L.o_dw + staged_phase<S>(a.dw + ow);
    const unsigned ends = static_cast<unsigned>(s_flags[0]);
    if constexpr (!kRound) {
      // a last segment that continues into the next tile goes to this tile's carry rows (msg, then tmsg)
      T* const carry_row = s_flags[1] ? a.carry + static_cast<int64_t>(tile) * 2 * mid_dim : nullptr;
      cgf::cg_forward_jvp<T, TILE, NT>(a.tab, s_cy, s_cty, s_x, s_tx, dim_in, s_w, s_dw, wn, mid_dim, ends,
                                       [&](int o, int e, T v, T tv) {
                                         const int64_t at = static_cast<int64_t>(s_dst[e]) * mid_dim + o;
                                         if (e == cnt - 1 && carry_row != nullptr) {
                                           carry_row[o] = v;
                                           carry_row[mid_dim + o] = tv;
                                         } else if (kAcc) {
                                           out[at] += v;
                                           tout[at] += tv;
                                         } else {
                                           out[at] = v;
                                           tout[at] = tv;
                                         }
                                       });
    } else {
      // bf16: segments that another tile shares to the carry slots, every
      // other one rounded once into out and tout, or added onto the accumulators
      const auto slots = cgf::carry_slots<2>(a.dst_ptr, s_dst, s_flags, a.carry, tile, base, mid_dim);
      cgf::cg_forward_jvp_compensated<TILE, NT, kPart<TILE>>(
          a.tab, s_cy, s_cty, s_x, s_tx, dim_in, s_w, s_dw, wn, mid_dim, ends,
          [&](int o, int e, const SumF32x2& v, const SumF32x2& tv) {
            const int64_t at = static_cast<int64_t>(s_dst[e]) * mid_dim + o;
            if (T* const row = slots.at(e, cnt)) {
              slots.put(row, 0, o, v);
              slots.put(row, 1, o, tv);
            } else if constexpr (kAcc) {
              out[at] = add_onto(out[at], v);
              tout[at] = add_onto(tout[at], tv);
            } else {
              out[at] = bf16_of_sum(v.hi, v.lo);
              tout[at] = bf16_of_sum(tv.hi, tv.lo);
            }
          });
    }
  }
}

template <typename S, int TILE, bool kAcc, int MIN_BLOCKS>
cudaError_t launch_tile(const JvpFwdArgs<S>& args, int dev, size_t smem, cudaStream_t stream) {
  auto kernel = jvp_fwd_kernel<S, TILE, kAcc, MIN_BLOCKS>;
  int grid = 0;
  const cudaError_t err = persistent_grid(kernel, kThreads, dev, smem, grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

// m and tm of 32 f64 edges would take 128 registers: f64 tiles stop at 16
// (f32 and bf16, whose walk holds kWalkPart edges' products at a time, at 32)
template <typename S>
constexpr int kTopTile = std::is_same<S, double>::value ? 16 : 32;

// The register cap of the tile kernels (MIN_BLOCKS of the 2-block shapes):
// bf16 takes 80 registers, three blocks an SM where their shared memory
// fits (layers 0 and 2), else two under the same cap (measured faster than
// 128 registers at two blocks, with 8-edge parts)
template <typename S>
constexpr int kMinBlocks = std::is_same<S, __nv_bfloat16>::value ? 3 : 2;

// The launch shape: the first of 32- (f32 and bf16), 16-, 8- and 4-edge
// tiles whose shared memory lets two blocks share an SM, else 4-edge tiles
// at one block an SM; tile 0 if none fits.
struct Shape {
  int tile, blocks;
};

template <typename S>
Shape pick_shape(const SmemLimits& lim, int dim_in, int sh_dim, int wn, int n_terms) {
  using T = Acc<S>;
  for (const int tile : {32, 16, 8, 4})
    if (tile <= kTopTile<S> && lim.fit(jvp_fwd_smem<T, S>(tile, dim_in, sh_dim, wn, n_terms).bytes, 2))
      return {tile, 2};
  return {lim.fit(jvp_fwd_smem<T, S>(4, dim_in, sh_dim, wn, n_terms).bytes, 1) ? 4 : 0, 1};
}

// The kernel of launch shape sh
template <typename S, bool kAcc>
cudaError_t launch_shape(const JvpFwdArgs<S>& a, Shape sh, int dev, size_t smem, cudaStream_t s) {
  constexpr int B = kMinBlocks<S>;
  if (sh.tile == 32) return launch_tile<S, kTopTile<S>, kAcc, B>(a, dev, smem, s);
  if (sh.tile == 16) return launch_tile<S, 16, kAcc, B>(a, dev, smem, s);
  if (sh.tile == 8) return launch_tile<S, 8, kAcc, B>(a, dev, smem, s);
  if (sh.blocks == 2) return launch_tile<S, 4, kAcc, B>(a, dev, smem, s);
  return launch_tile<S, 4, kAcc, 1>(a, dev, smem, s);
}

// Tile kernel, then the finish kernel.  `tile` must be pick_shape's (the
// caller sized carry by it: [ceil(n_real / tile), 2 * mid_dim], bf16
// [ceil(n_real / tile) * 4, 2 * mid_dim] of float32).
template <typename S, bool kAcc>
int launch_jvp_fwd(const JvpFwdArgs<S>& a, int tile, void* stream) {
  using T = Acc<S>;
  if (a.n_nodes <= 0) return static_cast<int>(cudaGetLastError());
  SmemLimits lim;
  cudaError_t e = smem_limits(lim);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Shape sh = pick_shape<S>(lim, a.dim_in, a.sh_dim, a.wn, a.tab.n_terms);
  if (sh.tile == 0 || tile != sh.tile) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = jvp_fwd_smem<T, S>(tile, a.dim_in, a.sh_dim, a.wn, a.tab.n_terms).bytes;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = launch_shape<S, kAcc>(a, sh, lim.dev, smem, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  using O = typename std::conditional<kAcc, T, S>::type;
  O* const out = static_cast<O*>(a.out);
  O* const tout = static_cast<O*>(a.tout);
  if constexpr (std::is_same<S, T>::value)
    return static_cast<int>(cgf::launch_finish<T, 2, kAcc>(a.dst_ptr, a.carry, out, tout, a.n_nodes, a.mid_dim,
                                                           tile, s));
  else
    return static_cast<int>(cgf::launch_finish_compensated<S, 2, kAcc>(a.dst_ptr, a.carry, out, tout, a.n_nodes,
                                                                       a.mid_dim, tile, s));
}

// pick_shape's tile for the given widths on the current device; a CUDA error as -err
template <typename S>
int jvp_fwd_tile(int dim_in, int sh_dim, int wn, int n_terms) {
  SmemLimits lim;
  const cudaError_t err = smem_limits(lim);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return pick_shape<S>(lim, dim_in, sh_dim, wn, n_terms).tile;
}

}  // namespace
}  // namespace nequip

#define NEQUIP_JVP_FWD(NAME, SUFFIX, T, ACC)                                                                     \
  extern "C" int NAME##_##SUFFIX(const void* x, const void* tx, const void* y, const void* ty, const void* w,   \
                                 const void* dw, const void* edge_src, const void* dst_ptr, const void* groups,  \
                                 const void* terms, const void* coef, const void* col_group, void* out,          \
                                 void* tout, void* carry, int n_terms, int n_nodes, int dim_in, int sh_dim,      \
                                 int wn, int mid_dim, int tile, void* stream) {                                  \
    const nequip::JvpFwdArgs<T> args{                                                                            \
        static_cast<const T*>(x), static_cast<const T*>(tx), static_cast<const T*>(y),                           \
        static_cast<const T*>(ty), static_cast<const T*>(w), static_cast<const T*>(dw),                          \
        static_cast<const int32_t*>(edge_src), static_cast<const int32_t*>(dst_ptr),                             \
        {static_cast<const int32_t*>(groups), static_cast<const int32_t*>(terms),                                \
         static_cast<const nequip::Acc<T>*>(coef), static_cast<const int32_t*>(col_group), n_terms},             \
        out, tout, static_cast<nequip::Acc<T>*>(carry), n_nodes, dim_in, sh_dim, wn, mid_dim};                   \
    return nequip::launch_jvp_fwd<T, ACC>(args, tile, stream);                                                   \
  }

#define NEQUIP_JVP_FWD_TILE(SUFFIX, T)                                                              \
  extern "C" int nequip_jvp_fwd_tile_##SUFFIX(int dim_in, int sh_dim, int wn, int n_terms) {       \
    return nequip::jvp_fwd_tile<T>(dim_in, sh_dim, wn, n_terms);                                    \
  }

NEQUIP_JVP_FWD(nequip_jvp_fwd, f32, float, false)
NEQUIP_JVP_FWD(nequip_jvp_fwd, f64, double, false)
NEQUIP_JVP_FWD(nequip_jvp_fwd, bf16, __nv_bfloat16, false)
NEQUIP_JVP_FWD(nequip_jvp_fwd_acc, f32, float, true)
NEQUIP_JVP_FWD(nequip_jvp_fwd_acc, f64, double, true)
NEQUIP_JVP_FWD(nequip_jvp_fwd_acc, bf16, __nv_bfloat16, true)
NEQUIP_JVP_FWD_TILE(f32, float)
NEQUIP_JVP_FWD_TILE(f64, double)
NEQUIP_JVP_FWD_TILE(bf16, __nv_bfloat16)
