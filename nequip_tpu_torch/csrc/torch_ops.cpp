// The registered ops nequip_torch::{conv_fwd, conv_bwd, scatter_rows, tri_fwd,
// tri_bwd} (K1, K2's inference variant, K3, K4 and K5's inference variant)
// in C++, for a process that does not import nequip_tpu_torch: a program
// exported by nequip-torch-compile calls these ops, and an artifact compiled
// on the card carries this library (ops/kernels/build.py links it with the
// kernels' objects into libnequip_ops_<hash>.so) so that torch.ops.load_library
// alone makes its programs runnable (tools/standalone_artifact_consumer.py).
//
// Replaces no TPU kernel: it binds the existing kernels a second time.  The
// schemas are those of the Python ops (ops/kernels/tp_scatter.py, checked as
// text by tests/test_torch_port_consumer.py), and each CUDA kernel below
// makes the launch that op's Python CUDA kernel makes: the same C entry
// point, the same tile query (nequip_*_tile, cached per kernel, device, dtype
// and widths), carry rows over every edge slot, outputs zeroed where the
// Python op zeroes them, the same bf16 K3 geometry, on PyTorch's current
// stream, each launch's error checked.  So its outputs are bitwise the
// package's.  The Meta kernels give the output shapes; the exported programs
// hold their forces already traced, so no autograd kernel is registered.
//
// Built with torch/library.h and the ATen/c10 headers it needs, not
// torch/extension.h, which would add minutes to every build.

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/zeros.h>
#include <c10/core/DeviceGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <algorithm>
#include <cstdint>
#include <initializer_list>
#include <map>
#include <mutex>
#include <string>
#include <tuple>
#include <vector>

#include "scatter_geometry.h"  // bf16 K3's geometry, and its C entry

#define NEQUIP_DECLARE(SUFFIX)                                                                                  \
  int nequip_conv_fwd_tile_##SUFFIX(int, int, int, int, int, int);                                              \
  int nequip_conv_fwd_##SUFFIX(const void*, const void*, const void*, const void*, const void*, const void*,     \
                               const void*, const void*, const void*, const void*, const void*, void*, void*,    \
                               int, int, int, int, int, int, int, int, int, double, double, void*);              \
  int nequip_conv_bwd_##SUFFIX(const void*, const void*, const void*, const void*, const void*, const void*,     \
                               const void*, const void*, const void*, const void*, const void*, const void*,     \
                               const void*, const void*, const void*, const void*, void*, void*, void*, int, int, \
                               int, int, int, int, int, int, double, double, void*);                             \
  int nequip_tri_fwd_tile_##SUFFIX(int, int, int, int);                                                          \
  int nequip_tri_fwd_##SUFFIX(const void*, const void*, const void*, const void*, const void*, const void*,      \
                              const void*, const void*, const void*, void*, void*, int, int, int, int, int, int,  \
                              int, void*);                                                                       \
  int nequip_tri_bwd_##SUFFIX(const void*, const void*, const void*, const void*, const void*, const void*,      \
                              const void*, const void*, const void*, const void*, const void*, const void*,      \
                              const void*, void*, void*, void*, int, int, int, int, int, int, void*);

extern "C" {
NEQUIP_DECLARE(f32)
NEQUIP_DECLARE(f64)
NEQUIP_DECLARE(bf16)
int nequip_scatter_rows_f32(const void*, const void*, const void*, void*, int, int, void*);
int nequip_scatter_rows_f64(const void*, const void*, const void*, void*, int, int, void*);
int nequip_scatter_rows_bf16(const void*, const void*, const void*, void*, int, int, int, int, int, void*);
}

namespace {

using at::Tensor;

// the entry points of one dtype
struct Entries {
  decltype(&nequip_conv_fwd_tile_f32) conv_fwd_tile;
  decltype(&nequip_conv_fwd_f32) conv_fwd;
  decltype(&nequip_conv_bwd_f32) conv_bwd;
  decltype(&nequip_tri_fwd_tile_f32) tri_fwd_tile;
  decltype(&nequip_tri_fwd_f32) tri_fwd;
  decltype(&nequip_tri_bwd_f32) tri_bwd;
};

#define NEQUIP_ENTRIES(SUFFIX)                                                                        \
  Entries {                                                                                           \
    nequip_conv_fwd_tile_##SUFFIX, nequip_conv_fwd_##SUFFIX, nequip_conv_bwd_##SUFFIX,                \
        nequip_tri_fwd_tile_##SUFFIX, nequip_tri_fwd_##SUFFIX, nequip_tri_bwd_##SUFFIX                \
  }

const Entries& entries(at::ScalarType dtype) {
  static const Entries f32 = NEQUIP_ENTRIES(f32), f64 = NEQUIP_ENTRIES(f64), bf16 = NEQUIP_ENTRIES(bf16);
  switch (dtype) {
    case at::kFloat: return f32;
    case at::kDouble: return f64;
    case at::kBFloat16: return bf16;
    default: TORCH_CHECK(false, "nequip_torch: kernels are instantiated for float32, float64 and bfloat16, not ",
                         dtype);
  }
}

// the dtype the kernels sum in (tp_scatter.acc_dtype): float32 for bfloat16 operands
at::ScalarType acc_dtype(at::ScalarType dtype) { return dtype == at::kBFloat16 ? at::kFloat : dtype; }

void* stream_of(const Tensor& t) { return c10::cuda::getCurrentCUDAStream(t.get_device()).stream(); }

void check_launch(int err, const char* name) {
  TORCH_CHECK(err == 0, "CUDA kernel ", name, " failed to launch: cudaError ", err);
}

// operands: one CUDA device and one float dtype, contiguous (tp_scatter._route)
void check_operands(const char* name, std::initializer_list<Tensor> ts) {
  const Tensor& first = *ts.begin();
  TORCH_CHECK(first.is_cuda(), name, ": no kernel for device ", first.device());
  for (const Tensor& t : ts) {
    TORCH_CHECK(t.device() == first.device() && t.scalar_type() == first.scalar_type(), name,
                ": inputs must share one device and dtype");
    TORCH_CHECK(t.is_contiguous(), name, ": inputs must be contiguous");
  }
}

// edge layout tensors (tp_scatter._check_index)
void check_index(const Tensor& like, std::initializer_list<Tensor> ts) {
  for (const Tensor& t : ts)
    TORCH_CHECK(t.device() == like.device() && t.scalar_type() == at::kInt && t.is_contiguous(),
                "edge layout tensors must be contiguous int32 on the kernel's device");
}

// the plan's term tables, in TABLE_NAMES order
struct Tables {
  const Tensor &fwd_groups, &fwd_terms, &fwd_coef, &fwd_col, &dx_groups, &dx_terms, &dx_coef, &dx_col, &paths,
      &path_terms, &path_coef;

  // int32 index tables and coefficients in acc_dtype, contiguous on the inputs' device (tp_scatter._check_coefs)
  void check(const char* name, const Tensor& like) const {
    for (const Tensor* t : {&fwd_coef, &dx_coef, &path_coef})
      TORCH_CHECK(t->device() == like.device() && t->scalar_type() == acc_dtype(like.scalar_type()) &&
                      t->is_contiguous(),
                  name, ": the term tables' coefficients must be contiguous ", acc_dtype(like.scalar_type()),
                  " on the inputs' device");
    check_index(like, {fwd_groups, fwd_terms, fwd_col, dx_groups, dx_terms, dx_col, paths, path_terms});
  }
};

#define TABLE_PARAMS                                                                                          \
  const Tensor &fwd_groups, const Tensor &fwd_terms, const Tensor &fwd_coef, const Tensor &fwd_col,           \
      const Tensor &dx_groups, const Tensor &dx_terms, const Tensor &dx_coef, const Tensor &dx_col,           \
      const Tensor &paths, const Tensor &path_terms, const Tensor &path_coef
#define TABLE_ARGS                                                                                            \
  fwd_groups, fwd_terms, fwd_coef, fwd_col, dx_groups, dx_terms, dx_coef, dx_col, paths, path_terms, path_coef

int cdiv(int64_t a, int64_t b) { return static_cast<int>((a + b - 1) / b); }

// rows of K1's and K4's carry buffer (tp_scatter.conv_fwd_carry_rows), over every edge slot
int64_t carry_rows(int64_t n_edges, int tile, at::ScalarType dtype) {
  return static_cast<int64_t>(cdiv(n_edges, tile)) * (dtype == at::kBFloat16 ? 4 : 1);
}

// edges per tile of kernel `name` at `widths`, asked of the library once per
// (kernel, device, dtype, widths) (tp_scatter._tile)
template <typename Query>
int tile_of(const char* name, const Tensor& x, std::vector<int> widths, Query query) {
  using Key = std::tuple<std::string, int, int, std::vector<int>>;
  static std::mutex mu;
  static std::map<Key, int> tiles;
  const Key key{name, x.get_device(), static_cast<int>(x.scalar_type()), widths};
  std::lock_guard<std::mutex> lock(mu);
  auto it = tiles.find(key);
  if (it != tiles.end()) return it->second;
  const int tile = query();
  if (tile < 0) check_launch(-tile, name);
  TORCH_CHECK(tile != 0, name, ": no edge tile fits in shared memory at the given widths in ", x.scalar_type());
  tiles.emplace(key, tile);
  return tile;
}

// --- K1 ------------------------------------------------------------------------------------
Tensor conv_fwd_cuda(const Tensor& x, const Tensor& sh, const Tensor& emb, const Tensor& w1, const Tensor& w2,
                     const Tensor& edge_src, const Tensor& dst_ptr, const Tensor& src_perm, const Tensor& src_ptr,
                     TABLE_PARAMS, double alpha0, double alpha1) {
  check_operands("conv_fwd", {x, sh, emb, w1, w2});
  const Tables tab{TABLE_ARGS};
  tab.check("conv_fwd", x);
  check_index(x, {edge_src, dst_ptr, src_perm, src_ptr});
  c10::DeviceGuard guard(x.device());
  const Entries& e = entries(x.scalar_type());
  const int n_emb = w1.size(0), hidden = w1.size(1), num_nodes = dst_ptr.size(0) - 1, dim_in = x.size(1),
            sh_dim = sh.size(1), wn = w2.size(1), mid_dim = fwd_col.size(0), n_terms = fwd_coef.size(0);
  const int tile = tile_of("conv_fwd", x, {dim_in, sh_dim, n_emb, hidden, wn, n_terms},
                           [&] { return e.conv_fwd_tile(dim_in, sh_dim, n_emb, hidden, wn, n_terms); });
  Tensor out = at::empty({num_nodes, mid_dim}, x.options());
  Tensor carry = at::empty({carry_rows(edge_src.size(0), tile, x.scalar_type()), mid_dim},
                           x.options().dtype(acc_dtype(x.scalar_type())));
  check_launch(e.conv_fwd(x.data_ptr(), sh.data_ptr(), emb.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                          edge_src.data_ptr(), dst_ptr.data_ptr(), fwd_groups.data_ptr(), fwd_terms.data_ptr(),
                          fwd_coef.data_ptr(), fwd_col.data_ptr(), out.data_ptr(), carry.data_ptr(), num_nodes,
                          dim_in, sh_dim, n_emb, hidden, wn, mid_dim, n_terms, tile, alpha0, alpha1, stream_of(x)),
               "conv_fwd");
  return out;
}

// --- K2, inference variant -------------------------------------------------------------------
std::tuple<Tensor, Tensor, Tensor> conv_bwd_cuda(const Tensor& x, const Tensor& sh, const Tensor& emb,
                                                 const Tensor& w1, const Tensor& w2, const Tensor& g,
                                                 const Tensor& edge_src, const Tensor& dst_ptr, TABLE_PARAMS,
                                                 double alpha0, double alpha1) {
  check_operands("conv_bwd", {x, sh, emb, w1, w2, g});
  const Tables tab{TABLE_ARGS};
  tab.check("conv_bwd", x);
  check_index(x, {edge_src, dst_ptr});
  c10::DeviceGuard guard(x.device());
  const int n_emb = w1.size(0), hidden = w1.size(1), num_nodes = dst_ptr.size(0) - 1, dim_in = x.size(1),
            sh_dim = sh.size(1), wn = w2.size(1), mid_dim = g.size(1);
  const Tensor w2t = w2.t().contiguous();
  // the kernel writes the real slots only, and their count stays on the device
  Tensor dx_edge = at::zeros({sh.size(0), dim_in}, x.options());
  Tensor dsh = at::zeros(sh.sizes(), sh.options());
  Tensor demb = at::zeros(emb.sizes(), emb.options());
  check_launch(entries(x.scalar_type())
                   .conv_bwd(x.data_ptr(), sh.data_ptr(), emb.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                             w2t.data_ptr(), edge_src.data_ptr(), dst_ptr.data_ptr(), g.data_ptr(),
                             dx_groups.data_ptr(), dx_terms.data_ptr(), dx_coef.data_ptr(), dx_col.data_ptr(),
                             paths.data_ptr(), path_terms.data_ptr(), path_coef.data_ptr(), dx_edge.data_ptr(),
                             dsh.data_ptr(), demb.data_ptr(), static_cast<int>(paths.size(0)), num_nodes, dim_in,
                             sh_dim, n_emb, hidden, wn, mid_dim, alpha0, alpha1, stream_of(x)),
               "conv_bwd");
  return {dx_edge, dsh, demb};
}

// --- K3 --------------------------------------------------------------------------------------
Tensor scatter_rows_cuda(const Tensor& values, const Tensor& perm, const Tensor& ptr) {
  check_operands("scatter_rows", {values});
  for (const Tensor* t : {&perm, &ptr})
    TORCH_CHECK(t->device() == values.device() && t->scalar_type() == at::kInt && t->is_contiguous(),
                "scatter_rows: perm and ptr must be contiguous int32 on the values' device");
  TORCH_CHECK(values.dim() == 2, "scatter_rows: values must be [M, D]");
  c10::DeviceGuard guard(values.device());
  const int n_rows = ptr.size(0) - 1, d = values.size(1);
  Tensor out = at::empty({n_rows, d}, values.options());
  int err;
  switch (values.scalar_type()) {
    case at::kBFloat16: {
      const nequip::ScatterGeometry g =
          nequip::scatter_rows_geometry(d, reinterpret_cast<uintptr_t>(values.data_ptr()) % 16 == 0);
      err = nequip_scatter_rows_bf16(values.data_ptr(), perm.data_ptr(), ptr.data_ptr(), out.data_ptr(), n_rows, d,
                                     g.vec, g.lanes, g.per_lane, stream_of(values));
      break;
    }
    case at::kFloat:
      err = nequip_scatter_rows_f32(values.data_ptr(), perm.data_ptr(), ptr.data_ptr(), out.data_ptr(), n_rows, d,
                                    stream_of(values));
      break;
    case at::kDouble:
      err = nequip_scatter_rows_f64(values.data_ptr(), perm.data_ptr(), ptr.data_ptr(), out.data_ptr(), n_rows, d,
                                    stream_of(values));
      break;
    default: TORCH_CHECK(false, "scatter_rows: no kernel for ", values.scalar_type());
  }
  check_launch(err, "scatter_rows");
  return out;
}

// --- K4 --------------------------------------------------------------------------------------
Tensor tri_fwd_cuda(const Tensor& x, const Tensor& y, const Tensor& w, const Tensor& edge_src, const Tensor& dst_ptr,
                    const Tensor& src_perm, const Tensor& src_ptr, TABLE_PARAMS) {
  check_operands("tri_fwd", {x, y, w});
  const Tables tab{TABLE_ARGS};
  tab.check("tri_fwd", x);
  check_index(x, {edge_src, dst_ptr, src_perm, src_ptr});
  c10::DeviceGuard guard(x.device());
  const Entries& e = entries(x.scalar_type());
  const int num_nodes = dst_ptr.size(0) - 1, dim_in = x.size(1), sh_dim = y.size(1), wn = w.size(1),
            mid_dim = fwd_col.size(0), n_terms = fwd_coef.size(0);
  const int tile = tile_of("tri_fwd", x, {dim_in, sh_dim, wn, n_terms},
                           [&] { return e.tri_fwd_tile(dim_in, sh_dim, wn, n_terms); });
  Tensor out = at::empty({num_nodes, mid_dim}, x.options());
  // carry rows over all edge slots: the real-edge count stays on the device
  Tensor carry = at::empty({carry_rows(y.size(0), tile, x.scalar_type()), mid_dim},
                           x.options().dtype(acc_dtype(x.scalar_type())));
  check_launch(e.tri_fwd(x.data_ptr(), y.data_ptr(), w.data_ptr(), edge_src.data_ptr(), dst_ptr.data_ptr(),
                         fwd_groups.data_ptr(), fwd_terms.data_ptr(), fwd_coef.data_ptr(), fwd_col.data_ptr(),
                         out.data_ptr(), carry.data_ptr(), n_terms, num_nodes, dim_in, sh_dim, wn, mid_dim, tile,
                         stream_of(x)),
               "nequip_tri_fwd");
  return out;
}

// --- K5, inference variant -------------------------------------------------------------------
std::tuple<Tensor, Tensor, Tensor> tri_bwd_cuda(const Tensor& x, const Tensor& y, const Tensor& w, const Tensor& g,
                                                const Tensor& edge_src, const Tensor& dst_ptr, TABLE_PARAMS) {
  check_operands("tri_bwd", {x, y, w, g});
  const Tables tab{TABLE_ARGS};
  tab.check("tri_bwd", x);
  check_index(x, {edge_src, dst_ptr});
  c10::DeviceGuard guard(x.device());
  // zeroed whole: the kernel writes the real slots, whose count stays on the device
  Tensor dx_edge = at::zeros({y.size(0), x.size(1)}, x.options());
  Tensor dy = at::zeros({y.size(0), y.size(1)}, x.options());
  Tensor dw = at::zeros({y.size(0), w.size(1)}, x.options());
  check_launch(entries(x.scalar_type())
                   .tri_bwd(x.data_ptr(), y.data_ptr(), w.data_ptr(), edge_src.data_ptr(), dst_ptr.data_ptr(),
                            g.data_ptr(), dx_groups.data_ptr(), dx_terms.data_ptr(), dx_coef.data_ptr(),
                            dx_col.data_ptr(), paths.data_ptr(), path_terms.data_ptr(), path_coef.data_ptr(),
                            dx_edge.data_ptr(), dy.data_ptr(), dw.data_ptr(), static_cast<int>(paths.size(0)),
                            static_cast<int>(dst_ptr.size(0) - 1), static_cast<int>(x.size(1)),
                            static_cast<int>(y.size(1)), static_cast<int>(w.size(1)),
                            static_cast<int>(fwd_col.size(0)), stream_of(x)),
               "tri_bwd");
  return {dx_edge, dy, dw};
}

// --- output shapes ---------------------------------------------------------------------------
Tensor conv_fwd_meta(const Tensor& x, const Tensor&, const Tensor&, const Tensor&, const Tensor&, const Tensor&,
                     const Tensor& dst_ptr, const Tensor&, const Tensor&, TABLE_PARAMS, double, double) {
  return at::empty({dst_ptr.size(0) - 1, fwd_col.size(0)}, x.options());
}

std::tuple<Tensor, Tensor, Tensor> conv_bwd_meta(const Tensor& x, const Tensor& sh, const Tensor& emb, const Tensor&,
                                                 const Tensor&, const Tensor&, const Tensor&, const Tensor&,
                                                 TABLE_PARAMS, double, double) {
  return {at::empty({sh.size(0), x.size(1)}, x.options()), at::empty(sh.sizes(), sh.options()),
          at::empty(emb.sizes(), emb.options())};
}

Tensor scatter_rows_meta(const Tensor& values, const Tensor&, const Tensor& ptr) {
  return at::empty({ptr.size(0) - 1, values.size(1)}, values.options());
}

Tensor tri_fwd_meta(const Tensor& x, const Tensor&, const Tensor&, const Tensor&, const Tensor& dst_ptr,
                    const Tensor&, const Tensor&, TABLE_PARAMS) {
  return at::empty({dst_ptr.size(0) - 1, fwd_col.size(0)}, x.options());
}

std::tuple<Tensor, Tensor, Tensor> tri_bwd_meta(const Tensor& x, const Tensor& y, const Tensor& w, const Tensor&,
                                                const Tensor&, const Tensor&, TABLE_PARAMS) {
  return {at::empty({y.size(0), x.size(1)}, x.options()), at::empty(y.sizes(), y.options()),
          at::empty(w.sizes(), w.options())};
}

}  // namespace

// the Python ops' schemas (tp_scatter.py: _MLP_SCHEMA, _LAYOUT_SCHEMA, _TABLES_SCHEMA, _TRI_SCHEMA)
#define NEQUIP_TABLES_SCHEMA                                                                                  \
  "Tensor fwd_groups, Tensor fwd_terms, Tensor fwd_coef, Tensor fwd_col, Tensor dx_groups, Tensor dx_terms, " \
  "Tensor dx_coef, Tensor dx_col, Tensor paths, Tensor path_terms, Tensor path_coef"
#define NEQUIP_LAYOUT_SCHEMA "Tensor edge_src, Tensor dst_ptr, Tensor src_perm, Tensor src_ptr"

TORCH_LIBRARY(nequip_torch, m) {
  m.def("conv_fwd(Tensor x, Tensor sh, Tensor emb, Tensor w1, Tensor w2, " NEQUIP_LAYOUT_SCHEMA
        ", " NEQUIP_TABLES_SCHEMA ", float alpha0, float alpha1) -> Tensor");
  m.def("conv_bwd(Tensor x, Tensor sh, Tensor emb, Tensor w1, Tensor w2, Tensor g, Tensor edge_src, "
        "Tensor dst_ptr, " NEQUIP_TABLES_SCHEMA ", float alpha0, float alpha1) -> (Tensor, Tensor, Tensor)");
  m.def("scatter_rows(Tensor values, Tensor perm, Tensor ptr) -> Tensor");
  m.def("tri_fwd(Tensor x, Tensor y, Tensor w, " NEQUIP_LAYOUT_SCHEMA ", " NEQUIP_TABLES_SCHEMA ") -> Tensor");
  m.def("tri_bwd(Tensor x, Tensor y, Tensor w, Tensor g, Tensor edge_src, Tensor dst_ptr, " NEQUIP_TABLES_SCHEMA
        ") -> (Tensor, Tensor, Tensor)");
}

TORCH_LIBRARY_IMPL(nequip_torch, CUDA, m) {
  m.impl("conv_fwd", &conv_fwd_cuda);
  m.impl("conv_bwd", &conv_bwd_cuda);
  m.impl("scatter_rows", &scatter_rows_cuda);
  m.impl("tri_fwd", &tri_fwd_cuda);
  m.impl("tri_bwd", &tri_bwd_cuda);
}

TORCH_LIBRARY_IMPL(nequip_torch, Meta, m) {
  m.impl("conv_fwd", &conv_fwd_meta);
  m.impl("conv_bwd", &conv_bwd_meta);
  m.impl("scatter_rows", &scatter_rows_meta);
  m.impl("tri_fwd", &tri_fwd_meta);
  m.impl("tri_bwd", &tri_bwd_meta);
}
