// bf16 K3's launch geometry from the row width and the values' alignment
// alone, the rule of tp_scatter.scatter_rows_geometry in C++, for the ops
// library (torch_ops.cpp).  16-byte loads (8 values) where both allow, else
// 2-byte ones; then the lanes a row that cover it in the fewest passes,
// leave the fewest of a warp's vector slots idle, then hold fewer vectors a
// lane, then fewer lanes.
//
// The plain C entry nequip_scatter_rows_geometry exposes the rule, so that
// it can be held to the Python one (tests/test_torch_port_scatter_rows.py
// compiles this header on its own).  It is defined here: include this header
// in one translation unit only.

#ifndef NEQUIP_SCATTER_GEOMETRY_H
#define NEQUIP_SCATTER_GEOMETRY_H

#include <algorithm>
#include <tuple>

namespace nequip {

struct ScatterGeometry {
  int vec, lanes, per_lane;
};

inline ScatterGeometry scatter_rows_geometry(int d, bool aligned) {
  constexpr int kMaxPerLane = 4;  // scatter_rows.cu kScatterMaxK
  auto cdiv = [](int a, int b) { return (a + b - 1) / b; };
  const int vec = aligned && d % 8 == 0 ? 8 : 1, nv = d / vec;
  ScatterGeometry best{vec, 0, 0};
  std::tuple<int, double, int, int> best_key;
  for (int lanes = 1; lanes <= 32; ++lanes) {
    const int per_lane = std::max(1, std::min(cdiv(nv, lanes), kMaxPerLane));
    const int passes = std::max(1, cdiv(nv, lanes * per_lane));
    const double used = static_cast<double>(nv * (32 / lanes)) / (32 * per_lane * passes);
    const std::tuple<int, double, int, int> key{passes, -used, per_lane, lanes};
    if (best.lanes == 0 || key < best_key) best = ScatterGeometry{vec, lanes, per_lane}, best_key = key;
  }
  return best;
}

}  // namespace nequip

// writes {vec, lanes, per_lane} for rows of d values into geometry
extern "C" void nequip_scatter_rows_geometry(int d, int aligned, int* geometry) {
  const nequip::ScatterGeometry g = nequip::scatter_rows_geometry(d, aligned != 0);
  geometry[0] = g.vec;
  geometry[1] = g.lanes;
  geometry[2] = g.per_lane;
}

#endif  // NEQUIP_SCATTER_GEOMETRY_H
