// Host cell-list neighbour list of the PyTorch port (nequip_tpu_torch).
//
// The port's own copy of the JAX package's C++ cell list
// (nequip_tpu/csrc/neighborlist.cpp), with the code unchanged.  It is built
// with g++ at first use by nequip_tpu_torch/data/_cpp_nl.py and called
// through ctypes with a plain C interface.  O(N) binned cell list for
// arbitrary triclinic cells, mixed periodic boundary conditions, and cells
// smaller than the cutoff (several periodic images through unwrapped bin
// indexing); positions need not be wrapped into the cell.
//
// Conventions match the framework: directed edges, edge_dst = center,
// edge_src = neighbor, vec = pos[src] - pos[dst] + shift @ cell.  Edges come
// out grouped by center, in increasing center order.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct V3 {
  double x, y, z;
};

inline V3 matvec_rowcell(const double* cell, double a, double b, double c) {
  // (a, b, c) @ cell with rows as lattice vectors
  return V3{a * cell[0] + b * cell[3] + c * cell[6],
            a * cell[1] + b * cell[4] + c * cell[7],
            a * cell[2] + b * cell[5] + c * cell[8]};
}

// inverse of a 3x3 (row-major); returns false if singular
bool invert3(const double* m, double* inv) {
  double det = m[0] * (m[4] * m[8] - m[5] * m[7]) -
               m[1] * (m[3] * m[8] - m[5] * m[6]) +
               m[2] * (m[3] * m[7] - m[4] * m[6]);
  if (std::fabs(det) < 1e-14) return false;
  double id = 1.0 / det;
  inv[0] = (m[4] * m[8] - m[5] * m[7]) * id;
  inv[1] = (m[2] * m[7] - m[1] * m[8]) * id;
  inv[2] = (m[1] * m[5] - m[2] * m[4]) * id;
  inv[3] = (m[5] * m[6] - m[3] * m[8]) * id;
  inv[4] = (m[0] * m[8] - m[2] * m[6]) * id;
  inv[5] = (m[2] * m[3] - m[0] * m[5]) * id;
  inv[6] = (m[3] * m[7] - m[4] * m[6]) * id;
  inv[7] = (m[1] * m[6] - m[0] * m[7]) * id;
  inv[8] = (m[0] * m[4] - m[1] * m[3]) * id;
  return true;
}

inline int64_t floordiv(int64_t a, int64_t b) {
  int64_t q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}
inline int64_t pymod(int64_t a, int64_t b) {
  int64_t r = a % b;
  return r < 0 ? r + b : r;
}

}  // namespace

extern "C" {

// Returns the number of edges, or -(needed) if max_edges was too small, or
// -1 on error.  For non-periodic directions, a synthetic bounding box is
// used internally; shifts stay zero there.
int64_t nequip_cell_list_nl(const double* pos, int64_t n_atoms,
                            const double* cell_in,  // 3x3 row-major or null
                            const int32_t* pbc,     // 3 flags (null = open)
                            double cutoff, int64_t max_edges,
                            int32_t* edge_dst, int32_t* edge_src,
                            double* shifts_out) {
  if (n_atoms <= 0) return 0;
  bool periodic[3] = {false, false, false};
  double cell[9];
  bool has_cell = cell_in != nullptr;
  if (has_cell && pbc != nullptr) {
    for (int d = 0; d < 3; ++d) periodic[d] = pbc[d] != 0;
  }
  if (!periodic[0] && !periodic[1] && !periodic[2]) has_cell = false;

  // synthetic orthorhombic box for open boundaries
  double lo[3] = {1e300, 1e300, 1e300}, hi[3] = {-1e300, -1e300, -1e300};
  for (int64_t i = 0; i < n_atoms; ++i) {
    for (int d = 0; d < 3; ++d) {
      double v = pos[3 * i + d];
      if (v < lo[d]) lo[d] = v;
      if (v > hi[d]) hi[d] = v;
    }
  }
  if (has_cell) {
    std::memcpy(cell, cell_in, 9 * sizeof(double));
    // extend non-periodic directions to cover all atoms generously; keep
    // the periodic lattice vectors exact
    for (int d = 0; d < 3; ++d) {
      if (!periodic[d]) {
        // replace row d with an axis-aligned vector spanning the extent
        double span = (hi[d] - lo[d]) + 2.0 * cutoff + 1.0;
        cell[3 * d + 0] = cell[3 * d + 1] = cell[3 * d + 2] = 0.0;
        cell[3 * d + d] = span;
      }
    }
  } else {
    std::memset(cell, 0, sizeof(cell));
    for (int d = 0; d < 3; ++d)
      cell[3 * d + d] = (hi[d] - lo[d]) + 2.0 * cutoff + 1.0;
  }

  double inv[9];
  if (!invert3(cell, inv)) return INT64_MIN;  // singular cell

  // plane spacings h_d = 1 / ||column d of inv|| (rows of inv transpose)
  double heights[3];
  for (int d = 0; d < 3; ++d) {
    double nx = inv[d], ny = inv[3 + d], nz = inv[6 + d];
    heights[d] = 1.0 / std::sqrt(nx * nx + ny * ny + nz * nz);
  }

  // bins per axis and search range in bins
  int64_t B[3];
  int64_t R[3];
  for (int d = 0; d < 3; ++d) {
    B[d] = (int64_t)std::floor(heights[d] / cutoff);
    if (B[d] < 1) B[d] = 1;
    if (B[d] > 64) B[d] = 64;  // cap bin count for memory
    double bin_h = heights[d] / (double)B[d];
    R[d] = (int64_t)std::ceil(cutoff / bin_h);
  }

  const int64_t n_bins = B[0] * B[1] * B[2];
  std::vector<int32_t> bin_head(n_bins, -1);
  std::vector<int32_t> next(n_atoms, -1);
  std::vector<double> frac(3 * n_atoms);
  std::vector<int64_t> bin_of(3 * n_atoms);

  // origin shift so fractional coords of open systems start at 0
  double origin[3] = {0.0, 0.0, 0.0};
  for (int d = 0; d < 3; ++d)
    if (!periodic[d]) origin[d] = lo[d] - cutoff - 0.5;

  for (int64_t i = 0; i < n_atoms; ++i) {
    double px = pos[3 * i] - origin[0] * (periodic[0] ? 0.0 : 1.0);
    double py = pos[3 * i + 1] - origin[1] * (periodic[1] ? 0.0 : 1.0);
    double pz = pos[3 * i + 2] - origin[2] * (periodic[2] ? 0.0 : 1.0);
    double fx = px * inv[0] + py * inv[3] + pz * inv[6];
    double fy = px * inv[1] + py * inv[4] + pz * inv[7];
    double fz = px * inv[2] + py * inv[5] + pz * inv[8];
    frac[3 * i] = fx;
    frac[3 * i + 1] = fy;
    frac[3 * i + 2] = fz;
    int64_t b[3];
    double f[3] = {fx, fy, fz};
    for (int d = 0; d < 3; ++d) {
      double fd = f[d];
      int64_t raw = (int64_t)std::floor(fd * (double)B[d]);
      if (periodic[d]) {
        raw = pymod(raw, B[d]);
      } else {
        if (raw < 0) raw = 0;
        if (raw >= B[d]) raw = B[d] - 1;
      }
      b[d] = raw;
      bin_of[3 * i + d] = raw;
    }
    int64_t bin = (b[0] * B[1] + b[1]) * B[2] + b[2];
    next[i] = bin_head[bin];
    bin_head[bin] = (int32_t)i;
  }

  const double cut2 = cutoff * cutoff;
  int64_t n_edges = 0;
  int64_t needed = 0;

  for (int64_t i = 0; i < n_atoms; ++i) {
    const double xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2];
    const int64_t bx = bin_of[3 * i], by = bin_of[3 * i + 1],
                  bz = bin_of[3 * i + 2];
    // for periodic axes the atom's TRUE (unwrapped) bin comes from frac
    int64_t ubx = periodic[0] ? (int64_t)std::floor(frac[3 * i] * B[0]) : bx;
    int64_t uby = periodic[1] ? (int64_t)std::floor(frac[3 * i + 1] * B[1]) : by;
    int64_t ubz = periodic[2] ? (int64_t)std::floor(frac[3 * i + 2] * B[2]) : bz;

    for (int64_t dx = -R[0]; dx <= R[0]; ++dx) {
      int64_t nbx = ubx + dx;
      int64_t sx = 0, cbx = nbx;
      if (periodic[0]) {
        sx = floordiv(nbx, B[0]);
        cbx = nbx - sx * B[0];
      } else if (nbx < 0 || nbx >= B[0]) {
        continue;
      }
      for (int64_t dy = -R[1]; dy <= R[1]; ++dy) {
        int64_t nby = uby + dy;
        int64_t sy = 0, cby = nby;
        if (periodic[1]) {
          sy = floordiv(nby, B[1]);
          cby = nby - sy * B[1];
        } else if (nby < 0 || nby >= B[1]) {
          continue;
        }
        for (int64_t dz = -R[2]; dz <= R[2]; ++dz) {
          int64_t nbz = ubz + dz;
          int64_t sz = 0, cbz = nbz;
          if (periodic[2]) {
            sz = floordiv(nbz, B[2]);
            cbz = nbz - sz * B[2];
          } else if (nbz < 0 || nbz >= B[2]) {
            continue;
          }
          int64_t bin = (cbx * B[1] + cby) * B[2] + cbz;
          for (int32_t j = bin_head[bin]; j >= 0; j = next[j]) {
            // image shift for neighbor j at this bin visit: the visited
            // (unwrapped) bin lies in box image s = floor(nb/B); atom j's raw
            // coordinates already sit in image w_j = floor(floor(frac_j*B)/B),
            // so the displacement to apply is (s - w_j) lattice vectors.
            double fjx = frac[3 * j], fjy = frac[3 * j + 1], fjz = frac[3 * j + 2];
            int64_t wx = periodic[0] ? floordiv((int64_t)std::floor(fjx * B[0]), B[0]) : 0;
            int64_t wy = periodic[1] ? floordiv((int64_t)std::floor(fjy * B[1]), B[1]) : 0;
            int64_t wz = periodic[2] ? floordiv((int64_t)std::floor(fjz * B[2]), B[2]) : 0;
            double shx = (double)(sx - wx), shy = (double)(sy - wy),
                   shz = (double)(sz - wz);
            if (j == (int32_t)i && shx == 0 && shy == 0 && shz == 0) continue;
            V3 disp = matvec_rowcell(cell, shx, shy, shz);
            double ddx = pos[3 * j] + disp.x - xi;
            double ddy = pos[3 * j + 1] + disp.y - yi;
            double ddz = pos[3 * j + 2] + disp.z - zi;
            double d2 = ddx * ddx + ddy * ddy + ddz * ddz;
            if (d2 <= cut2) {
              if (n_edges < max_edges) {
                edge_dst[n_edges] = (int32_t)i;
                edge_src[n_edges] = j;
                shifts_out[3 * n_edges] = shx;
                shifts_out[3 * n_edges + 1] = shy;
                shifts_out[3 * n_edges + 2] = shz;
                ++n_edges;
              }
              ++needed;
            }
          }
        }
      }
    }
  }
  if (needed > max_edges) return -needed;
  return n_edges;
}

}  // extern "C"
