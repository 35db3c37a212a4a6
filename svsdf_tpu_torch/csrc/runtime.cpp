// Native host runtime of svsdf_tpu_torch: the host-side hot loops.
//
// Own copy of svsdf_tpu/native/runtime.cpp, the same four functions with
// the same signatures and semantics. The reference keeps these loops in
// C++ (A* front end, front_end_Astar.hpp:243-365; point-cloud
// voxelization, PCSmap_manager.cpp:88-210; marching-cubes meshing via
// libigl, sw_calculate.hpp:107-128). Device math lives in PyTorch and
// CUDA; these ragged host loops live here, exported over a plain C ABI
// consumed via ctypes (svsdf_tpu_torch/native/__init__.py). Each function
// is a pure array-in/array-out kernel: no globals, no IO, thread-safe.
// It is host code: no kernel of the card.
//
// Build (svsdf_tpu_torch/native/__init__.py::build, at first use):
//   g++ -O3 -std=c++17 -shared -fPIC runtime.cpp -o libsvsdfrt_<digest>.so

#include <cstdint>
#include <cstring>
#include <cmath>
#include <queue>
#include <vector>
#include <unordered_map>

namespace {

// 8-connected neighborhood, identical order to ops/kernels.py DIRS8.
constexpr int DIRS8[8][2] = {{-1, -1}, {-1, 0}, {-1, 1}, {0, -1},
                             {0, 1},  {1, -1}, {1, 0},  {1, 1}};

struct OpenNode {
  double f;
  int64_t counter;
  int32_t i, j;
  bool operator<(const OpenNode& o) const {
    // std::priority_queue is a max-heap; invert for min-f, FIFO ties
    if (f != o.f) return f > o.f;
    return counter > o.counter;
  }
};

inline double heu(int i, int j, int gi, int gj) {
  // diagonal heuristic with the 1+1e-3 tie-break
  // (front_end_Astar.hpp:165-183); dz = 0 on the SE(2) slice.
  double dx = std::abs(i - gi), dy = std::abs(j - gj);
  double dmin = std::min(dx, dy), dmax = std::max(dx, dy);
  double h = std::sqrt(2.0) * dmin + (dmax - dmin);
  return h * (1.0 + 1e-3);
}

}  // namespace

extern "C" {

// SE(2) A* over precomputed feasibility maps (planner/astar.py
// semantics, bit-for-bit).  Inputs:
//   feas       (K, X, Y) uint8 — yaw-bin feasibility
//   trans_feas (K, D, 8, X, Y) uint8 or nullptr — transition veto
//   occ2d      (X, Y) uint8 — occupancy slice
//   yaw_deltas (D,) int32 — the yaw-BFS visit order (YAW_BFS_DELTAS)
// Output: out_cells (max_len, 3) int32 rows (i, j, yaw_bin), start
// first.  Returns path length, 0 if no path, -1 on bad args.
// out_expansions receives the expansion count.
int64_t svsdf_astar(const uint8_t* feas, const uint8_t* trans_feas,
                    const uint8_t* occ2d, int32_t K, int32_t D,
                    int32_t X, int32_t Y, int32_t si, int32_t sj,
                    int32_t gi, int32_t gj, int32_t start_bin,
                    const int32_t* yaw_deltas, double yaw_change_weight,
                    int64_t max_expansions, int32_t* out_cells,
                    int64_t max_len, int64_t* out_expansions) {
  if (si < 0 || sj < 0 || si >= X || sj >= Y || gi < 0 || gj < 0 ||
      gi >= X || gj >= Y)
    return -1;
  const int64_t n = static_cast<int64_t>(X) * Y;
  std::vector<double> g(n, HUGE_VAL);
  std::vector<int8_t> state(n, 0);  // 0 unseen, 1 open, -1 closed
  std::vector<int32_t> ybin(n, -1);
  std::vector<int64_t> parent(n, -1);

  auto idx = [Y](int i, int j) { return static_cast<int64_t>(i) * Y + j; };

  const int64_t s = idx(si, sj);
  g[s] = 0.0;
  ybin[s] = start_bin;
  state[s] = 1;

  std::priority_queue<OpenNode> open;
  int64_t counter = 0;
  open.push({heu(si, sj, gi, gj), counter++, si, sj});
  int64_t expansions = 0;

  const int64_t planeKX = static_cast<int64_t>(D) * 8 * X * Y;
  const int64_t planeD = static_cast<int64_t>(8) * X * Y;

  while (!open.empty()) {
    OpenNode cur = open.top();
    open.pop();
    const int64_t c = idx(cur.i, cur.j);
    if (state[c] == -1) continue;
    state[c] = -1;
    if (cur.i == gi && cur.j == gj) {
      // backtrack
      std::vector<int64_t> cells;
      for (int64_t p = c; p != -1; p = parent[p]) cells.push_back(p);
      int64_t L = static_cast<int64_t>(cells.size());
      if (L > max_len) L = max_len;
      for (int64_t r = 0; r < L; ++r) {
        const int64_t cell = cells[cells.size() - 1 - r];
        out_cells[r * 3 + 0] = static_cast<int32_t>(cell / Y);
        out_cells[r * 3 + 1] = static_cast<int32_t>(cell % Y);
        out_cells[r * 3 + 2] = ybin[cell];
      }
      *out_expansions = expansions;
      return L;
    }
    if (++expansions > max_expansions) break;
    const double cg = g[c];
    const int fbin = ybin[c];
    for (int dir = 0; dir < 8; ++dir) {
      const int ni = cur.i + DIRS8[dir][0];
      const int nj = cur.j + DIRS8[dir][1];
      if (ni < 0 || nj < 0 || ni >= X || nj >= Y) continue;
      const int64_t nn = idx(ni, nj);
      if (occ2d[nn]) continue;
      if (state[nn] == -1) continue;
      // yaw-bin BFS from the father's bin; first feasible wins
      // (checkKernelValue, sw_manager.hpp:1158-1169)
      int cbin = -1, delta_idx = -1;
      for (int k = 0; k < D; ++k) {
        int b = (fbin + yaw_deltas[k]) % K;
        if (b < 0) b += K;
        if (feas[static_cast<int64_t>(b) * X * Y + nn]) {
          cbin = b;
          delta_idx = k;
          break;
        }
      }
      if (cbin < 0) continue;
      if (trans_feas &&
          !trans_feas[static_cast<int64_t>(fbin) * planeKX +
                      static_cast<int64_t>(delta_idx) * planeD +
                      static_cast<int64_t>(dir) * X * Y + nn])
        continue;
      const double dbin = std::abs(yaw_deltas[delta_idx]);
      const double step = (DIRS8[dir][0] && DIRS8[dir][1])
                              ? std::sqrt(2.0)
                              : 1.0;
      const double tg = cg + step + yaw_change_weight * dbin;
      if (tg < g[nn]) {
        g[nn] = tg;
        parent[nn] = c;
        ybin[nn] = cbin;  // bin tracks the winning parent (veto + cost
                          // above were evaluated for cbin)
        state[nn] = 1;
        open.push({tg + heu(ni, nj, gi, gj), counter++, ni, nj});
      }
    }
  }
  *out_expansions = expansions;
  return 0;
}

// Point-cloud voxelization: per-voxel point counting + threshold
// (PCSmapManager::rcvGlobalMapHandler, PCSmap_manager.cpp:88-210).
// points (N, 3) float64; out_occ (nx*ny*nz) uint8 zero-initialised by
// the caller.  Points outside the box are ignored.  Returns the
// number of occupied voxels.
int64_t svsdf_voxelize(const double* points, int64_t n_points,
                       const double* xyz_min, double resolution,
                       int32_t nx, int32_t ny, int32_t nz,
                       int32_t threshold, uint8_t* out_occ) {
  const int64_t n = static_cast<int64_t>(nx) * ny * nz;
  std::vector<int32_t> counts(n, 0);
  const double inv = 1.0 / resolution;
  for (int64_t p = 0; p < n_points; ++p) {
    const double* q = points + 3 * p;
    // clamp boundary points into the edge voxels (bounds are measured
    // from the cloud itself, so the max-corner point lands on nx)
    int64_t i = static_cast<int64_t>(std::floor((q[0] - xyz_min[0]) * inv));
    int64_t j = static_cast<int64_t>(std::floor((q[1] - xyz_min[1]) * inv));
    int64_t k = static_cast<int64_t>(std::floor((q[2] - xyz_min[2]) * inv));
    i = std::min(std::max(i, int64_t{0}), int64_t{nx - 1});
    j = std::min(std::max(j, int64_t{0}), int64_t{ny - 1});
    k = std::min(std::max(k, int64_t{0}), int64_t{nz - 1});
    ++counts[(i * ny + j) * nz + k];
  }
  int64_t occ = 0;
  for (int64_t v = 0; v < n; ++v) {
    out_occ[v] = counts[v] >= threshold ? 1 : 0;
    occ += out_occ[v];
  }
  return occ;
}

// Marching squares over a scalar field (the 2-D analogue of the
// reference's igl::marching_cubes swept-surface meshing,
// sw_calculate.hpp:107-128): emits zero-level-set segments.
// field (nx, ny) float32 sampled at xs[i] = x0 + i*step.
// out_segs rows are (x0, y0, x1, y1) float64.  Returns segment count.
int64_t svsdf_marching_squares(const float* field, int32_t nx, int32_t ny,
                               double x0, double y0, double step,
                               float level, double* out_segs,
                               int64_t max_segs) {
  int64_t ns = 0;
  auto interp = [&](double va, double vb) {
    const double d = vb - va;
    return std::abs(d) > 1e-30 ? (level - va) / d : 0.5;
  };
  for (int32_t i = 0; i + 1 < nx && ns < max_segs; ++i) {
    for (int32_t j = 0; j + 1 < ny && ns < max_segs; ++j) {
      const double v00 = field[static_cast<int64_t>(i) * ny + j];
      const double v10 = field[static_cast<int64_t>(i + 1) * ny + j];
      const double v01 = field[static_cast<int64_t>(i) * ny + j + 1];
      const double v11 = field[static_cast<int64_t>(i + 1) * ny + j + 1];
      int c = (v00 < level) | ((v10 < level) << 1) | ((v11 < level) << 2) |
              ((v01 < level) << 3);
      if (c == 0 || c == 15) continue;
      // edge midpoints in world coords; edges: 0 bottom (00-10),
      // 1 right (10-11), 2 top (01-11), 3 left (00-01)
      double ex[4], ey[4];
      ex[0] = x0 + (i + interp(v00, v10)) * step; ey[0] = y0 + j * step;
      ex[1] = x0 + (i + 1) * step; ey[1] = y0 + (j + interp(v10, v11)) * step;
      ex[2] = x0 + (i + interp(v01, v11)) * step; ey[2] = y0 + (j + 1) * step;
      ex[3] = x0 + i * step; ey[3] = y0 + (j + interp(v00, v01)) * step;
      // segment table per case (pairs of edge ids; -1 terminated)
      static const int8_t TBL[16][5] = {
          {-1}, {0, 3, -1}, {1, 0, -1}, {1, 3, -1},
          {2, 1, -1}, {0, 3, 2, 1, -1}, {2, 0, -1}, {2, 3, -1},
          {3, 2, -1}, {0, 2, -1}, {1, 0, 3, 2, -1}, {1, 2, -1},
          {3, 1, -1}, {0, 1, -1}, {3, 0, -1}, {-1}};
      for (int t = 0; TBL[c][t] >= 0 && ns < max_segs; t += 2) {
        const int a = TBL[c][t], b = TBL[c][t + 1];
        out_segs[ns * 4 + 0] = ex[a];
        out_segs[ns * 4 + 1] = ey[a];
        out_segs[ns * 4 + 2] = ex[b];
        out_segs[ns * 4 + 3] = ey[b];
        ++ns;
      }
    }
  }
  return ns;
}

// ESDF via Felzenszwalb 1-D lower-envelope passes (the reference's
// generateESDF3d / fillESDF, Gridmap3D.cpp:366-538) — host fallback /
// oracle for the device ESDF op (ops/esdf.py).  occ (nx, ny) uint8 ->
// out_sdf (nx, ny) float32 signed distance in world units.
static void dt1d(const double* f, double* d, int n, std::vector<int>& v,
                 std::vector<double>& z) {
  int k = 0;
  v[0] = 0;
  z[0] = -HUGE_VAL;
  z[1] = HUGE_VAL;
  for (int q = 1; q < n; ++q) {
    double s;
    while (true) {
      s = ((f[q] + q * q) - (f[v[k]] + v[k] * v[k])) / (2.0 * q - 2.0 * v[k]);
      if (s <= z[k]) --k; else break;
    }
    ++k;
    v[k] = q;
    z[k] = s;
    z[k + 1] = HUGE_VAL;
  }
  k = 0;
  for (int q = 0; q < n; ++q) {
    while (z[k + 1] < q) ++k;
    const double dq = q - v[k];
    d[q] = dq * dq + f[v[k]];
  }
}

void svsdf_esdf2d(const uint8_t* occ, int32_t nx, int32_t ny,
                  double resolution, float* out_sdf) {
  const int64_t n = static_cast<int64_t>(nx) * ny;
  std::vector<double> dpos(n), dneg(n), tmp(n);
  // large-but-finite "infinity": with true INF the parabola
  // intersection s degenerates to -inf and ties z[0], walking k
  // negative (classic Felzenszwalb pitfall). 1e15 >> any nx^2+ny^2.
  constexpr double kFar = 1e15;
  for (int64_t v = 0; v < n; ++v) {
    dpos[v] = occ[v] ? 0.0 : kFar;   // dist to occupied
    dneg[v] = occ[v] ? kFar : 0.0;   // dist to free
  }
  std::vector<int> vbuf(std::max(nx, ny));
  std::vector<double> zbuf(std::max(nx, ny) + 1);
  std::vector<double> line(std::max(nx, ny)), out(std::max(nx, ny));
  for (auto* d : {&dpos, &dneg}) {
    // y pass
    for (int32_t i = 0; i < nx; ++i) {
      dt1d(d->data() + static_cast<int64_t>(i) * ny,
           out.data(), ny, vbuf, zbuf);
      std::memcpy(d->data() + static_cast<int64_t>(i) * ny, out.data(),
                  ny * sizeof(double));
    }
    // x pass
    for (int32_t j = 0; j < ny; ++j) {
      for (int32_t i = 0; i < nx; ++i)
        line[i] = (*d)[static_cast<int64_t>(i) * ny + j];
      dt1d(line.data(), out.data(), nx, vbuf, zbuf);
      for (int32_t i = 0; i < nx; ++i)
        (*d)[static_cast<int64_t>(i) * ny + j] = out[i];
    }
  }
  for (int64_t v = 0; v < n; ++v) {
    const double dp = std::sqrt(dpos[v]) * resolution;
    const double dn = std::sqrt(dneg[v]) * resolution;
    // signed: positive in free space (distance to nearest obstacle),
    // negative inside obstacles (Gridmap3D.cpp:475-497 convention)
    out_sdf[v] = static_cast<float>(occ[v] ? -dn : dp);
  }
}

}  // extern "C"
