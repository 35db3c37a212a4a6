// MINCO's block cyclic-reduction solve for Hopper (sm_90a): one launch a
// direction.
//
// Replaces no Pallas kernel. The JAX package solves the MINCO continuity
// system with svsdf_tpu/ops/block_cr.py, tensor code that XLA compiles;
// the port's plain version, svsdf_tpu_torch/ops/block_cr.py::_cr_core,
// runs the same code as PyTorch operations, about 610 of them a forward
// solve at N = 8 (cuBLAS batched 6x6 products, a Gauss-Jordan of six
// host-loop steps, a concatenation every level). This kernel computes
// what _cr_core computes, in one launch:
//   * the forward solve M x = rhs: the two-sided max equilibration,
//     bands_to_blocks, the even-odd block cyclic reduction over all
//     log2 N levels (an odd level padded with a decoupled identity
//     block), the unpivoted 6x6 Gauss-Jordan with its pivots clamped at
//     +-1e-30, `refine` rounds of iterative refinement with the 13-shift
//     band residual of the unscaled bands, and the final column scaling;
//   * the backward: the same solve of the transposed system
//     (A'_i = C_{i-1}^T, B'_i = B_i^T, C'_i = A_{i+1}^T, the row and
//     column scales swapped, the residual by M^T), which gives rhs_bar,
//     and the band gradient bands_bar[i, d] = -sum_k rhs_bar[i, k] *
//     x[i + d - 6, k], 0 outside the matrix, for the 13 bands only.
// The elimination order, the clamps, the equilibration and the
// refinement are _cr_core's. Two things are the plain version's results
// computed once rather than twice: the plain version runs the whole CR,
// matrices and right-hand side together, for the first solve and again
// for the refinement's correction; here the matrix part runs once and
// keeps, per level, the odd blocks' Gauss-Jordan factors (column j of the
// 6x6 block as it stands at step j: the multipliers, and the pivot that
// is clamped where it is read) and the even blocks' A and C, and each
// right-hand side replays those steps on its own columns. That is the
// arithmetic the right-hand side's columns get in the plain version's
// augmented Gauss-Jordan, operation for operation. The padding block
// (B = I, A = C = 0, d = 0) and the plain version's zero blocks (A_0,
// C_{N-1}, the shifted-in zeros) contribute exact zeros: the kernel skips
// those products. The plain version's elementwise products and sums
// (the eliminations, the band residual, the scalings) are rounded one
// by one here too (mul_rn, add_rn, sub_rn: never fused); its 6x6 matrix
// products are sums of six products in order, carried by FMAs as a
// matrix product's inner loop is (cuBLAS's own order differs in the
// last bits, so the card's results are not the plain version's to the
// bit: the card tests hold both against the float64 dense solve; the
// host build, which rounds every operation, equals the plain version's
// CPU results to the bit in x and rhs_bar).
//
// What bounds it on the H100: bytes. A plan at N pieces reads its
// 6N x 13 bands and 6N x D right-hand side once and writes 6N x D
// (float32, N = 8, D = 3: 2.5 KB + 0.6 KB in, 0.6 KB out); the backward
// reads bands, x and x_bar and writes rhs_bar and the 6N x 13 band
// gradient (6.8 KB). Its arithmetic is 36 k operations a plan forward
// and 40 k backward (ops/cuda_minco.py::work): at 67 TFLOP/s half the
// time of the bytes at 3.35 TB/s. So the design keeps every
// intermediate on chip:
// one warp owns one plan and holds it whole in shared memory (the bands,
// the scales, the block levels with their factors and Schur complements,
// the right-hand sides, the residual and x: 11.6 KB in float32 at N = 8,
// D = 3); only the inputs and the outputs touch device memory, each once,
// by lane-strided loads and stores over the plan's contiguous rows
// (every warp streams one contiguous range, the block's warps adjacent
// ones). Each phase spreads its independent items over the 32 lanes and
// ends with __syncwarp: a level's eliminations as one item per column of
// an odd block's augmented matrix ([B | A | C], the dead columns of B
// left out), each taking the pivot column from shared memory at every
// step; the Schur complements as one item per entry of the next level's
// blocks; the right-hand side's sweeps as one item per (block, column),
// whose six values stay in registers through the six steps. No block
// barrier, no shuffle: warps never wait on each other. Several plans
// share a block (the wrapper's geometry: the block size with the most
// resident plans an SM, from the occupancy API, dynamic shared memory
// past 48 KB where a plan needs it). A plan too large for one block's
// shared memory (float64 past N ~ 75 pieces, float32 past ~ 140) is
// refused: the geometry gives it no block, and the wrapper raises. On an
// H100 SXM (700 W) it runs at 24-26x its byte bound (0.435
// ms forward, 0.454 ms backward at 16384 plans, N = 8, D = 3): ~19
// resident plans an SM, each a chain of ~60 phases of dependent
// shared-memory reads, set the pace; both directions together are ~3% of
// a staged request's device time, so the layout stays the simple one.
//
// The same source compiles as C++ for the host (g++ -x c++): there the
// plan's function runs with one lane, and the CPU tests hold that
// arithmetic against the plain version (ops/cuda_minco.py::host_solve).

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define CR_HD __host__ __device__ __forceinline__
#else
#include <cstddef>
#include <vector>
#define CR_HD inline
#endif

namespace {

constexpr int kBs = 6;              // block size: a quintic piece
constexpr int kNd = 13;             // bands a row
constexpr int kLbw = 6;             // lower (and upper) bandwidth
constexpr int kMat = kBs * kBs;     // values a 6x6 block
// block_cr.py: the pivot clamp _PIV_EPS and equilibrate's clamp_min
constexpr double kPivEps = 1e-30;
constexpr double kTiny = 1e-30;

// One plan's lanes: `lane` of `count`; sync() ends a phase.
struct Lanes {
  int lane, count;
  CR_HD void sync() const {
#ifdef __CUDA_ARCH__
    __syncwarp();
#endif
  }
};

template <typename T>
CR_HD T absv(T a) { return a < T(0) ? -a : a; }

// torch.amax's max: NaN wins
template <typename T>
CR_HD T nanmax(T a, T b) { return (a > b || a != a) ? a : b; }

// torch.clamp_min(m, 1e-30): NaN stays NaN
template <typename T>
CR_HD T clamp_tiny(T m) { return m < T(kTiny) ? T(kTiny) : m; }

// block_cr._solve_blocks' clamp: |p| < eps -> -eps if p < 0 else eps
template <typename T>
CR_HD T clamp_piv(T p) {
  const T eps = T(kPivEps);
  return absv(p) < eps ? (p < T(0) ? -eps : eps) : p;
}

// a * b, a + b and a - b each rounded once and never fused with a
// neighbour: the plain version's elementwise products and sums are
// separate PyTorch operations
#ifdef __CUDA_ARCH__
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
#else
template <typename T> inline T mul_rn(T a, T b) { return a * b; }
template <typename T> inline T add_rn(T a, T b) { return a + b; }
template <typename T> inline T sub_rn(T a, T b) { return a - b; }
#endif

// row (stride 1) . column (stride `stride`), six terms in order, the sum
// carried by FMAs (as a matrix product's inner loop; the host build
// rounds each product and sum)
template <typename T>
CR_HD T dot6(const T* row, const T* col, int stride) {
  T s = row[0] * col[0];
#pragma unroll
  for (int t = 1; t < kBs; ++t) s = s + row[t] * col[t * stride];
  return s;
}

// A level block: A, B, C (6x6 row-major) then d (6 x D row-major).
constexpr int kA = 0, kB = kMat, kC = 2 * kMat, kD = 3 * kMat;

// The working set of one plan, in values of T.
struct Layout {
  int n, d, n6, blk;
  int bands, rhs, x, r, c, xf, levels, total;
};

CR_HD int level_count(int n) {  // n, ceil(n/2), ..., 1
  int levels = 1;
  while (n > 1) { n = (n + 1) / 2; ++levels; }
  return levels;
}

// offset of level `l` from the first level's, and its block count
CR_HD int level_offset(int n, int blk, int l, int* n_l) {
  int off = 0;
  for (int i = 0; i < l; ++i) { off += n * blk; n = (n + 1) / 2; }
  *n_l = n;
  return off;
}

CR_HD Layout layout(int n, int d, bool with_xf) {
  Layout g;
  g.n = n; g.d = d; g.n6 = kBs * n; g.blk = kD + kBs * d;
  int at = 0;
  g.bands = at; at += g.n6 * kNd;
  g.rhs = at;   at += g.n6 * d;
  g.x = at;     at += g.n6 * d;
  g.r = at;     at += g.n6;
  g.c = at;     at += g.n6;
  g.xf = at;    at += with_xf ? g.n6 * d : 0;
  g.levels = at;
  int n_last = 0;
  at += level_offset(n, g.blk, level_count(n), &n_last);
  g.total = at;
  return g;
}

// One Gauss-Jordan step j on one column `col` (row stride 6) of an
// augmented block whose 6x6 part F holds column j as it stands at step j:
// the plain version's aug - fac * rj, then row j = rj.
template <typename T>
CR_HD void gj_column(const T* F, int j, T* col) {
  const T piv = clamp_piv(F[j * kBs + j]);
  const T rj = col[j * kBs] / piv;
#pragma unroll
  for (int i = 0; i < kBs; ++i) {
    if (i != j) col[i * kBs] = sub_rn(col[i * kBs], mul_rn(F[i * kBs + j], rj));
  }
  col[j * kBs] = rj;
}

// The six steps of the factor F on one right-hand-side column (stride
// `stride`), in registers.
template <typename T>
CR_HD void gj_apply(const T* F, T* vec, int stride) {
  T v[kBs];
#pragma unroll
  for (int i = 0; i < kBs; ++i) v[i] = vec[i * stride];
#pragma unroll
  for (int j = 0; j < kBs; ++j) {
    const T rj = v[j] / clamp_piv(F[j * kBs + j]);
#pragma unroll
    for (int i = 0; i < kBs; ++i) {
      if (i != j) v[i] = sub_rn(v[i], mul_rn(F[i * kBs + j], rj));
    }
    v[j] = rj;
  }
#pragma unroll
  for (int i = 0; i < kBs; ++i) vec[i * stride] = v[i];
}

// The matrix half of the CR: level 0's blocks are in place; leaves every
// level's odd blocks as (SA, F, SC) and the next level's blocks built.
template <typename T>
CR_HD void factorize(const Lanes& L, T* lv, int n, int blk) {
  int n_l = n;
  while (n_l > 1) {
    const int n_odd = n_l / 2, n_next = (n_l + 1) / 2;
    T* nx = lv + n_l * blk;
    for (int j = 0; j < kBs; ++j) {
      const int nb = kBs - 1 - j;          // live columns of B past j
      const int cols = nb + 2 * kBs;       // ... then A's and C's
      for (int e = L.lane; e < n_odd * cols; e += L.count) {
        const int k = e / cols, q = e % cols;
        T* o = lv + (2 * k + 1) * blk;
        T* col = q < nb ? o + kB + j + 1 + q
               : q < nb + kBs ? o + kA + (q - nb)
               : o + kC + (q - nb - kBs);
        gj_column(o + kB, j, col);
      }
      L.sync();
    }
    // even block k couples odd k-1 (left) and odd k (right):
    // B' = B - A SC_{k-1} - C SA_k, A' = -A SA_{k-1}, C' = -C SC_k,
    // A'_0 = C'_last = 0
    for (int e = L.lane; e < n_next * 3 * kMat; e += L.count) {
      const int k = e / (3 * kMat), rem = e % (3 * kMat);
      const int which = rem / kMat, a = (rem % kMat) / kBs, b = rem % kBs;
      const T* ev = lv + 2 * k * blk;
      const bool left = k >= 1, right = 2 * k + 1 < n_l;
      const T* ea = ev + kA + a * kBs;        // row a of the even A
      const T* ec = ev + kC + a * kBs;        // ... and of its C
      T v;
      if (which == 1) {
        v = ev[kB + a * kBs + b];
        if (left) v = v - dot6(ea, ev - blk + kC + b, kBs);
        if (right) v = v - dot6(ec, ev + blk + kA + b, kBs);
      } else if (which == 0) {
        v = left ? -dot6(ea, ev - blk + kA + b, kBs) : T(0);
      } else {
        v = right && k < n_next - 1 ? -dot6(ec, ev + blk + kC + b, kBs)
                                    : T(0);
      }
      nx[k * blk + rem] = v;
    }
    L.sync();
    lv = nx;
    n_l = n_next;
  }
  for (int j = 0; j < kBs - 1; ++j) {        // the last level's one block
    for (int e = L.lane; e < kBs - 1 - j; e += L.count) {
      gj_column(lv + kB, j, lv + kB + j + 1 + e);
    }
    L.sync();
  }
}

// The right-hand-side half: level 0's d slots hold the scaled
// right-hand side on entry and the solution y on return.
template <typename T>
CR_HD void solve_rhs(const Lanes& L, T* lv0, int n, int blk, int d) {
  const int levels = level_count(n);
  T* lv = lv0;
  int n_l = n;
  while (n_l > 1) {
    const int n_odd = n_l / 2, n_next = (n_l + 1) / 2;
    T* nx = lv + n_l * blk;
    for (int e = L.lane; e < n_odd * d; e += L.count) {
      T* o = lv + (2 * (e / d) + 1) * blk;
      gj_apply(o + kB, o + kD + e % d, d);
    }
    L.sync();
    // d' = d - A Sd_{k-1} - C Sd_k
    for (int e = L.lane; e < n_next * kBs * d; e += L.count) {
      const int k = e / (kBs * d), rem = e % (kBs * d);
      const int a = rem / d, c = rem % d;
      const T* ev = lv + 2 * k * blk;
      T v = ev[kD + rem];
      if (k >= 1) v = v - dot6(ev + kA + a * kBs, ev - blk + kD + c, d);
      if (2 * k + 1 < n_l) {
        v = v - dot6(ev + kC + a * kBs, ev + blk + kD + c, d);
      }
      nx[k * blk + kD + rem] = v;
    }
    L.sync();
    lv = nx;
    n_l = n_next;
  }
  for (int e = L.lane; e < d; e += L.count) gj_apply(lv + kB, lv + kD + e, d);
  L.sync();
  // back-substitution: x_2k = x'_k, x_2k+1 = Sd_k - SA_k x'_k - SC_k x'_k+1
  for (int l = levels - 2; l >= 0; --l) {
    int n_cur = 0, n_next = 0;
    T* cur = lv0 + level_offset(n, blk, l, &n_cur);
    const T* nx = lv0 + level_offset(n, blk, l + 1, &n_next);
    for (int e = L.lane; e < n_cur * kBs * d; e += L.count) {
      const int kf = e / (kBs * d), rem = e % (kBs * d);
      const int a = rem / d, c = rem % d, k = kf / 2;
      T* blkp = cur + kf * blk;
      if (kf % 2 == 0) {
        blkp[kD + rem] = nx[k * blk + kD + rem];
      } else {
        T v = blkp[kD + rem] - dot6(blkp + kA + a * kBs, nx + k * blk + kD + c, d);
        if (k + 1 < n_next) {
          v = v - dot6(blkp + kC + a * kBs, nx + (k + 1) * blk + kD + c, d);
        }
        blkp[kD + rem] = v;
      }
    }
    L.sync();
  }
}

// y[i] = sum_d M[i, i + d - 6] x[i + d - 6] in band order, of the
// unscaled bands (band_matvec), or of M^T (band_matvec_t)
template <typename T>
CR_HD T band_row(const T* bands, const T* x, int n6, int d, int i, int c,
                 bool tr) {
  T acc = T(0);
  bool first = true;
  for (int dd = 0; dd < kNd; ++dd) {
    const int j = i + dd - kLbw;
    if (j < 0 || j >= n6) continue;
    const T m = tr ? bands[j * kNd + (kNd - 1 - dd)] : bands[i * kNd + dd];
    const T t = mul_rn(m, x[j * d + c]);
    acc = first ? t : add_rn(acc, t);
    first = false;
  }
  return acc;
}

// One plan: the solve of M x = rhs (tr: M^T x = rhs) with `refine`
// refinement rounds, x written to out; with bbar, also the band gradient
// -sum_k x[i, k] xf[i + d - 6, k] (x being rhs_bar there).
template <typename T>
CR_HD void plan_solve(const Lanes& L, T* ws, const Layout& g, const T* bands_g,
                      const T* rhs_g, const T* xf_g, T* out_g, T* bbar_g,
                      int refine, bool tr) {
  const int n6 = g.n6, d = g.d, blk = g.blk, nd = n6 * d;
  T* bands = ws + g.bands;
  T* rhs = ws + g.rhs;
  T* x = ws + g.x;
  T* r = ws + g.r;
  T* c = ws + g.c;
  T* xf = ws + g.xf;
  T* lv0 = ws + g.levels;
  for (int e = L.lane; e < n6 * kNd; e += L.count) bands[e] = bands_g[e];
  for (int e = L.lane; e < nd; e += L.count) rhs[e] = rhs_g[e];
  if (bbar_g) {
    for (int e = L.lane; e < nd; e += L.count) xf[e] = xf_g[e];
  }
  L.sync();
  // equilibrate: r = 1 / max_d |M_i,d|, then c over the scaled columns
  for (int i = L.lane; i < n6; i += L.count) {
    T m = absv(bands[i * kNd]);
    for (int dd = 1; dd < kNd; ++dd) m = nanmax(m, absv(bands[i * kNd + dd]));
    r[i] = T(1) / clamp_tiny(m);
  }
  L.sync();
  for (int j = L.lane; j < n6; j += L.count) {
    T m = absv(mul_rn(bands[j * kNd + kLbw], r[j]));
    for (int dd = 0; dd < kNd; ++dd) {
      const int i = j + kLbw - dd;
      if (dd == kLbw || i < 0 || i >= n6) continue;
      m = nanmax(m, absv(mul_rn(bands[i * kNd + dd], r[i])));
    }
    c[j] = T(1) / clamp_tiny(m);
  }
  L.sync();
  // bands_to_blocks of the scaled bands (r_i M_i,d) c_j, transposed for tr
  for (int e = L.lane; e < g.n * 3 * kMat; e += L.count) {
    const int k = e / (3 * kMat), rem = e % (3 * kMat);
    const int o = rem / kMat - 1, a = (rem % kMat) / kBs, b = rem % kBs;
    const int row = tr ? kBs * (k + o) + b : kBs * k + a;
    const int dd = tr ? a - b - kBs * o + kLbw : b - a + kBs * o + kLbw;
    const bool valid = dd >= 0 && dd < kNd && k + o >= 0 && k + o < g.n;
    T v = T(0);
    if (valid) {
      v = mul_rn(mul_rn(bands[row * kNd + dd], r[row]), c[row + dd - kLbw]);
    }
    lv0[k * blk + rem] = v;
  }
  L.sync();
  factorize(L, lv0, g.n, blk);
  const T* pre = tr ? c : r;
  const T* post = tr ? r : c;
  for (int sweep = 0; sweep <= refine; ++sweep) {
    // the right-hand side (sweep 0) or the residual rhs - M x, scaled
    for (int e = L.lane; e < nd; e += L.count) {
      const int i = e / d, cc = e % d;
      T b = rhs[e];
      if (sweep > 0) b = sub_rn(b, band_row(bands, x, n6, d, i, cc, tr));
      lv0[(i / kBs) * blk + kD + (i % kBs) * d + cc] = mul_rn(b, pre[i]);
    }
    L.sync();
    solve_rhs(L, lv0, g.n, blk, d);
    for (int e = L.lane; e < nd; e += L.count) {
      const int i = e / d;
      const T y = mul_rn(lv0[(i / kBs) * blk + kD + (i % kBs) * d + e % d],
                         post[i]);
      x[e] = sweep == 0 ? y : add_rn(x[e], y);
    }
    L.sync();
  }
  for (int e = L.lane; e < nd; e += L.count) out_g[e] = x[e];
  if (bbar_g) {
    for (int e = L.lane; e < n6 * kNd; e += L.count) {
      const int i = e / kNd, j = i + e % kNd - kLbw;
      T v = T(0);
      if (j >= 0 && j < n6) {
        T s = x[i * d] * xf[j * d];     // a matrix product's FMA chain
        for (int k = 1; k < d; ++k) s = s + x[i * d + k] * xf[j * d + k];
        v = -s;
      }
      bbar_g[e] = v;
    }
  }
}

}  // namespace

#ifdef __CUDACC__

namespace {

constexpr int kMaxWarps = 8;

// One warp a plan; plans [blockIdx.x * warps, ...) in the block, each
// with ws values of the block's dynamic shared memory.
template <typename T>
__global__ void __launch_bounds__(32 * kMaxWarps)
minco_cr_kernel(const T* __restrict__ bands, const T* __restrict__ rhs,
                const T* __restrict__ xf, T* __restrict__ out,
                T* __restrict__ bbar, int n_plans, int n, int d, int refine,
                int tr, int ws) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const long long plan = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (plan >= n_plans) return;
  T* w = reinterpret_cast<T*>(smem) + (long long)warp * ws;
  const Layout g = layout(n, d, bbar != nullptr);
  const long long n6 = (long long)kBs * n;
  plan_solve<T>(Lanes{(int)(threadIdx.x & 31), 32}, w, g,
                bands + plan * n6 * kNd, rhs + plan * n6 * d,
                bbar ? xf + plan * n6 * d : nullptr, out + plan * n6 * d,
                bbar ? bbar + plan * n6 * kNd : nullptr, refine, tr != 0);
}

template <typename T>
void launch(const void* bands, const void* rhs, const void* xf, void* out,
            void* bbar, int n_plans, int n, int d, int refine, int tr,
            int ws, unsigned grid, unsigned threads, size_t smem,
            cudaStream_t st) {
  minco_cr_kernel<T><<<grid, threads, smem, st>>>(
      static_cast<const T*>(bands), static_cast<const T*>(rhs),
      static_cast<const T*>(xf), static_cast<T*>(out), static_cast<T*>(bbar),
      n_plans, n, d, refine, tr, ws);
}

}  // namespace

// Launch geometry of the solve at (n, d, float64?, with the band gradient?)
// on the current device: out[0] = values a plan's working set takes in
// shared memory, out[1] = warps (plans) a block, 0 where one plan's
// working set passes a block's shared memory (the solve is refused). The
// block size is the one of 1, 2, 4, 8 warps with the most resident plans
// an SM (the occupancy API), the smallest of equals. Returns a
// cudaError_t (0 = success).
extern "C" int svsdf_minco_cr_geometry(int n, int d, int f64, int with_xf,
                                       int* out) {
  if (n < 1 || d < 1 || !out) return (int)cudaErrorInvalidValue;
  const long long ws = layout(n, d, with_xf != 0).total;
  const long long bytes = ws * (f64 ? 8 : 4);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  }
  if (err != cudaSuccess) return (int)err;
  out[0] = (int)ws;
  out[1] = 0;
  if (bytes > optin) return (int)cudaSuccess;
  void* fn = f64 ? reinterpret_cast<void*>(&minco_cr_kernel<double>)
                 : reinterpret_cast<void*>(&minco_cr_kernel<float>);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err != cudaSuccess) return (int)err;
  int best = -1;
  for (int warps = 1; warps <= kMaxWarps; warps *= 2) {
    if (bytes * warps > optin) break;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, fn, 32 * warps, (size_t)(bytes * warps));
    if (err != cudaSuccess) return (int)err;
    if (blocks * warps > best) { best = blocks * warps; out[1] = warps; }
  }
  return (int)cudaSuccess;
}

// The solve of B plans: bands (B, 6n, 13), rhs (B, 6n, d), out (B, 6n,
// d), contiguous, float (f64 = 0) or double, in device memory; tr != 0
// solves the transposed system; bbar (B, 6n, 13) non-null also writes
// the band gradient against xf (B, 6n, d), the forward solution. The
// geometry (ws, warps) is svsdf_minco_cr_geometry's. Launches on
// `stream`; returns cudaGetLastError() after the launch (0 = success).
extern "C" int svsdf_minco_cr(const void* bands, const void* rhs,
                              const void* xf, void* out, void* bbar,
                              int n_plans, int n, int d, int refine, int tr,
                              int f64, int ws, int warps, void* stream) {
  if (n_plans < 1 || n < 1 || d < 1 || refine < 0 || warps < 1
      || warps > kMaxWarps || ws != layout(n, d, bbar != nullptr).total
      || !bands || !rhs || !out || (bbar && !xf)) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned grid = (unsigned)((n_plans + warps - 1) / warps);
  const size_t smem = (size_t)ws * (f64 ? 8 : 4) * warps;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f64) {
    launch<double>(bands, rhs, xf, out, bbar, n_plans, n, d, refine, tr, ws,
                   grid, 32 * warps, smem, st);
  } else {
    launch<float>(bands, rhs, xf, out, bbar, n_plans, n, d, refine, tr, ws,
                  grid, 32 * warps, smem, st);
  }
  return (int)cudaGetLastError();
}

#else  // the host build: the plan's function with one lane

template <typename T>
static void host_solve(const T* bands, const T* rhs, const T* xf, T* out,
                       T* bbar, int n_plans, int n, int d, int refine,
                       int tr) {
  const Layout g = layout(n, d, bbar != nullptr);
  std::vector<T> ws((size_t)g.total);
  const size_t n6 = (size_t)kBs * n;
  for (int p = 0; p < n_plans; ++p) {
    plan_solve<T>(Lanes{0, 1}, ws.data(), g, bands + p * n6 * kNd,
                  rhs + p * n6 * d, bbar ? xf + p * n6 * d : nullptr,
                  out + p * n6 * d, bbar ? bbar + p * n6 * kNd : nullptr,
                  refine, tr != 0);
  }
}

// svsdf_minco_cr's arguments on host memory, one plan after another.
// Returns 0, or 1 on an argument it does not take.
extern "C" int svsdf_minco_cr_host(const void* bands, const void* rhs,
                                   const void* xf, void* out, void* bbar,
                                   int n_plans, int n, int d, int refine,
                                   int tr, int f64) {
  if (n_plans < 0 || n < 1 || d < 1 || refine < 0 || (bbar && !xf)) return 1;
  if (f64) {
    host_solve(static_cast<const double*>(bands),
               static_cast<const double*>(rhs),
               static_cast<const double*>(xf), static_cast<double*>(out),
               static_cast<double*>(bbar), n_plans, n, d, refine, tr);
  } else {
    host_solve(static_cast<const float*>(bands),
               static_cast<const float*>(rhs), static_cast<const float*>(xf),
               static_cast<float*>(out), static_cast<float*>(bbar), n_plans,
               n, d, refine, tr);
  }
  return 0;
}

#endif
