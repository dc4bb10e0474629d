// K4 and K5: the whole restarted GMRES(m) solve in one thread block.
//
// Replaces perphil_tpu/ops/pallas_gmres.py::fused_gmres_df (:2368;
// _build_cycle :1204, pallas_call :1810; pc none/jacobi) and
// ::fused_gmres_ef64 (:2323; _build_cycle_ef64 :1843, pallas_call :2278).
// The TPU needs two kernels only because Mosaic has no f64: K4 computes in
// double-float, K5 in f32 triples rounded to the f64 grid. Here both are one
// native-f64 kernel; the wrapper counts a launch under the role's name.
//
// What it computes is ops/krylov.py::gmres bit for bit: left-preconditioned
// GMRES(m) with PETSc's stopping tests (convergence, max_it, divergence, a
// non-finite estimate, a cycle with no step), classical Gram-Schmidt, a
// sequential Givens chain and a written-out back-substitution. Every dot
// product, norm and basis combination is the same pairwise halving tree as
// the twin's tree_sum, and every multiply and add rounds on its own
// (__dmul_rn/__dadd_rn: nvcc would otherwise contract them into FMAs). The
// matvec keeps apply_stencil's order (S pass, C pass, then their sum), which
// is not dpp_apply_node's interleaved, contracted order.
//
// Bound on the H100: latency. A step is one stencil matvec and (j+1) dot
// products and axpys over a few thousand nodes, so a host loop would spend
// its time in launches and in reading each Hessenberg column back. Here the
// restart loop runs inside one block of kGmresThreads threads; the basis
// (m+1) x 2n f64 lives in device scratch and stays L2-resident (2.1 MB at 2D
// N=64); the Hessenberg, g and the rotations live in shared memory, and
// thread 0 runs the scalar recurrences between barriers.
//
// Reductions. A halving tree over L values (zero-padded to a power of two
// Lt = J * kGmresThreads) equals: thread c sums its strided set
// {c + t * kGmresThreads} as a halving tree, then the kGmresThreads partials
// are halved. A halving tree over J values is the balanced pairwise tree over
// them in bit-reversed index order, so each thread pushes its leaves in that
// order into a pairwise accumulator (TreeAcc). Loads stay coalesced.

#include "dpp_stencil.cuh"

namespace perphil {

constexpr int kGmresThreads = 512;
constexpr int kMaxBasis = 32;     // m + 1
constexpr int kRowChunk = 8;      // rows per batched block reduction
constexpr int kMaxLogLeaves = 8;  // leaves per thread <= 256

enum PcKind { kPcNone = 0, kPcJacobi = 1 };

struct GmresParams {
  double rtol, atol, dtol;
  int max_it, restart;
  int log_j;  // log2 of the leaves per thread
};

__device__ __forceinline__ int bit_reverse(int t, int bits) {
  return bits == 0 ? 0 : (int)(__brev((unsigned)t) >> (32 - bits));
}

__device__ __forceinline__ int ceil_log2(int v) {
  return v <= 1 ? 0 : 32 - __clz(v - 1);
}

// Pairwise sum of pushed leaves: after 2^k pushes, st[k] holds the balanced
// binary tree over them (left to right). Indices are static after
// unrolling, so the stack stays in registers.
struct TreeAcc {
  double st[kMaxLogLeaves + 1];
  int t = 0;
  __device__ __forceinline__ void push(double v) {
    bool placed = false;
#pragma unroll
    for (int l = 0; l <= kMaxLogLeaves; ++l) {
      if (!placed) {
        if ((t >> l) & 1) {
          v = __dadd_rn(st[l], v);
        } else {
          st[l] = v;
          placed = true;
        }
      }
    }
    ++t;
  }
  __device__ __forceinline__ double result(int bits) const {
    double r = 0.0;
#pragma unroll
    for (int l = 0; l <= kMaxLogLeaves; ++l) {
      if (l == bits) r = st[l];
    }
    return r;
  }
};

// Halving tree over the kGmresThreads partials of each of `rows` rows
// (red[r][c], c = thread); out[r] receives the sums. Begins and ends with a
// barrier, so partials written before the call and out[] read after it are
// safe.
__device__ void block_tree_rows(double (*red)[kGmresThreads], int rows, double* out) {
  __syncthreads();
  for (int s = kGmresThreads / 2; s >= 32; s >>= 1) {
    for (int idx = threadIdx.x; idx < rows * s; idx += blockDim.x) {
      const int r = idx / s, c = idx - r * s;
      red[r][c] = __dadd_rn(red[r][c], red[r][c + s]);
    }
    __syncthreads();
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < rows) {
    double v = red[warp][lane];
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) v = __dadd_rn(v, __shfl_down_sync(0xffffffffu, v, s));
    if (lane == 0) out[warp] = v;
  }
  __syncthreads();
}

// One stencil application in apply_stencil's order: the nonzero weights in
// itertools.product order, each term w * z rounded, then added; the input is
// masked to interior nodes.
__device__ __forceinline__ void accumulate(double& acc, bool& first, double wt, double u) {
  if (wt == 0.0) return;
  const double t = __dmul_rn(wt, u);
  acc = first ? t : __dadd_rn(acc, t);
  first = false;
}

// Row idx of the BC-eliminated operator, as fused_dpp_apply_plain computes
// it: y1 = S1 z1 + C z2, y2 = C z1 + S2 z2, identity rows on the boundary.
template <int D>
__device__ __forceinline__ void dpp_apply_ordered(const double* z1, const double* z2,
                                                  const DppWeights<double>& w, const Grid& g,
                                                  long idx, double& y1, double& y2) {
  int k, j, i;
  node_coords<D>(g, idx, k, j, i);
  if (on_boundary<D>(g, k, j, i)) {
    y1 = z1[idx];
    y2 = z2[idx];
    return;
  }
  double s1z1 = 0.0, cz2 = 0.0, cz1 = 0.0, s2z2 = 0.0;
  bool f0 = true, f1 = true, f2 = true, f3 = true;
#pragma unroll
  for (int dz = (D == 3 ? -1 : 0); dz <= (D == 3 ? 1 : 0); ++dz) {
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        const int o = (D == 3 ? (dz + 1) * 9 : 0) + (dy + 1) * 3 + (dx + 1);
        const long nb = idx + ((long)dz * g.ny + dy) * g.nx + dx;
        const bool inner = !on_boundary<D>(g, k + dz, j + dy, i + dx);
        const double u = inner ? z1[nb] : 0.0;
        const double v = inner ? z2[nb] : 0.0;
        accumulate(s1z1, f0, w.s1[o], u);
        accumulate(cz2, f1, w.c[o], v);
        accumulate(cz1, f2, w.c[o], u);
        accumulate(s2z2, f3, w.s2[o], v);
      }
    }
  }
  y1 = __dadd_rn(s1z1, cz2);
  y2 = __dadd_rn(cz1, s2z2);
}

// out = P(A z), or out = P(b - A z) when b is given; P is identity or the
// Jacobi scaling dinv * r.
template <int D, int PC>
__device__ void apply_op(const double* z, const double* b, const double* dinv, double* out,
                         const DppWeights<double>& w, const Grid& g) {
  const long n = g.nodes();
  for (long idx = threadIdx.x; idx < n; idx += blockDim.x) {
    double y1, y2;
    dpp_apply_ordered<D>(z, z + n, w, g, idx, y1, y2);
    if (b != nullptr) {
      y1 = __dsub_rn(b[idx], y1);
      y2 = __dsub_rn(b[n + idx], y2);
    }
    if (PC == kPcJacobi) {
      y1 = __dmul_rn(dinv[idx], y1);
      y2 = __dmul_rn(dinv[n + idx], y2);
    }
    out[idx] = y1;
    out[n + idx] = y2;
  }
}

// sum_k coef[k] * V[k][e] over k < rows, as a halving tree over k.
__device__ __forceinline__ double basis_comb(const double* coef, const double* V, size_t ld,
                                             int rows, int e) {
  const int bits = ceil_log2(rows);
  TreeAcc acc;
  for (int t = 0; t < (1 << bits); ++t) {
    const int k = bit_reverse(t, bits);
    acc.push(k < rows ? __dmul_rn(coef[k], V[k * ld + e]) : 0.0);
  }
  return acc.result(bits);
}

// ||v||^2 as one halving tree; every thread receives it.
__device__ double block_norm2(const double* v, int L, int log_j,
                              double (*red)[kGmresThreads], double* out) {
  TreeAcc acc;
#pragma unroll 4
  for (int t = 0; t < (1 << log_j); ++t) {
    const int e = threadIdx.x + bit_reverse(t, log_j) * kGmresThreads;
    acc.push(e < L ? __dmul_rn(v[e], v[e]) : 0.0);
  }
  red[0][threadIdx.x] = acc.result(log_j);
  block_tree_rows(red, 1, out);
  return out[0];
}

template <int D, int PC>
__global__ void __launch_bounds__(kGmresThreads)
fused_gmres_kernel(const double* b, const double* x0, const double* dinv, double* x, double* V,
                   double* result, DppWeights<double> w, Grid g, GmresParams prm) {
  __shared__ double red[kRowChunk][kGmresThreads];
  __shared__ double R[kMaxBasis][kMaxBasis];  // R[column][row]
  __shared__ double h[kMaxBasis + 1], gv[kMaxBasis + 1], cs[kMaxBasis], sn[kMaxBasis],
      y[kMaxBasis], scal[kRowChunk];
  const int tid = threadIdx.x;
  const int L = (int)(2 * g.nodes());
  const size_t ld = L;
  const int m = prm.restart, log_j = prm.log_j, leaves = 1 << log_j;

  for (int e = tid; e < L; e += blockDim.x) x[e] = x0[e];
  __syncthreads();

  double tol = 0.0, div = 0.0, rnorm = 0.0;
  int its = 0;
  bool first = true;
  for (;;) {
    // r = P(b - A x) into V[0], beta = ||r||
    apply_op<D, PC>(x, b, dinv, V, w, g);
    __syncthreads();
    const double beta = __dsqrt_rn(block_norm2(V, L, log_j, red, scal));
    if (first) {
      const double t = __dmul_rn(prm.rtol, beta);
      tol = prm.atol > t ? prm.atol : t;  // Python's max(t, atol)
      div = __dmul_rn(prm.dtol, beta);
      first = false;
      if (beta <= tol) {
        rnorm = beta;
        break;
      }
    }
    if (beta > 0.0) {
      for (int e = tid; e < L; e += blockDim.x) V[e] = __ddiv_rn(V[e], beta);
    }
    if (tid == 0) {
      gv[0] = beta;
      for (int i = 1; i <= m; ++i) gv[i] = 0.0;
    }
    __syncthreads();

    const double tol0 = 0.0 > tol ? 0.0 : tol;
    int j = 0;
    rnorm = beta;
    while (j < m && its < prm.max_it && rnorm > tol0 && rnorm <= div) {
      double* wv = V + (j + 1) * ld;
      apply_op<D, PC>(V + j * ld, nullptr, dinv, wv, w, g);
      __syncthreads();

      // h[k] = <V_k, w>, k <= j, in chunks of kRowChunk rows
      for (int k0 = 0; k0 <= j; k0 += kRowChunk) {
        const int rows = min(kRowChunk, j + 1 - k0);
        for (int r = 0; r < rows; ++r) {
          const double* v = V + (k0 + r) * ld;
          TreeAcc acc;
#pragma unroll 4
          for (int t = 0; t < leaves; ++t) {
            const int e = tid + bit_reverse(t, log_j) * kGmresThreads;
            acc.push(e < L ? __dmul_rn(v[e], wv[e]) : 0.0);
          }
          red[r][tid] = acc.result(log_j);
        }
        block_tree_rows(red, rows, h + k0);
      }

      // w -= sum_k h[k] V_k (classical Gram-Schmidt); ||w||^2 on the way
      TreeAcc nacc;
      for (int t = 0; t < leaves; ++t) {
        const int e = tid + bit_reverse(t, log_j) * kGmresThreads;
        double leaf = 0.0;
        if (e < L) {
          const double nw = __dsub_rn(wv[e], basis_comb(h, V, ld, j + 1, e));
          wv[e] = nw;
          leaf = __dmul_rn(nw, nw);
        }
        nacc.push(leaf);
      }
      red[0][tid] = nacc.result(log_j);
      block_tree_rows(red, 1, scal);
      const double hj1 = __dsqrt_rn(scal[0]);

      if (tid == 0) {
        // the stored rotations, then the new one zeroing h[j+1]
        h[j + 1] = hj1;
        for (int i = 0; i < j; ++i) {
          const double hi = h[i], hi1 = h[i + 1];
          h[i] = __dadd_rn(__dmul_rn(cs[i], hi), __dmul_rn(sn[i], hi1));
          h[i + 1] = __dadd_rn(__dmul_rn(-sn[i], hi), __dmul_rn(cs[i], hi1));
        }
        const double a = h[j], bb = h[j + 1];
        const double denom = __dsqrt_rn(__dadd_rn(__dmul_rn(a, a), __dmul_rn(bb, bb)));
        const double c = denom > 0.0 ? __ddiv_rn(a, denom) : 1.0;
        const double s = denom > 0.0 ? __ddiv_rn(bb, denom) : 0.0;
        cs[j] = c;
        sn[j] = s;
        h[j] = __dadd_rn(__dmul_rn(c, a), __dmul_rn(s, bb));
        for (int i = 0; i <= j; ++i) R[j][i] = h[i];
        const double gj = gv[j];
        gv[j] = __dmul_rn(c, gj);
        gv[j + 1] = __dmul_rn(-s, gj);
        scal[1] = fabs(gv[j + 1]);
      }
      if (hj1 > 0.0) {
        for (int e = tid; e < L; e += blockDim.x) wv[e] = __ddiv_rn(wv[e], hj1);
      }
      __syncthreads();
      rnorm = scal[1];  // rewritten only after the next step's barriers
      ++j;
      ++its;
    }

    if (j > 0) {
      if (tid == 0) {
        // R[:j, :j] y = g[:j], rows from the bottom, each sum left to right
        for (int i = j - 1; i >= 0; --i) {
          double s = gv[i];
          for (int k = i + 1; k < j; ++k) s = __dsub_rn(s, __dmul_rn(R[k][i], y[k]));
          y[i] = __ddiv_rn(s, R[i][i]);
        }
      }
      __syncthreads();
      for (int e = tid; e < L; e += blockDim.x) x[e] = __dadd_rn(x[e], basis_comb(y, V, ld, j, e));
      __syncthreads();
    }
    if (rnorm <= tol || its >= prm.max_it || rnorm > div || !isfinite(rnorm) || j == 0) break;
  }
  if (tid == 0) {
    result[0] = (double)its;
    result[1] = rnorm;
    result[2] = rnorm <= tol ? 1.0 : 0.0;
  }
}

template <int D>
void launch_gmres(int pc, const double* b, const double* x0, const double* dinv, double* x,
                  double* V, double* result, const DppWeights<double>& w, const Grid& g,
                  const GmresParams& prm, cudaStream_t st) {
  if (pc == kPcJacobi) {
    fused_gmres_kernel<D, kPcJacobi><<<1, kGmresThreads, 0, st>>>(b, x0, dinv, x, V, result, w, g, prm);
  } else {
    fused_gmres_kernel<D, kPcNone><<<1, kGmresThreads, 0, st>>>(b, x0, dinv, x, V, result, w, g, prm);
  }
}

}  // namespace perphil

// b, x0, x: (2, nz*ny*nx) f64; dinv: the same shape (pc 1, Jacobi) or null
// (pc 0); V: (restart + 1) * 2 * nodes f64 scratch; result: 3 f64
// (iterations, residual norm, converged). restart + 1 <= 32.
extern "C" int perphil_fused_gmres(const double* b, const double* x0, const double* dinv, double* x,
                                   double* V, double* result, const double* weights, int nz,
                                   int ny, int nx, int dim, int pc, double rtol, double atol,
                                   double dtol, int max_it, int restart, void* stream) {
  using namespace perphil;
  if ((dim != 2 && dim != 3) || nx < 1 || ny < 1 || nz < 1 || (dim == 2 && nz != 1) ||
      restart < 1 || restart + 1 > kMaxBasis || (pc != kPcNone && pc != kPcJacobi) ||
      (pc == kPcJacobi && dinv == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const long L = 2L * nz * ny * nx;
  int log_j = 0;
  while (((long)kGmresThreads << log_j) < L) ++log_j;
  if (log_j > kMaxLogLeaves) return (int)cudaErrorInvalidValue;
  const Grid g{nz, ny, nx};
  const DppWeights<double> w = weights_from_host<double>(weights);
  const GmresParams prm{rtol, atol, dtol, max_it, restart, log_j};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dim == 3) {
    launch_gmres<3>(pc, b, x0, dinv, x, V, result, w, g, prm, st);
  } else {
    launch_gmres<2>(pc, b, x0, dinv, x, V, result, w, g, prm, st);
  }
  return (int)cudaGetLastError();
}
