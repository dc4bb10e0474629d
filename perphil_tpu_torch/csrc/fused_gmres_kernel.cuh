// The fused GMRES kernel (see fused_gmres.cuh): device functions, the kernel
// template and its launcher, included by one fused_gmres_pc_*.cu per
// preconditioner.
#pragma once

#include <cooperative_groups.h>

#include "fused_gmres.cuh"

namespace perphil {

namespace cg = cooperative_groups;

// Phase clocks of one solve, for tools/profile_kernels.py alone: a
// translation unit that defines PERPHIL_GMRES_PROFILE gets a kernel whose
// block 0, thread 0 adds the cycles between marks to result[7 + phase].
enum ProfPhase {
  kProfApply, kProfDots, kProfNorm, kProfGivens, kProfScale, kProfSync, kProfRestart, kProfPhases
};
#ifdef PERPHIL_GMRES_PROFILE
#define PERPHIL_PROF(phase)                 \
  do {                                      \
    if (tid == 0) {                         \
      const long long now_ = clock64();     \
      prof[phase] += now_ - prof_t0;        \
      prof_t0 = now_;                       \
    }                                       \
  } while (0)
#else
#define PERPHIL_PROF(phase) \
  do {                      \
  } while (0)
#endif

__device__ __forceinline__ int bit_reverse(int t, int bits) {
  return bits == 0 ? 0 : (int)(__brev((unsigned)t) >> (32 - bits));
}

__device__ __forceinline__ int ceil_log2(int v) {
  return v <= 1 ? 0 : 32 - __clz(v - 1);
}

// Pairwise sum of pushed leaves: after 2^k pushes, st[k] holds the balanced
// binary tree over them (left to right). Indices are static after
// unrolling, so the stack stays in registers.
template <int kMaxLog>
struct TreeAcc {
  double st[kMaxLog + 1];
  int t = 0;
  __device__ __forceinline__ void push(double v) {
    bool placed = false;
#pragma unroll
    for (int l = 0; l <= kMaxLog; ++l) {
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
    for (int l = 0; l <= kMaxLog; ++l) {
      if (l == bits) r = st[l];
    }
    return r;
  }
};

// Halving tree over the kGmresThreads partials of each of `rows` rows
// (red[r][c], c = thread); out[r] receives the sums. Begins and ends with a
// barrier, so partials written before the call and out[] read after it are
// safe.
__device__ inline void block_tree_rows(double (*red)[kGmresThreads], int rows, double* out) {
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

// <u, v> over L values as one halving tree inside one block (the inner PCG
// of K6/K8); every thread receives it. Begins with a barrier, so u and v may
// have been written just before.
__device__ inline double block_dot(const double* u, const double* v, int L, int log_j,
                            double (*red)[kGmresThreads], double* out) {
  __syncthreads();
  TreeAcc<kMaxLogLeaves> acc;
#pragma unroll 4
  for (int t = 0; t < (1 << log_j); ++t) {
    const int e = threadIdx.x + bit_reverse(t, log_j) * kGmresThreads;
    acc.push(e < L ? __dmul_rn(u[e], v[e]) : 0.0);
  }
  red[0][threadIdx.x] = acc.result(log_j);
  block_tree_rows(red, 1, out);
  return out[0];
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

// Row idx of field f of the BC-eliminated operator, as fused_dpp_apply_plain
// computes it: y1 = S1 z1 + C z2 (f = 0), y2 = C z1 + S2 z2 (f = 1), identity
// rows on the boundary. kShared: z is the block's copy of the vector in
// shared memory; else z is read from device memory past L1 (other blocks of
// the cluster wrote it), every 8-byte load a 32-byte sector of L2 traffic.
// The 18 loads of a plane of neighbours go out together, ahead of the sums:
// behind the sums' branches they went one round trip at a time.
// nz: per stencil a bit for each nonzero weight (the terms apply_stencil
// keeps), so that a term's branch waits for no f64 compare.
template <int D, bool kShared>
__device__ __forceinline__ double dpp_row_ordered(const double* z1, const double* z2,
                                                  const DppWeights<double>& w, const StencilMasks& nz,
                                                  const Grid& g, int idx, int f) {
  const int i = idx % g.nx, t = idx / g.nx;
  const int j = D == 3 ? t % g.ny : t, k = D == 3 ? t / g.ny : 0;
  auto load = [](const double* p) { return kShared ? *p : __ldcg(p); };
  if (on_boundary<D>(g, k, j, i)) return load((f == 0 ? z1 : z2) + idx);
  // an interior node's neighbour lies on the boundary only where it steps
  // onto the last layer
  const bool xl = i == 1, xr = i == g.nx - 2, yl = j == 1, yr = j == g.ny - 2;
  const bool zl = D == 3 && k == 1, zr = D == 3 && k == g.nz - 2;
  double a1 = 0.0, a2 = 0.0;  // the z1 term, the z2 term
  bool f1 = true, f2 = true;
  const unsigned nz1 = f == 0 ? nz.s1 : nz.c, nz2 = f == 0 ? nz.c : nz.s2;
#pragma unroll
  for (int dz = (D == 3 ? -1 : 0); dz <= (D == 3 ? 1 : 0); ++dz) {
    double u[9], v[9];
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      const int nb = idx + (dz * g.ny + (q / 3 - 1)) * g.nx + (q % 3 - 1);
      u[q] = load(z1 + nb);
      v[q] = load(z2 + nb);
    }
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      const int dy = q / 3 - 1, dx = q % 3 - 1;
      const int o = (D == 3 ? (dz + 1) * 9 : 0) + q;
      const bool outer = (dx < 0 && xl) || (dx > 0 && xr) || (dy < 0 && yl) || (dy > 0 && yr) ||
                         (dz < 0 && zl) || (dz > 0 && zr);
      if ((nz1 >> o) & 1u) {
        const double t = __dmul_rn(f == 0 ? w.s1[o] : w.c[o], outer ? 0.0 : u[q]);
        a1 = f1 ? t : __dadd_rn(a1, t);
        f1 = false;
      }
      if ((nz2 >> o) & 1u) {
        const double t = __dmul_rn(f == 0 ? w.c[o] : w.s2[o], outer ? 0.0 : v[q]);
        a2 = f2 ? t : __dadd_rn(a2, t);
        f2 = false;
      }
    }
  }
  return __dadd_rn(a1, a2);
}

// Row idx of one field's block (FieldOperator.matvec): S_f z with the input
// masked to the interior, identity on the boundary. `f` picks S1 or S2.
template <int D>
__device__ __forceinline__ double field_apply_ordered(const double* z, const DppWeights<double>& w,
                                                      int f, const Grid& g, long idx) {
  int k, j, i;
  node_coords<D>(g, idx, k, j, i);
  if (on_boundary<D>(g, k, j, i)) return z[idx];
  double acc = 0.0;
  bool first = true;
#pragma unroll
  for (int dz = (D == 3 ? -1 : 0); dz <= (D == 3 ? 1 : 0); ++dz) {
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        const int o = (D == 3 ? (dz + 1) * 9 : 0) + (dy + 1) * 3 + (dx + 1);
        const long nb = idx + ((long)dz * g.ny + dy) * g.nx + dx;
        const double u = on_boundary<D>(g, k + dz, j + dy, i + dx) ? 0.0 : z[nb];
        accumulate(acc, first, f == 0 ? w.s1[o] : w.s2[o], u);
      }
    }
  }
  return acc;
}

// Row idx of the coupling C y (ops/assembly.py::coupling_apply):
// coef * (M y_interior), zero on the boundary.
template <int D>
__device__ __forceinline__ double coupling_at(const double* y, const double* mass, double coef,
                                              const Grid& g, long idx) {
  int k, j, i;
  node_coords<D>(g, idx, k, j, i);
  if (on_boundary<D>(g, k, j, i)) return 0.0;
  double acc = 0.0;
  bool first = true;
#pragma unroll
  for (int dz = (D == 3 ? -1 : 0); dz <= (D == 3 ? 1 : 0); ++dz) {
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        const int o = (D == 3 ? (dz + 1) * 9 : 0) + (dy + 1) * 3 + (dx + 1);
        const long nb = idx + ((long)dz * g.ny + dy) * g.nx + dx;
        const double u = on_boundary<D>(g, k + dz, j + dy, i + dx) ? 0.0 : y[nb];
        accumulate(acc, first, mass[o], u);
      }
    }
  }
  return __dmul_rn(coef, acc);
}

// Everything a preconditioner application needs, built once per launch.
struct PcView {
  PcData d;
  const PcTables* tab;  // shared memory
  IluStage st;          // the ILU roles' shared-memory stage (block 0)
  int n, nint;
};

// z = P_f r for one field's block (FastDiagFieldSolver.solve, K6): identity
// on the boundary, the fast-diag interior solve with field f's mode scales
// (the consistent eigenbasis on quad/hex meshes, the lumped one on tri/tet:
// the reused K3 transforms). w0, w1: nint scratch each.
template <int D>
__device__ void fastdiag_field(const PcView& pv, int f, const double* r, double* z, double* w0,
                               double* w1, const Grid& g) {
  const int nint = pv.nint;
  __syncthreads();
  for (int e = threadIdx.x; e < nint; e += blockDim.x) w0[e] = r[interior_to_node<D>(g, e)];
  __syncthreads();
  double* cur = transform_all<double, D, true>(w0, w1, pv.d.Sx, pv.d.Sy, pv.d.Sz, g, nint, 1);
  const double* sc = pv.d.sc + (size_t)f * nint;
  for (int e = threadIdx.x; e < nint; e += blockDim.x) cur[e] = __ddiv_rn(cur[e], sc[e]);
  __syncthreads();
  double* other = cur == w0 ? w1 : w0;
  cur = transform_all<double, D, false>(cur, other, pv.d.Sx, pv.d.Sy, pv.d.Sz, g, nint, 1);
  for (long idx = threadIdx.x; idx < pv.n; idx += blockDim.x) {
    int k, j, i;
    node_coords<D>(g, idx, k, j, i);
    z[idx] = on_boundary<D>(g, k, j, i) ? r[idx] : cur[node_to_interior<D>(g, k, j, i)];
  }
  __syncthreads();
}

// The inner block solve of the fieldsplit roles (pallas_gmres.py:1416-1474,
// FusedGMRESSolver._inner_pcg): PCG on field f's block from x = 0, z0 = M r,
// stopping on ||r|| <= max(rtol ||rhs||, atol) or a non-finite norm. x may
// alias nothing else; ws holds 5n (+ 2 nint for K6) of scratch.
template <int D, int PC>
__device__ void inner_pcg(const PcView& pv, int f, const double* rhs, double* x, double* ws,
                          const DppWeights<double>& w, const Grid& g, const GmresParams& prm,
                          double (*red)[kGmresThreads], double* sh) {
  const int n = pv.n;
  double* r = ws;
  double* z = r + n;
  double* p = z + n;
  double* Ap = p + n;
  double* ys = Ap + n;  // the ILU sweeps' or the fast-diag's scratch
  auto apply_pc = [&](const double* in, double* out) {
    if constexpr (PC == kPcFieldsplitIlu) {
      ilu_apply(f == 0 ? pv.d.F0L : pv.d.F1L, f == 0 ? pv.d.F0U : pv.d.F1U, n, pv.tab->meta, pv.st,
                pv.d.level_rows, pv.d.nlev, in, ys, out);
    } else {
      fastdiag_field<D>(pv, f, in, out, ys, ys + pv.nint, g);
    }
  };
  const double rn0 = __dsqrt_rn(block_dot(rhs, rhs, n, prm.log_jf, red, sh));
  const double t_rel = __dmul_rn(rn0, prm.in_rtol);
  const double tol = t_rel > prm.in_atol ? t_rel : prm.in_atol;
  apply_pc(rhs, z);
  double rz = block_dot(z, rhs, n, prm.log_jf, red, sh);
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    x[e] = 0.0;
    r[e] = rhs[e];
    p[e] = z[e];
  }
  bool done = !(rn0 > tol);
  int its = 0;
  while (!done && its < prm.in_max) {
    __syncthreads();
    for (long idx = threadIdx.x; idx < n; idx += blockDim.x) Ap[idx] = field_apply_ordered<D>(p, w, f, g, idx);
    const double alpha = __ddiv_rn(rz, block_dot(p, Ap, n, prm.log_jf, red, sh));
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      x[e] = __dadd_rn(x[e], __dmul_rn(alpha, p[e]));
      r[e] = __dsub_rn(r[e], __dmul_rn(alpha, Ap[e]));
    }
    apply_pc(r, z);
    const double rz_new = block_dot(z, r, n, prm.log_jf, red, sh);
    const double beta = __ddiv_rn(rz_new, rz);
    for (int e = threadIdx.x; e < n; e += blockDim.x) p[e] = __dadd_rn(z[e], __dmul_rn(beta, p[e]));
    rz = rz_new;
    const double rn = __dsqrt_rn(block_dot(r, r, n, prm.log_jf, red, sh));
    ++its;
    done = !(rn > tol) || !isfinite(rn);
  }
  __syncthreads();
}


// The preconditioners that run in one block (K6-K8), on block 0 of the
// cluster: out = P t with t (2n, device memory) the operator's output. ws:
// the scratch behind t in PcData::work.
template <int D, int PC>
__device__ void apply_block_pc(double* t, double* out, const DppWeights<double>& w, const Grid& g,
                               const PcView& pv, const GmresParams& prm,
                               double (*red)[kGmresThreads], double* sh) {
  const long n = g.nodes();
  if constexpr (PC == kPcIlu) {
    ilu_apply(pv.d.F0L, pv.d.F0U, (int)(2 * n), pv.tab->meta, pv.st, pv.d.level_rows, pv.d.nlev, t,
              t + 2 * n, out);
  } else {
    // multiplicative fieldsplit: y1 = B0 t1, y2 = B1 (t2 - C y1)
    double* ws = t + 2 * n;
    inner_pcg<D, PC>(pv, 0, t, out, ws, w, g, prm, red, sh);
    for (long idx = threadIdx.x; idx < n; idx += blockDim.x) {
      t[n + idx] = __dsub_rn(t[n + idx], coupling_at<D>(out, pv.tab->mass, prm.coef, g, idx));
    }
    inner_pcg<D, PC>(pv, 1, t + n, out + n, ws, w, g, prm, red, sh);
  }
}

// The thread's place in the cluster and the values it owns (fused_gmres.cuh,
// "Ownership"): slot i = s * kGmresThreads + lam of the block's slice is
// value e = ((i >> 2) * nb + b) * 4 + (i & 3).
struct Own {
  int b, nb, lam, log_s;
  __device__ __forceinline__ int slot(int s) const { return s * kGmresThreads + lam; }
  __device__ __forceinline__ int elem(int i) const { return (((i >> 2) * nb + b) << 2) | (i & 3); }
};

struct Reducer {
  double (*part)[64];  // shared memory: per row, 16 warps x 4 lo partials
  double* xchg;        // device memory: two regions, taken in turn
  int sel;
};

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ double add_down(double v, int s) {
  return __dadd_rn(v, __shfl_down_sync(kFullMask, v, s));
}

// The thread's part of the rows' trees: for each row its own 2^kLogS leaves,
// halved in registers, then the three bits of h that are lane bits; lanes
// 0..3 hold the warp's four lo partials. Rows go kRowBatch at a time, each
// level of all of them before the next: a row alone is one chain of
// dependent f64 adds and shuffles, some 250 cycles of latency.
constexpr int kRowBatch = 4;

template <int kLogS, class Leaf>
__device__ __forceinline__ void warp_tree_rows(double (*part)[64], int rows, Leaf leaf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k0 = 0; k0 < rows; k0 += kRowBatch) {
    double p[kRowBatch][1 << kLogS];
#pragma unroll
    for (int r = 0; r < kRowBatch; ++r) {
      const int k = k0 + r < rows ? k0 + r : rows - 1;  // the tail repeats the last row
#pragma unroll
      for (int s = 0; s < (1 << kLogS); ++s) p[r][s] = leaf(k, s);
    }
#pragma unroll
    for (int wd = (1 << kLogS) >> 1; wd > 0; wd >>= 1) {
#pragma unroll
      for (int r = 0; r < kRowBatch; ++r) {
#pragma unroll
        for (int s = 0; s < wd; ++s) p[r][s] = __dadd_rn(p[r][s], p[r][s + wd]);
      }
    }
#pragma unroll
    for (int sh = 16; sh >= 4; sh >>= 1) {
#pragma unroll
      for (int r = 0; r < kRowBatch; ++r) p[r][0] = add_down(p[r][0], sh);
    }
#pragma unroll
    for (int r = 0; r < kRowBatch; ++r) {
      if (lane < 4 && k0 + r < rows) part[k0 + r][warp * 4 + lane] = p[r][0];
    }
  }
}

// out[k] = the halving tree over leaf(k, s) of every thread of the cluster
// (s: the thread's own leaves), k < rows <= kMaxBasis; every thread of every
// block may read out[] (shared memory) afterwards. leaf(k, s) is called once
// per k and s and should be cheap: it is instantiated per leaf count. With
// more than one block this crosses one cluster barrier.
template <class Leaf>
__device__ __forceinline__ void cluster_tree_rows(Reducer& rd, const Own& o, int rows, double* out,
                                                  Leaf leaf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  switch (o.log_s) {
    case 0: warp_tree_rows<0>(rd.part, rows, leaf); break;
    case 1: warp_tree_rows<1>(rd.part, rows, leaf); break;
    case 2: warp_tree_rows<2>(rd.part, rows, leaf); break;
    default:
      // many leaves a thread: the pairwise stack, leaves in bit-reversed order
      for (int k = 0; k < rows; ++k) {
        TreeAcc<kMaxLogS> acc;
        for (int t = 0; t < (1 << o.log_s); ++t) acc.push(leaf(k, bit_reverse(t, o.log_s)));
        const double v = add_down(add_down(add_down(acc.result(o.log_s), 16), 8), 4);
        if (lane < 4) rd.part[k][warp * 4 + lane] = v;
      }
  }
  __syncthreads();
  // the four bits of h that are the warp: one warp a row
  double* x = rd.xchg + rd.sel * (kXchgDoubles / 2);
  for (int k = warp; k < rows; k += kGmresThreads / 32) {
    double v = __dadd_rn(rd.part[k][lane], rd.part[k][lane + 32]);
    v = add_down(v, 16);
    v = add_down(v, 8);
    v = add_down(v, 4);
    if (o.nb == 1) {
      v = add_down(v, 2);
      v = add_down(v, 1);
      if (lane == 0) out[k] = v;
    } else if (lane < 4) {
      x[(k * o.nb + o.b) * 4 + lane] = v;
    }
  }
  if (o.nb > 1) {
    // the blocks' bits, then lo: every block finishes the tree itself
    cg::this_cluster().sync();
    const int width = 4 * o.nb;
    for (int k = warp; k < rows; k += kGmresThreads / 32) {
      const double* xr = x + k * width;
      double v = lane < width ? __ldcg(xr + lane) : 0.0;
      if (width == 64) v = __dadd_rn(v, __ldcg(xr + lane + 32));
      for (int s = (width < 32 ? width : 32) / 2; s > 0; s >>= 1) v = add_down(v, s);
      if (lane == 0) out[k] = v;
    }
    rd.sel ^= 1;
  }
  __syncthreads();
}

// sum_k coef[k] * term(k) over k < rows as the halving tree over 2^kBits
// zero-padded terms; the first level is taken while loading, so 2^(kBits-1)
// values are live.
template <int kBits, class Term>
__device__ __forceinline__ double comb_tree(const double* coef, int rows, Term term) {
  if constexpr (kBits == 0) {
    return __dmul_rn(coef[0], term(0));
  } else {
    constexpr int half = 1 << (kBits - 1);
    double p[half];
#pragma unroll
    for (int k = 0; k < half; ++k) {
      const double lo = k < rows ? __dmul_rn(coef[k], term(k)) : 0.0;
      const double hi = k + half < rows ? __dmul_rn(coef[k + half], term(k + half)) : 0.0;
      p[k] = __dadd_rn(lo, hi);
    }
#pragma unroll
    for (int wd = half >> 1; wd > 0; wd >>= 1) {
#pragma unroll
      for (int k = 0; k < wd; ++k) p[k] = __dadd_rn(p[k], p[k + wd]);
    }
    return p[0];
  }
}

template <class Term>
__device__ __forceinline__ double basis_comb(const double* coef, int rows, Term term) {
  switch (ceil_log2(rows)) {
    case 0: return comb_tree<0>(coef, rows, term);
    case 1: return comb_tree<1>(coef, rows, term);
    case 2: return comb_tree<2>(coef, rows, term);
    case 3: return comb_tree<3>(coef, rows, term);
    case 4: return comb_tree<4>(coef, rows, term);
    default: return comb_tree<5>(coef, rows, term);
  }
}

template <int D, int PC>
__global__ void __launch_bounds__(kGmresThreads)
fused_gmres_kernel(const double* b, const double* x0, double* x, double* V, double* xchg,
                   double* result, DppWeights<double> w, Grid g, GmresParams prm, PcData pd,
                   PcTables tables, GmresGeom geom) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ double part[kMaxBasis][64];
  __shared__ double R[kMaxBasis][kMaxBasis];  // R[column][row]
  __shared__ double h[kMaxBasis + 1], gv[kMaxBasis + 1], cs[kMaxBasis], sn[kMaxBasis],
      y[kMaxBasis], scal[2], pcs[1];
  __shared__ PcTables tab;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#ifdef PERPHIL_GMRES_PROFILE
  __shared__ long long prof[kProfPhases], prof_t0;
  if (tid == 0) {
    for (int i = 0; i < kProfPhases; ++i) prof[i] = 0;
    prof_t0 = clock64();
  }
#endif
  const long n = g.nodes();
  const int L = (int)(2 * n);
  const size_t ld = L;
  const int m = prm.restart, S = 1 << geom.log_s;
  const Own o{(int)cluster.block_rank(), geom.nb, ((((lane >> 2) << 4) | warp) << 2) | (lane & 3),
              geom.log_s};
  Reducer rd{part, xchg, 0};
  // dynamic shared memory: the ILU stage, the copy of the matvec's input
  // vector, the block's basis slice
  const bool vs = geom.basis_smem != 0;
  double* Zs = reinterpret_cast<double*>(dyn + geom.ilu.bytes);
  double* Vs = Zs + (geom.z_smem ? L : 0);
  const int ldS = geom.nloc;
  if (PC >= kPcFieldsplitLu && tid == 0) tab = tables;
  __syncthreads();
  const int nint = (g.nx - 2) * (g.ny - 2) * (D == 3 ? g.nz - 2 : 1);
  PcView pv{pd, &tab, IluStage{}, (int)n, nint};
  if ((PC == kPcIlu || PC == kPcFieldsplitIlu) && o.b == 0) {
    pv.st = ilu_stage(geom.ilu, dyn, pd.level_ptr, PC == kPcIlu ? L : (int)n, pd.nlev);
  }

  // the thread's own values of basis row k: slot i is value e
  // (one pointer for both homes of the basis: a branch on the home would
  // keep the compiler from overlapping the rows of a reduction)
  double* const B = vs ? Vs : V;
  const size_t ldB = vs ? (size_t)ldS : ld;
  auto vget = [&](int k, int i, int e) { return B[k * ldB + (vs ? i : e)]; };
  auto vput = [&](int k, int i, int e, double v, bool global) {
    B[k * ldB + (vs ? i : e)] = v;
    if (vs && global) V[k * ld + e] = v;
  };
  // for each value the thread owns: fn(slot, value index)
  auto own = [&](auto fn) {
    for (int s = 0; s < S; ++s) {
      const int i = o.slot(s), e = o.elem(i);
      if (e < L) fn(i, e);
    }
  };
  // basis row k = P(A z), or P(b - A z) when bb is given; z is complete in
  // device memory and a cluster barrier lies behind its last write. Without
  // a block preconditioner the row stays with its owners; with one it is
  // also complete in device memory.
  auto apply = [&](const double* z, const double* bb, int k) {
    if (geom.z_smem) {
      // the whole vector, once, in 16-byte loads (L = 2n is even and the
      // rows of V start on 16 bytes)
      const double2* src = reinterpret_cast<const double2*>(z);
      double2* dst = reinterpret_cast<double2*>(Zs);
      for (int e2 = tid; e2 < L / 2; e2 += kGmresThreads) dst[e2] = __ldcg(src + e2);
      __syncthreads();
    }
    own([&](int i, int e) {
      const int f = e >= n ? 1 : 0;
      double v = geom.z_smem ? dpp_row_ordered<D, true>(Zs, Zs + n, w, prm.nz, g, e - f * (int)n, f)
                             : dpp_row_ordered<D, false>(z, z + n, w, prm.nz, g, e - f * (int)n, f);
      if (bb != nullptr) v = __dsub_rn(bb[e], v);
      if (PC == kPcJacobi) v = __dmul_rn(pd.dinv[e], v);
      if (PC >= kPcFieldsplitLu) {
        pd.work[e] = v;
      } else {
        vput(k, i, e, v, false);
      }
    });
    if constexpr (PC >= kPcFieldsplitLu) {
      cluster.sync();
      if (o.b == 0) {
        apply_block_pc<D, PC>(pd.work, V + k * ld, w, g, pv, prm,
                              reinterpret_cast<double(*)[kGmresThreads]>(part), pcs);
      }
      cluster.sync();
      if (vs) own([&](int i, int e) { Vs[k * ldS + i] = __ldcg(V + k * ld + e); });
    }
  };
  // basis row k scaled by 1 / d where d > 0, to its owners and device memory
  auto scale_row = [&](int k, double d) {
    own([&](int i, int e) {
      const double v = vget(k, i, e);
      vput(k, i, e, d > 0.0 ? __ddiv_rn(v, d) : v, true);
    });
  };

  own([&](int, int e) { x[e] = x0[e]; });

  double tol = 0.0, div = 0.0, rnorm = 0.0;
  int its = 0;
  bool first = true;
  for (;;) {
    // r = P(b - A x) into row 0, beta = ||r||
    cluster.sync();
    apply(x, b, 0);
    cluster_tree_rows(rd, o, 1, scal, [&](int, int s) {
      const int i = o.slot(s), e = o.elem(i);
      if (e >= L) return 0.0;
      const double v = vget(0, i, e);
      return __dmul_rn(v, v);
    });
    const double beta = __dsqrt_rn(scal[0]);
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
    scale_row(0, beta);
    if (tid == 0) {
      gv[0] = beta;
      for (int i = 1; i <= m; ++i) gv[i] = 0.0;
    }
    cluster.sync();
    PERPHIL_PROF(kProfRestart);

    const double tol0 = 0.0 > tol ? 0.0 : tol;
    int j = 0;
    rnorm = beta;
    while (j < m && its < prm.max_it && rnorm > tol0 && rnorm <= div) {
      apply(V + j * ld, nullptr, j + 1);
      PERPHIL_PROF(kProfApply);

      // h[k] = <V_k, w>, k <= j: one pass over w
      cluster_tree_rows(rd, o, j + 1, h, [&](int k, int s) {
        const int i = o.slot(s), e = o.elem(i);
        return e < L ? __dmul_rn(vget(k, i, e), vget(j + 1, i, e)) : 0.0;
      });

      PERPHIL_PROF(kProfDots);
      // w -= sum_k h[k] V_k (classical Gram-Schmidt), then ||w||^2
      own([&](int i, int e) {
        vput(j + 1, i, e,
             __dsub_rn(vget(j + 1, i, e), basis_comb(h, j + 1, [&](int k) { return vget(k, i, e); })),
             false);
      });
      cluster_tree_rows(rd, o, 1, scal, [&](int, int s) {
        const int i = o.slot(s), e = o.elem(i);
        if (e >= L) return 0.0;
        const double nw = vget(j + 1, i, e);
        return __dmul_rn(nw, nw);
      });
      const double hj1 = __dsqrt_rn(scal[0]);
      PERPHIL_PROF(kProfNorm);

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
      PERPHIL_PROF(kProfGivens);
      scale_row(j + 1, hj1);
      PERPHIL_PROF(kProfScale);
      cluster.sync();
      PERPHIL_PROF(kProfSync);
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
      own([&](int i, int e) {
        x[e] = __dadd_rn(x[e], basis_comb(y, j, [&](int k) { return vget(k, i, e); }));
      });
    }
    if (rnorm <= tol || its >= prm.max_it || rnorm > div || !isfinite(rnorm) || j == 0) break;
  }
  if (o.b == 0 && tid == 0) {
    result[0] = (double)its;
    result[1] = rnorm;
    result[2] = rnorm <= tol ? 1.0 : 0.0;
    result[3] = (double)geom.nb;
    result[4] = (double)geom.basis_smem;
    result[5] = (double)geom.ilu.z_smem;
    result[6] = (double)geom.z_smem;
#ifdef PERPHIL_GMRES_PROFILE
    PERPHIL_PROF(kProfRestart);
    for (int i = 0; i < kProfPhases; ++i) result[7 + i] = (double)prof[i];
#endif
  }
}

// The geometry for L = 2n values within `budget` bytes of dynamic shared
// memory; false where the leaves per thread exceed the frame's tree.
template <int PC>
bool plan_geometry(const GmresArgs& a, long budget, GmresGeom& geo) {
  const long n = a.g.nodes(), L = 2 * n;
  geo = GmresGeom{};
  geo.nb = gmres_blocks(L);
  while ((1 << geo.log_nb) < geo.nb) ++geo.log_nb;
  while (((long)kGmresThreads * geo.nb << geo.log_s) < L) ++geo.log_s;
  if (geo.log_s > kMaxLogS) return false;
  const long piece = 4L * geo.nb;
  geo.nloc = (int)(4 * (L / piece) + (L % piece < 4 ? L % piece : 4));
  long used = 0;
  if (PC == kPcIlu || PC == kPcFieldsplitIlu) {
    geo.ilu = ilu_plan(a.tab.meta, (int)(PC == kPcIlu ? L : n), a.pd.nlev, a.max_level_rows, budget);
    used = geo.ilu.bytes;
  }
  // the matvec's input first (it saves the most L2 traffic), then the slice
  if (used + 8 * L <= budget) {
    geo.z_smem = 1;
    used += 8 * L;
  }
  const long slice = (long)(a.prm.restart + 1) * geo.nloc * 8;
  if (used + slice <= budget) {
    geo.basis_smem = 1;
    used += slice;
  }
  geo.bytes = (int)used;
  return true;
}

template <int D, int PC>
cudaError_t launch_fused_gmres_dim(const GmresArgs& a, cudaStream_t st) {
  auto kern = fused_gmres_kernel<D, PC>;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kern);
  if (err != cudaSuccess) return err;
  const long budget = kMaxSmemPerBlock - (long)fa.sharedSizeBytes;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  GmresGeom geo;
  if (!plan_geometry<PC>(a, budget, geo)) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.bytes);
  if (err != cudaSuccess) return err;
  // one cluster of geo.nb blocks; a card that cannot place it refuses the launch
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(geo.nb);
  cfg.blockDim = dim3(kGmresThreads);
  cfg.dynamicSmemBytes = (size_t)geo.bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = geo.nb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, a.b, a.x0, a.x, a.V, a.xchg, a.result, a.w, a.g, a.prm,
                            a.pd, a.tab, geo);
}

template <int PC>
cudaError_t launch_fused_gmres(const GmresArgs& a, cudaStream_t st) {
  return a.dim == 3 ? launch_fused_gmres_dim<3, PC>(a, st) : launch_fused_gmres_dim<2, PC>(a, st);
}

}  // namespace perphil
