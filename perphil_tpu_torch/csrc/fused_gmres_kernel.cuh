// The fused GMRES kernel (see fused_gmres.cuh): device functions, the kernel
// template and its launcher, included by one fused_gmres_pc_*.cu per
// preconditioner.
#pragma once

#include <cooperative_groups.h>

#include "field_sweep.cuh"
#include "fused_gmres.cuh"

namespace perphil {

namespace cg = cooperative_groups;

// Phase clocks of one solve, for tools/profile_kernels.py alone: a
// translation unit that defines PERPHIL_GMRES_PROFILE gets a kernel whose
// thread 0 of each block adds the cycles between marks to its block's
// counters; block 0's land in result[kResultSlots + phase]. The kIn* phases
// split the fieldsplit roles' inner block solves, PCG or GMRES (the rest of a
// preconditioner application stays in kProfApply).
enum ProfPhase {
  kProfApply, kProfDots, kProfNorm, kProfGivens, kProfScale, kProfSync, kProfRestart,
  kProfInPc, kProfInMatvec, kProfInDots, kProfInUpdate, kProfInGivens, kProfPhases
};
#ifdef PERPHIL_GMRES_PROFILE
__shared__ long long prof[kProfPhases], prof_t0;
#define PERPHIL_PROF(phase)                 \
  do {                                      \
    if (threadIdx.x == 0) {                 \
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

// Node idx's coordinates in 32-bit arithmetic (every grid here has far
// fewer than 2^31 nodes; a 64-bit division is a long software sequence).
template <int D>
__device__ __forceinline__ void coords(const Grid& g, int idx, int& k, int& j, int& i) {
  i = idx % g.nx;
  const int t = idx / g.nx;
  j = D == 3 ? t % g.ny : t;
  k = D == 3 ? t / g.ny : 0;
}

// Loads of a vector in device memory that other blocks of the cluster wrote
// go past L1 (kCg); a block's own copy in shared memory is read plainly.
template <bool kCg>
__device__ __forceinline__ double vload(const double* p) {
  return kCg ? __ldcg(p) : *p;
}

// Row idx of one field's block (FieldOperator.matvec): S_f z with the input
// masked to the interior, identity on the boundary; wf: S_f's 27 weights.
template <int D, bool kCg>
__device__ __forceinline__ double field_apply_ordered(const double* z, const double* wf, const Grid& g,
                                                      int idx) {
  int k, j, i;
  coords<D>(g, idx, k, j, i);
  if (on_boundary<D>(g, k, j, i)) return vload<kCg>(z + idx);
  double acc = 0.0;
  bool first = true;
#pragma unroll
  for (int dz = (D == 3 ? -1 : 0); dz <= (D == 3 ? 1 : 0); ++dz) {
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        const int o = (D == 3 ? (dz + 1) * 9 : 0) + (dy + 1) * 3 + (dx + 1);
        const int nb = idx + (dz * g.ny + dy) * g.nx + dx;
        const double u = on_boundary<D>(g, k + dz, j + dy, i + dx) ? 0.0 : vload<kCg>(z + nb);
        accumulate(acc, first, wf[o], u);
      }
    }
  }
  return acc;
}

// Row idx of the coupling C y (ops/assembly.py::coupling_apply):
// coef * (M y_interior), zero on the boundary; y in device memory, written
// by other blocks of the cluster.
template <int D>
__device__ __forceinline__ double coupling_at(const double* y, const double* mass, double coef,
                                              const Grid& g, int idx) {
  int k, j, i;
  coords<D>(g, idx, k, j, i);
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
        const int nb = idx + (dz * g.ny + dy) * g.nx + dx;
        const double u = on_boundary<D>(g, k + dz, j + dy, i + dx) ? 0.0 : __ldcg(y + nb);
        accumulate(acc, first, mass[o], u);
      }
    }
  }
  return __dmul_rn(coef, acc);
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

// The offsets a side of the structured ILU(0) has, for the straight code of
// the sweeps: 4 (2D field), 13 (2D monolithic, 3D field), 40 (3D monolithic:
// the run-time loop, 0). The launcher checks the table against them.
template <int D>
constexpr int kFieldOffsets = D == 2 ? 4 : 13;
template <int D>
constexpr int kMonolithicOffsets = D == 2 ? 13 : 0;

// Everything a preconditioner application needs, built once per launch.
struct PcView {
  PcData d;
  const PcTables* tab;  // shared memory
  IluStage st;          // the ILU roles' shared-memory stage (block 0), the ring's
  double* edges;        // K8's line pipeline: its edge lines (block 0), or null
  int n, nint;
  int line_warps;       // K8's line pipeline's warps, 0: the ring
};

// The fieldsplit roles' inner block solve (PCG, or K8's literal GMRES),
// spread over the cluster as the frame's GMRES is: a block owns the field's
// values by the frame's rule (o, with a thread's leaves for n values), keeps
// its slices of the solve's vectors in shared memory and takes every dot on
// the cluster tree, which rounds as the twin's tree_sum. Vectors that cross
// blocks (p or a basis vector for the field matvec, r for the
// preconditioner, its z) go through device memory behind a cluster barrier;
// the field matvec reads its input from a shared-memory copy where it fits.
struct FieldPcg {
  Own o;
  int n, lines, nmax;
  double *xs, *rs, *zs, *ps, *aps;       // shared memory: the block's slices
  double* lb;                            // K6: two line buffers of lines x nmax
  double* pfull;                         // shared memory: the field matvec's input, or null
  double* sm;                            // K6: the eigenbases' copy, or null
  double *pbuf, *rbuf, *zbuf, *t1, *t2;  // device memory, n each
  double* vin;                           // K8 literal: the inner basis, (in_restart + 1) x n
  double* gstate;                        // K8 literal: kInnerStateDoubles a block
  int* counts;                           // shared memory: inner iterations, solves
};

// The frame's scalars in shared memory that are dead while its
// preconditioner runs (written again only after it): the inner solves take
// them for their trees' outputs and back-substitution.
struct FrameScalars {
  double* h;     // kMaxBasis + 1
  double* y;     // kMaxBasis
  double* scal;  // 2
};

// z = P_f r for one field's block (FastDiagFieldSolver.solve, K6) on every
// block of the cluster: identity on the boundary (left to the caller), the
// fast-diag interior solve with field f's mode scales (the consistent
// eigenbasis on quad/hex meshes, the lumped one on tri/tet). `in` is complete
// in device memory; the interior of `out` is, when this returns.
//
// The 2d axis passes run as 2d - 1 phases, one cluster barrier each: the
// forward passes along x (and y in 3D), then along the last axis forward,
// the division by the mode scales and back (all three stay on one line),
// then the inverse passes. In a phase a block takes the lines l = b + nb m
// along its axis: it stages them in shared memory (past L1: other blocks
// wrote them) and each thread computes one output column of four lines at
// once, so one load of S feeds four sums; S is the block's shared-memory
// copy (each distinct matrix once) where it fits. The sums run in another
// order than the twin's torch.matmul: K6 agrees with its twin to rounding.
template <int D>
__device__ void fastdiag_cluster(const PcView& pv, const FieldPcg& fp, int f, const double* in, double* out,
                                 const Grid& g) {
  const int na[3] = {g.nx - 2, g.ny - 2, D == 3 ? g.nz - 2 : 1};
  const int st[3] = {1, na[0], na[0] * na[1]};
  const int nint = pv.nint, nb = fp.o.nb, b = fp.o.b;
  const double* S[3] = {pv.d.Sx, pv.d.Sy, pv.d.Sz};
  if (fp.sm != nullptr) {
    const double* src[3] = {S[0], S[1], S[2]};
    double* dst = fp.sm;
    for (int a = 0; a < D; ++a) {
      int same = -1;
      for (int a2 = 0; a2 < a; ++a2) {
        if (src[a2] == src[a]) same = a2;
      }
      if (same >= 0) {
        S[a] = S[same];
        continue;
      }
      for (int e = threadIdx.x; e < na[a] * na[a]; e += blockDim.x) dst[e] = __ldg(src[a] + e);
      S[a] = dst;
      dst += na[a] * na[a];
    }
  }
  const double* sc = pv.d.sc + (size_t)f * nint;
  double* L0 = fp.lb;
  double* L1 = fp.lb + fp.lines * fp.nmax;
  const double* from = in;
  for (int ph = 0; ph < 2 * D - 1; ++ph) {
    const int a = ph < D ? ph : 2 * D - 2 - ph;
    const int n_a = na[a], s_a = st[a], nl = nint / n_a;
    const int mine = nl > b ? (nl - b + nb - 1) / nb : 0;
    const bool last = ph == 2 * D - 2;
    double* to = last ? out : (ph % 2 == 0 ? fp.t1 : fp.t2);
    auto base = [&](int m) {
      const int l = b + nb * m;
      return l % s_a + (l / s_a) * s_a * n_a;
    };
    for (int idx = threadIdx.x; idx < mine * n_a; idx += blockDim.x) {
      const int m = idx / n_a, p = idx - m * n_a, q = base(m) + p * s_a;
      L0[idx] = __ldcg(from + (ph == 0 ? interior_to_node<D>(g, q) : q));
    }
    __syncthreads();
    const double* Sa = S[a];
    // emit(m, c, v) for output c of line m: sum_p S[p][c] line[p] (forward)
    // or S[c][p] line[p] (inverse)
    auto product = [&](const double* lin, bool fwd, auto emit) {
      const int groups = (mine + 3) / 4;
      for (int t = threadIdx.x; t < groups * n_a; t += blockDim.x) {
        const int c = t % n_a, m0 = (t / n_a) * 4;
        const double* l[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) l[u] = lin + (m0 + u < mine ? m0 + u : mine - 1) * n_a;
        double acc[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll 4
        for (int p = 0; p < n_a; ++p) {
          const double sv = fwd ? Sa[p * n_a + c] : Sa[c * n_a + p];
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[u] = fma(sv, l[u][p], acc[u]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (m0 + u < mine) emit(m0 + u, c, acc[u]);
        }
      }
    };
    if (ph == D - 1) {
      product(L0, true, [&](int m, int c, double v) { L1[m * n_a + c] = v / sc[base(m) + c * s_a]; });
      __syncthreads();
      product(L1, false, [&](int m, int c, double v) { to[base(m) + c * s_a] = v; });
    } else {
      product(L0, ph < D, [&](int m, int c, double v) {
        const int q = base(m) + c * s_a;
        to[last ? interior_to_node<D>(g, q) : q] = v;
      });
    }
    cg::this_cluster().sync();
    from = to;
  }
}

// zbuf = M in for field f's block, complete in device memory afterwards; `in`
// is complete in device memory. K8: the ILU(0) sweeps on block 0, while the
// other blocks wait at the cluster barrier (2D fields: the line pipeline,
// which reads `in` directly; else the ring); K6: the fast-diag transform on
// every block.
template <int D, int PC>
__device__ void field_pc(const PcView& pv, const FieldPcg& fp, int f, const double* in, const Grid& g) {
  if constexpr (PC == kPcFieldsplitIlu) {
    if (fp.o.b == 0) {
      const double* PL = f == 0 ? pv.d.F0L : pv.d.F1L;
      const double* PU = f == 0 ? pv.d.F0U : pv.d.F1U;
      bool lines = false;
      if constexpr (D == 2) {
        if (pv.line_warps > 0) {
          line_sweep_pair(f == 0 ? pv.d.L0L : pv.d.L1L, f == 0 ? pv.d.L0U : pv.d.L1U, in, fp.t2, fp.zbuf, pv.edges,
                          g.nx, g.ny, pv.line_warps);
          lines = true;
        }
      }
      if (!lines) {
        // the ring reads its right-hand side through L1: a copy of this block's own
        for (int e = threadIdx.x; e < fp.n; e += blockDim.x) fp.t1[e] = __ldcg(in + e);
        ilu_apply<kFieldOffsets<D>>(PL, PU, fp.n, pv.tab->meta, pv.st, pv.d.level_rows, pv.d.nlev, fp.t1, fp.t2,
                                    fp.zbuf);
      }
    }
    cg::this_cluster().sync();
  } else {
    fastdiag_cluster<D>(pv, fp, f, in, fp.zbuf, g);
  }
}

// The inner block solve of the fieldsplit roles (pallas_gmres.py:1416-1474,
// FusedGMRESSolver._inner_pcg): PCG on field f's block from x = 0, z0 = M
// rhs, stopping on ||r|| <= max(rtol ||rhs||, atol) or a non-finite norm.
// Every thread of every block calls it; rhs (n values) is complete in device
// memory, and so is xout after the caller's next cluster barrier. Each
// iteration crosses the cluster barrier for p, for the dot <p, A p>, for r,
// inside the preconditioner, for z and for the dots <z, r> and <r, r> (one
// tree of two rows).
// Not inlined into the frame: it gets registers of its own rather than the
// frame's spilled ones, and takes what it reads into locals at entry (after
// a barrier, anything read through a reference would be loaded again).
template <int D, int PC>
__device__ __noinline__ void inner_pcg(const PcView& pv_in, const FieldPcg& fp_in, int f, const double* rhs,
                                       double* xout, const Grid g, const GmresParams& prm, Reducer& rd_in,
                                       double* sh) {
  PERPHIL_PROF(kProfApply);
  const PcView pv = pv_in;
  const FieldPcg fp = fp_in;
  Reducer rd = rd_in;
  const double in_rtol = prm.in_rtol, in_atol = prm.in_atol;
  const int in_max = prm.in_max;
  const double* const wf = pv.tab->sw[f];
  const int n = fp.n;
  auto own = [&](auto fn) {
    for (int s = 0; s < (1 << fp.o.log_s); ++s) {
      const int i = fp.o.slot(s), e = fp.o.elem(i);
      if (e < n) fn(i, e);
    }
  };
  auto tree = [&](int rows, auto val) {
    cluster_tree_rows(rd, fp.o, rows, sh, [&](int k, int s) {
      const int i = fp.o.slot(s), e = fp.o.elem(i);
      return e < n ? val(k, i) : 0.0;
    });
  };
  // z = M v for the slices (v: the slice that fed the preconditioner)
  auto take_z = [&](const double* v) {
    own([&](int i, int e) {
      bool pass = false;  // K6 leaves the boundary rows to the identity
      if (PC == kPcFieldsplitLu) {
        int k, j, i2;
        coords<D>(g, e, k, j, i2);
        pass = on_boundary<D>(g, k, j, i2);
      }
      fp.zs[i] = pass ? v[i] : __ldcg(fp.zbuf + e);
    });
  };
  own([&](int i, int e) { fp.rs[i] = __ldcg(rhs + e); });
  tree(1, [&](int, int i) { return __dmul_rn(fp.rs[i], fp.rs[i]); });
  const double rn0 = __dsqrt_rn(sh[0]);
  const double t_rel = __dmul_rn(rn0, in_rtol);
  const double tol = t_rel > in_atol ? t_rel : in_atol;
  PERPHIL_PROF(kProfInDots);
  field_pc<D, PC>(pv, fp, f, rhs, g);
  take_z(fp.rs);
  PERPHIL_PROF(kProfInPc);
  tree(1, [&](int, int i) { return __dmul_rn(fp.zs[i], fp.rs[i]); });
  double rz = sh[0];
  own([&](int i, int) {
    fp.xs[i] = 0.0;
    fp.ps[i] = fp.zs[i];
  });
  bool done = !(rn0 > tol);
  int its = 0;
  PERPHIL_PROF(kProfInDots);
  while (!done && its < in_max) {
    own([&](int i, int e) { fp.pbuf[e] = fp.ps[i]; });
    cg::this_cluster().sync();
    if (fp.pfull != nullptr) {
      for (int e = threadIdx.x; e < n; e += blockDim.x) fp.pfull[e] = __ldcg(fp.pbuf + e);
      __syncthreads();
      own([&](int i, int e) { fp.aps[i] = field_apply_ordered<D, false>(fp.pfull, wf, g, e); });
    } else {
      own([&](int i, int e) { fp.aps[i] = field_apply_ordered<D, true>(fp.pbuf, wf, g, e); });
    }
    PERPHIL_PROF(kProfInMatvec);
    tree(1, [&](int, int i) { return __dmul_rn(fp.ps[i], fp.aps[i]); });
    const double alpha = __ddiv_rn(rz, sh[0]);
    PERPHIL_PROF(kProfInDots);
    own([&](int i, int e) {
      fp.xs[i] = __dadd_rn(fp.xs[i], __dmul_rn(alpha, fp.ps[i]));
      fp.rs[i] = __dsub_rn(fp.rs[i], __dmul_rn(alpha, fp.aps[i]));
      fp.rbuf[e] = fp.rs[i];
    });
    PERPHIL_PROF(kProfInUpdate);
    cg::this_cluster().sync();
    field_pc<D, PC>(pv, fp, f, fp.rbuf, g);
    take_z(fp.rs);
    PERPHIL_PROF(kProfInPc);
    tree(2, [&](int k, int i) { return k == 0 ? __dmul_rn(fp.zs[i], fp.rs[i]) : __dmul_rn(fp.rs[i], fp.rs[i]); });
    const double rz_new = sh[0], rn = __dsqrt_rn(sh[1]);
    const double beta = __ddiv_rn(rz_new, rz);
    PERPHIL_PROF(kProfInDots);
    own([&](int i, int) { fp.ps[i] = __dadd_rn(fp.zs[i], __dmul_rn(beta, fp.ps[i])); });
    rz = rz_new;
    ++its;
    done = !(rn > tol) || !isfinite(rn);
    PERPHIL_PROF(kProfInUpdate);
  }
  own([&](int i, int e) { xout[e] = fp.xs[i]; });
  if (threadIdx.x == 0) {
    fp.counts[0] += its;
    fp.counts[1] += 1;
  }
  rd_in = rd;
}

// K8's literal inner block solve (FusedGMRESSolver._inner_gmres, the JAX
// package's native _block_solver): krylov.gmres on field f's block from x =
// 0, left-preconditioned by the field's ILU(0), GMRES(in_restart) with the
// frame's arithmetic: CGS with the j + 1 dots of a step in one tree, the
// update w -= sum_k h[k] V_k in tree_sum's order over the rows, the Givens
// chain and back-substitution on thread 0 rounding each operation, and
// PETSc's stopping tests (max(rtol ||P rhs||, atol), max_it, divergence at
// in_dtol ||P rhs||, a non-finite estimate, a cycle with no step). The twin
// computes P(rhs - A 0) twice before its first cycle, this once (the same
// bits). Every thread of every block calls it; rhs (n values) is complete in
// device memory, and so is xout after the caller's next cluster barrier.
// A step crosses the cluster barrier for the basis vector, for A v (the
// sweep's input), inside the preconditioner, in the dots' and the norm's
// trees and for the new basis vector. The basis lives in device memory (own
// values read back by their owner, whole vectors past L1); each block's
// thread 0 keeps R, g, cs and sn in its piece of device scratch.
template <int D, int PC>
__device__ __noinline__ void inner_gmres(const PcView& pv_in, const FieldPcg& fp_in, int f, const double* rhs,
                                         double* xout, const Grid g, const GmresParams& prm, Reducer& rd_in,
                                         const FrameScalars& fs_in) {
  PERPHIL_PROF(kProfApply);
  const PcView pv = pv_in;
  const FieldPcg fp = fp_in;
  const FrameScalars fs = fs_in;
  Reducer rd = rd_in;
  const double rtol = prm.in_rtol, atol = prm.in_atol, dtol = prm.in_dtol;
  const int max_it = prm.in_max, m = prm.in_restart;
  const double* const wf = pv.tab->sw[f];
  const int n = fp.n;
  const size_t ldv = (size_t)n;
  double* const V = fp.vin;
  double* const R = fp.gstate + (size_t)fp.o.b * kInnerStateDoubles;  // R[column * kMaxBasis + row]
  double* const gv = R + kMaxBasis * kMaxBasis;
  double* const cs = gv + kMaxBasis + 1;
  double* const sn = cs + kMaxBasis;
  auto own = [&](auto fn) {
    for (int s = 0; s < (1 << fp.o.log_s); ++s) {
      const int i = fp.o.slot(s), e = fp.o.elem(i);
      if (e < n) fn(i, e);
    }
  };
  auto tree = [&](int rows, double* out, auto val) {
    cluster_tree_rows(rd, fp.o, rows, out, [&](int k, int s) {
      const int i = fp.o.slot(s), e = fp.o.elem(i);
      return e < n ? val(k, i, e) : 0.0;
    });
  };
  // zs = P(A v), or P(sub - A v) where sub is given: v complete in device
  // memory behind a cluster barrier
  auto apply = [&](const double* v, const double* sub) {
    if (fp.pfull != nullptr) {
      for (int e = threadIdx.x; e < n; e += blockDim.x) fp.pfull[e] = __ldcg(v + e);
      __syncthreads();
    }
    own([&](int, int e) {
      double a = fp.pfull != nullptr ? field_apply_ordered<D, false>(fp.pfull, wf, g, e)
                                     : field_apply_ordered<D, true>(v, wf, g, e);
      if (sub != nullptr) a = __dsub_rn(__ldcg(sub + e), a);
      fp.rbuf[e] = a;
    });
    PERPHIL_PROF(kProfInMatvec);
    cg::this_cluster().sync();
    field_pc<D, PC>(pv, fp, f, fp.rbuf, g);
    own([&](int i, int e) { fp.zs[i] = __ldcg(fp.zbuf + e); });
    PERPHIL_PROF(kProfInPc);
  };
  // ||zs||
  auto norm = [&]() {
    tree(1, fs.scal, [&](int, int i, int) { return __dmul_rn(fp.zs[i], fp.zs[i]); });
    PERPHIL_PROF(kProfInDots);
    return __dsqrt_rn(fs.scal[0]);
  };
  // x = 0, and the twin's first residual P(rhs - A 0)
  own([&](int i, int e) {
    fp.xs[i] = 0.0;
    fp.pbuf[e] = 0.0;
  });
  cg::this_cluster().sync();
  apply(fp.pbuf, rhs);
  double beta = norm();
  const double t_rel = __dmul_rn(rtol, beta);
  const double tol = atol > t_rel ? atol : t_rel;  // Python's max(rtol * rnorm, atol)
  const double div = __dmul_rn(dtol, beta);
  const double tol0 = 0.0 > tol ? 0.0 : tol;
  double rnorm = beta;
  bool done = rnorm <= tol;
  int its = 0;
  bool first = true;
  while (!done) {
    if (!first) {
      // r = P(rhs - A x): x to device memory for the matvec
      own([&](int i, int e) { fp.pbuf[e] = fp.xs[i]; });
      cg::this_cluster().sync();
      apply(fp.pbuf, rhs);
      beta = norm();
    }
    first = false;
    own([&](int i, int e) { V[e] = beta > 0.0 ? __ddiv_rn(fp.zs[i], beta) : fp.zs[i]; });
    if (threadIdx.x == 0) {
      gv[0] = beta;
      for (int i = 1; i <= m; ++i) gv[i] = 0.0;
    }
    cg::this_cluster().sync();
    PERPHIL_PROF(kProfInUpdate);
    int j = 0;
    rnorm = beta;
    while (j < m && its < max_it && rnorm > tol0 && rnorm <= div) {
      const double* const vj = V + j * ldv;
      double* const vn = V + (j + 1) * ldv;
      apply(vj, nullptr);
      // h[k] = <V_k, w>, k <= j: one pass over w
      tree(j + 1, fs.h, [&](int k, int i, int e) { return __dmul_rn(V[k * ldv + e], fp.zs[i]); });
      PERPHIL_PROF(kProfInDots);
      // w -= sum_k h[k] V_k (classical Gram-Schmidt), then ||w||^2
      own([&](int i, int e) {
        fp.zs[i] = __dsub_rn(fp.zs[i], basis_comb(fs.h, j + 1, [&](int k) { return V[k * ldv + e]; }));
      });
      PERPHIL_PROF(kProfInUpdate);
      const double hj1 = norm();
      if (threadIdx.x == 0) {
        // the stored rotations, then the new one zeroing h[j+1]
        double* const h = fs.h;
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
        for (int i = 0; i <= j; ++i) R[j * kMaxBasis + i] = h[i];
        const double gj = gv[j];
        gv[j] = __dmul_rn(c, gj);
        gv[j + 1] = __dmul_rn(-s, gj);
        fs.scal[1] = fabs(gv[j + 1]);
      }
      PERPHIL_PROF(kProfInGivens);
      own([&](int i, int e) { vn[e] = hj1 > 0.0 ? __ddiv_rn(fp.zs[i], hj1) : fp.zs[i]; });
      cg::this_cluster().sync();
      rnorm = fs.scal[1];  // rewritten only after the next step's barriers
      ++j;
      ++its;
      PERPHIL_PROF(kProfInUpdate);
    }
    if (j > 0) {
      if (threadIdx.x == 0) {
        // R[:j, :j] y = g[:j], rows from the bottom, each sum left to right
        for (int i = j - 1; i >= 0; --i) {
          double s = gv[i];
          for (int k = i + 1; k < j; ++k) s = __dsub_rn(s, __dmul_rn(R[k * kMaxBasis + i], fs.y[k]));
          fs.y[i] = __ddiv_rn(s, R[i * kMaxBasis + i]);
        }
      }
      __syncthreads();
      own([&](int i, int e) {
        fp.xs[i] = __dadd_rn(fp.xs[i], basis_comb(fs.y, j, [&](int k) { return V[k * ldv + e]; }));
      });
      PERPHIL_PROF(kProfInGivens);
    }
    done = rnorm <= tol || its >= max_it || rnorm > div || !isfinite(rnorm) || j == 0;
  }
  own([&](int i, int e) { xout[e] = fp.xs[i]; });
  if (threadIdx.x == 0) {
    fp.counts[0] += its;
    fp.counts[1] += 1;
  }
  rd_in = rd;
}

// The preconditioners with a block solve (K6-K8): out = P t, t (2n, device
// memory) the operator's output, complete behind a cluster barrier; out is
// complete after the caller's next one. K7 sweeps on block 0; the fieldsplit
// roles' inner block solves (PCG, or K8's literal GMRES where in_restart >
// 0) run on every block. The scratch behind t in PcData::work: K7 2n of y
// and 2n for a copy of t; K6/K8 FieldPcg's buffers.
template <int D, int PC>
__device__ void apply_block_pc(double* t, double* out, const Grid& g, const PcView& pv, const FieldPcg& fp,
                               int block, const GmresParams& prm, Reducer& rd, const FrameScalars& fs) {
  const int n = pv.n;
  if constexpr (PC == kPcIlu) {
    if (block == 0) {
      // the ring reads its right-hand side through L1: a copy of this block's own
      double* tc = t + 4 * n;
      for (int e = threadIdx.x; e < 2 * n; e += blockDim.x) tc[e] = __ldcg(t + e);
      ilu_apply<kMonolithicOffsets<D>>(pv.d.F0L, pv.d.F0U, 2 * n, pv.tab->meta, pv.st, pv.d.level_rows, pv.d.nlev,
                                        tc, t + 2 * n, out);
    }
  } else {
    // multiplicative fieldsplit: y1 = B0 t1, y2 = B1 (t2 - C y1)
    auto block_solve = [&](int f, const double* rhs, double* x) {
      if constexpr (PC == kPcFieldsplitIlu) {
        if (prm.in_restart > 0) {
          inner_gmres<D, PC>(pv, fp, f, rhs, x, g, prm, rd, fs);
          return;
        }
      }
      inner_pcg<D, PC>(pv, fp, f, rhs, x, g, prm, rd, fs.scal);
    };
    block_solve(0, t, out);
    cg::this_cluster().sync();
    for (int s = 0; s < (1 << fp.o.log_s); ++s) {
      const int e = fp.o.elem(fp.o.slot(s));
      if (e < n) t[n + e] = __dsub_rn(__ldcg(t + n + e), coupling_at<D>(out, pv.tab->mass, prm.coef, g, e));
    }
    cg::this_cluster().sync();
    block_solve(1, t + n, out + n);
  }
}

template <int D, int PC>
__global__ void __launch_bounds__(kGmresThreads, 1)
fused_gmres_kernel(const double* b, const double* x0, double* x, double* V, double* xchg,
                   double* result, DppWeights<double> w, Grid g, GmresParams prm, PcData pd,
                   PcTables tables, GmresGeom geom) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ double part[kMaxBasis][64];
  __shared__ double R[kMaxBasis][kMaxBasis];  // R[column][row]
  __shared__ double h[kMaxBasis + 1], gv[kMaxBasis + 1], cs[kMaxBasis], sn[kMaxBasis],
      y[kMaxBasis], scal[2];
  __shared__ int inner_counts[2];
  __shared__ PcTables tab;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#ifdef PERPHIL_GMRES_PROFILE
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
  // vector (the fieldsplit roles' inner PCG takes the same region while the
  // preconditioner runs), the block's basis slice
  const bool vs = geom.basis_smem != 0;
  double* Zs = reinterpret_cast<double*>(dyn + geom.ilu.bytes);
  double* Vs = reinterpret_cast<double*>(dyn + geom.ilu.bytes + geom.pc_bytes);
  const int ldS = geom.nloc;
  if (tid == 0) {
    if (PC >= kPcFieldsplitLu) tab = tables;
    inner_counts[0] = inner_counts[1] = 0;
  }
  __syncthreads();
  const int nint = (g.nx - 2) * (g.ny - 2) * (D == 3 ? g.nz - 2 : 1);
  PcView pv{pd, &tab, IluStage{}, nullptr, (int)n, nint, geom.line_warps};
  if (geom.line_warps > 0) {
    pv.edges = reinterpret_cast<double*>(dyn);
  } else if ((PC == kPcIlu || PC == kPcFieldsplitIlu) && o.b == 0) {
    pv.st = ilu_stage(geom.ilu, dyn, pd.level_ptr, PC == kPcIlu ? L : (int)n, pd.nlev);
  }
  FieldPcg fp{};
  if constexpr (PC == kPcFieldsplitLu || PC == kPcFieldsplitIlu) {
    fp.o = Own{o.b, o.nb, o.lam, geom.log_sf};
    fp.n = (int)n;
    fp.lines = geom.lines;
    fp.nmax = geom.nmax;
    const int nl = geom.nlocf;
    fp.xs = Zs;
    fp.rs = Zs + nl;
    fp.zs = Zs + 2 * nl;
    fp.ps = Zs + 3 * nl;
    fp.aps = Zs + 4 * nl;
    fp.lb = Zs + 5 * nl;
    double* extra = fp.lb + 2 * geom.lines * geom.nmax;  // p's copy, or the eigenbases'
    fp.pfull = geom.p_smem ? extra : nullptr;
    fp.sm = geom.s_smem ? extra : nullptr;
    fp.pbuf = pd.work + 2 * n;
    fp.rbuf = fp.pbuf + n;
    fp.zbuf = fp.rbuf + n;
    fp.t1 = fp.zbuf + n;
    fp.t2 = fp.t1 + n;
    fp.vin = pd.work + 10 * n;
    fp.gstate = fp.vin + (size_t)(prm.in_restart + 1) * n;
    fp.counts = inner_counts;
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
      apply_block_pc<D, PC>(pd.work, V + k * ld, g, pv, fp, o.b, prm, rd, FrameScalars{h, y, scal});
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
    result[7] = (double)geom.p_smem;
    result[8] = (double)geom.s_smem;
    result[9] = (double)inner_counts[0];
    result[10] = (double)inner_counts[1];
    result[11] = (double)geom.line_warps;
#ifdef PERPHIL_GMRES_PROFILE
    PERPHIL_PROF(kProfRestart);
    for (int i = 0; i < kProfPhases; ++i) result[kResultSlots + i] = (double)prof[i];
    for (int i = 0; i < kLineProfSlots; ++i) {
      result[kResultSlots + kProfPhases + i] = (double)line_prof[i];
      line_prof[i] = 0;
    }
#endif
  }
}

// The geometry for L = 2n values within kGmresSmemBudget bytes of dynamic
// shared memory; false where the leaves per thread exceed the frame's tree or the
// fieldsplit roles' slices do not fit. In order: the fieldsplit roles' slices
// and K6's line buffers (needed), the ILU stage (K7, K8), the matvec's input
// copy, then in the same region p's copy and K6's eigenbases (the inner PCG
// uses it while the input copy is dead), then the basis slice.
template <int PC>
bool plan_geometry(const GmresArgs& a, GmresGeom& geo) {
  const long budget = kGmresSmemBudget;
  constexpr bool fields = PC == kPcFieldsplitLu || PC == kPcFieldsplitIlu;
  const long n = a.g.nodes(), L = 2 * n;
  geo = GmresGeom{};
  geo.nb = gmres_blocks(L);
  while ((1 << geo.log_nb) < geo.nb) ++geo.log_nb;
  while (((long)kGmresThreads * geo.nb << geo.log_s) < L) ++geo.log_s;
  if (geo.log_s > kMaxLogS) return false;
  const long piece = 4L * geo.nb;
  geo.nloc = (int)(4 * (L / piece) + (L % piece < 4 ? L % piece : 4));
  long pc_min = 0, sbytes = 0;
  if (fields) {
    while (((long)kGmresThreads * geo.nb << geo.log_sf) < n) ++geo.log_sf;
    if (geo.log_sf > kMaxLogS) return false;
    geo.nlocf = (int)(4 * (n / piece) + (n % piece < 4 ? n % piece : 4));
    pc_min = 5L * geo.nlocf * 8;
  }
  if (PC == kPcFieldsplitLu) {
    const int na[3] = {a.g.nx - 2, a.g.ny - 2, a.dim == 3 ? a.g.nz - 2 : 1};
    const double* S[3] = {a.pd.Sx, a.pd.Sy, a.pd.Sz};
    const long nint = (long)na[0] * na[1] * na[2];
    for (int ax = 0; ax < a.dim; ++ax) {
      const int lines = (int)((nint / na[ax] + geo.nb - 1) / geo.nb);
      geo.lines = lines > geo.lines ? lines : geo.lines;
      geo.nmax = na[ax] > geo.nmax ? na[ax] : geo.nmax;
      bool seen = false;
      for (int a2 = 0; a2 < ax; ++a2) seen = seen || S[a2] == S[ax];
      if (!seen) sbytes += 8L * na[ax] * na[ax];
    }
    pc_min += 16L * geo.lines * geo.nmax;
  }
  long used = 0;
  if (PC == kPcIlu || PC == kPcFieldsplitIlu) {
    const int nt = PC == kPcIlu ? (a.dim == 2 ? kMonolithicOffsets<2> : kMonolithicOffsets<3>)
                                : (a.dim == 2 ? kFieldOffsets<2> : kFieldOffsets<3>);
    if (nt > 0 && (a.tab.meta.nlow != nt || a.tab.meta.nup != nt)) return false;
    if (PC == kPcFieldsplitIlu && a.pd.L0L != nullptr && a.pd.L0U != nullptr && a.pd.L1L != nullptr &&
        a.pd.L1U != nullptr) {
      geo.line_warps = line_warps(a.tab.meta, a.dim, a.g.nx, a.g.ny, a.pd.nlev);
      // where the pipeline's rings leave the slices no room, the ring sweep (which shrinks to fit) runs
      if ((line_bytes(geo.line_warps, a.g.nx) + 15) / 16 * 16 + (pc_min + 15) / 16 * 16 > budget) geo.line_warps = 0;
    }
    if (geo.line_warps > 0) {
      geo.ilu.bytes = (int)((line_bytes(geo.line_warps, a.g.nx) + 15) / 16 * 16);
    } else {
      geo.ilu = ilu_plan(a.tab.meta, (int)(PC == kPcIlu ? L : n), a.pd.nlev, a.max_level_rows, budget - pc_min);
    }
    used = geo.ilu.bytes;
  }
  pc_min = (pc_min + 15) / 16 * 16;  // the basis slice after the region starts on 16 bytes
  auto grow = [&](long& x, long need) {
    need = (need + 15) / 16 * 16;
    if (used + (need > x ? need : x) > budget) return false;
    x = need > x ? need : x;
    return true;
  };
  long x = pc_min;
  if (used + x > budget) return false;
  geo.z_smem = grow(x, 8 * L);  // the matvec's input first (it saves the most L2 traffic)
  if (fields) geo.p_smem = grow(x, pc_min + 8 * n);
  if (PC == kPcFieldsplitLu) geo.s_smem = grow(x, pc_min + sbytes);
  geo.pc_bytes = (int)x;
  used += x;
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
  // the plan's budget is the gate's; a kernel that leaves less refuses
  if (kMaxSmemPerBlock - (long)fa.sharedSizeBytes < kGmresSmemBudget) return cudaErrorLaunchOutOfResources;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  GmresGeom geo;
  if (!plan_geometry<PC>(a, geo)) return cudaErrorInvalidValue;
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

template <int PC>
int fused_gmres_static_smem(int dim) {
  cudaFuncAttributes fa;
  const cudaError_t err = dim == 3 ? cudaFuncGetAttributes(&fa, fused_gmres_kernel<3, PC>)
                                   : cudaFuncGetAttributes(&fa, fused_gmres_kernel<2, PC>);
  return err == cudaSuccess ? (int)fa.sharedSizeBytes : -1;
}

}  // namespace perphil
