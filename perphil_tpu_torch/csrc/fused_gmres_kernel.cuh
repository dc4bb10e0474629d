// The fused GMRES kernel (see fused_gmres.cuh): device functions, the kernel
// template and its launcher, included by one fused_gmres_pc_*.cu per
// preconditioner.
#pragma once

#include "fused_gmres.cuh"

namespace perphil {

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

// <u, v> over L values as one halving tree; every thread receives it. Begins
// with a barrier, so u and v may have been written just before.
__device__ inline double block_dot(const double* u, const double* v, int L, int log_j,
                            double (*red)[kGmresThreads], double* out) {
  __syncthreads();
  TreeAcc acc;
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
      ilu_apply(f == 0 ? pv.d.F0 : pv.d.F1, n, pv.tab->meta, pv.d.level_ptr, pv.d.level_rows,
                pv.d.nlev, in, ys, out);
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

// out = P(A z), or out = P(b - A z) when b is given. out never aliases z or b.
template <int D, int PC>
__device__ void apply_op(const double* z, const double* b, double* out, const DppWeights<double>& w,
                         const Grid& g, const PcView& pv, const GmresParams& prm,
                         double (*red)[kGmresThreads], double* sh) {
  const long n = g.nodes();
  if constexpr (PC == kPcNone || PC == kPcJacobi) {
    for (long idx = threadIdx.x; idx < n; idx += blockDim.x) {
      double y1, y2;
      dpp_apply_ordered<D>(z, z + n, w, g, idx, y1, y2);
      if (b != nullptr) {
        y1 = __dsub_rn(b[idx], y1);
        y2 = __dsub_rn(b[n + idx], y2);
      }
      if (PC == kPcJacobi) {
        y1 = __dmul_rn(pv.d.dinv[idx], y1);
        y2 = __dmul_rn(pv.d.dinv[n + idx], y2);
      }
      out[idx] = y1;
      out[n + idx] = y2;
    }
  } else {
    double* t = pv.d.work;  // 2n: the operator's output, the preconditioner's input
    for (long idx = threadIdx.x; idx < n; idx += blockDim.x) {
      double y1, y2;
      dpp_apply_ordered<D>(z, z + n, w, g, idx, y1, y2);
      if (b != nullptr) {
        y1 = __dsub_rn(b[idx], y1);
        y2 = __dsub_rn(b[n + idx], y2);
      }
      t[idx] = y1;
      t[n + idx] = y2;
    }
    __syncthreads();
    if constexpr (PC == kPcIlu) {
      ilu_apply(pv.d.F0, (int)(2 * n), pv.tab->meta, pv.d.level_ptr, pv.d.level_rows, pv.d.nlev,
                t, t + 2 * n, out);
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

template <int D, int PC>
__global__ void __launch_bounds__(kGmresThreads)
fused_gmres_kernel(const double* b, const double* x0, double* x, double* V, double* result,
                   DppWeights<double> w, Grid g, GmresParams prm, PcData pd, PcTables tables) {
  __shared__ double red[kRowChunk][kGmresThreads];
  __shared__ double R[kMaxBasis][kMaxBasis];  // R[column][row]
  __shared__ double h[kMaxBasis + 1], gv[kMaxBasis + 1], cs[kMaxBasis], sn[kMaxBasis],
      y[kMaxBasis], scal[kRowChunk], pcs[1];
  __shared__ PcTables tab;
  const int tid = threadIdx.x;
  const int L = (int)(2 * g.nodes());
  const size_t ld = L;
  const int m = prm.restart, log_j = prm.log_j, leaves = 1 << log_j;
  if (PC >= kPcFieldsplitLu && tid == 0) tab = tables;
  const int nint = (g.nx - 2) * (g.ny - 2) * (D == 3 ? g.nz - 2 : 1);
  const PcView pv{pd, &tab, (int)g.nodes(), nint};

  for (int e = tid; e < L; e += blockDim.x) x[e] = x0[e];
  __syncthreads();

  double tol = 0.0, div = 0.0, rnorm = 0.0;
  int its = 0;
  bool first = true;
  for (;;) {
    // r = P(b - A x) into V[0], beta = ||r||
    apply_op<D, PC>(x, b, V, w, g, pv, prm, red, pcs);
    const double beta = __dsqrt_rn(block_dot(V, V, L, log_j, red, scal));
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
      apply_op<D, PC>(V + j * ld, nullptr, wv, w, g, pv, prm, red, pcs);
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

template <int PC>
void launch_fused_gmres(const GmresArgs& a, cudaStream_t st) {
  if (a.dim == 3) {
    fused_gmres_kernel<3, PC><<<1, kGmresThreads, 0, st>>>(a.b, a.x0, a.x, a.V, a.result, a.w, a.g,
                                                          a.prm, a.pd, a.tab);
  } else {
    fused_gmres_kernel<2, PC><<<1, kGmresThreads, 0, st>>>(a.b, a.x0, a.x, a.V, a.result, a.w, a.g,
                                                          a.prm, a.pd, a.tab);
  }
}

}  // namespace perphil
