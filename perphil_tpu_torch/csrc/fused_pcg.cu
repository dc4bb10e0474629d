// K3: the whole simplicial direct-role solve, PCG to machine tolerance, in one
// thread block whose shared memory holds the working set.
//
// Replaces perphil_tpu/ops/pallas_direct.py::fused_simplicial_direct_solve
// (:491; _build_simplicial_pcg :286, pallas_call :469): double-float PCG to
// rtol 1e-13 (at most 2000 iterations), preconditioned per field by the
// lumped-tensor fast-diagonalization on the interior with identity boundary
// rows (pallas_direct.py:338-357), stopping on convergence or a non-finite
// residual. What it computes is ops/krylov.py::cg with
// LumpedDPPPreconditioner (FusedSimplicialSolver.plain), in native f64.
//
// Bound on the H100: latency. An iteration is a stencil matvec, 2 d small
// dense transform passes and three dot products over a few thousand values:
// a few microseconds of dependent steps and block barriers, no traffic to
// speak of. The design keeps every step inside one SM where one block's
// shared memory holds the working set, and inside one thread block cluster
// where it does not (direct_smem.cuh has the plan and the shared device
// code):
//   - Shared memory holds p (node layout, zero on the boundary), r, z and a
//     transform buffer on the interior, and on one block the mode scales'
//     inverses and the eigenbases, staged once with cp.async (a cluster
//     spreads the vectors over its blocks and reads the rest from device
//     memory). Each thread owns interior nodes of both fields and keeps x
//     and r in registers; A p goes to the r buffer (free until r is written
//     back) and back. Device memory is read for b and written for x.
//   - On the smallest meshes (64 threads: nint <= 32) the preconditioner is
//     one dense matrix a field, built on the host from the same eigenbases:
//     one phase instead of 2 d passes and their barriers.
//   - The boundary rows are identity rows of A and of the preconditioner,
//     and no interior row reads them, so on the boundary r, p and x stay
//     multiples of b: r_b = rho b_b, p_b = pi b_b, x_b = xi b_b, and the
//     boundary's part of each dot is rho^2 (or pi^2) ||b_b||^2. Three
//     scalars carry it through the loop; the boundary is walked at entry
//     (||b_b||^2) and at exit (x_b = xi b_b).
//   - An iteration crosses 2 d + 3 barriers: p complete; <p, A p>; r
//     written; then one after each transform pass. The r update writes r
//     straight into the interior layout the first pass reads; the last
//     forward pass scales by the mode scales' inverses (taken once, on the
//     host: a multiply rounds at most once more than the twin's division);
//     the last inverse pass adds its outputs' part of <r, z> as it writes
//     them, so <r, r> and <r, z> are summed together after its barrier;
//     the p update reads z where the pass left it.
//   - The stencil's zero offsets on simplices are skipped by a constant
//     mask (kSimplexOffsets); all indices are 32-bit, divisions by the
//     grid's lengths are multiply-shifts (FastDiv); the block size and the
//     nodes a thread owns are constants of the placement the launcher picks.
// The sums run in another order than the twin's (torch.dot, tensordot), so
// K3 agrees with its twin to rounding and its iteration count within a
// step or two.

#include "direct_smem.cuh"

namespace perphil {

enum PcgRow { kRowPap, kRowRr, kRowRz, kRowBb, kPcgRows };

// Phase clocks (direct_smem.cuh, DirectProf): the loop's phases each end
// after their barrier; kPcgPass + i is transform pass i of the loop's
// preconditioner.
enum PcgPhase { kPcgSetup, kPcgFirstPc, kPcgMatvec, kPcgPap, kPcgUpdate, kPcgPass, kPcgTail = kPcgPass + 6, kPcgEnd };
#ifdef PERPHIL_DIRECT_PROFILE
__device__ unsigned long long pcg_prof[kProfSlots];
#endif

// z = M r on the interior (both fields): the forward passes from R, the
// scaling by the mode scales' inverses (isc) in the last of them, the
// inverse passes, the last into V; returns this thread's part of <r, z>
// over the interior (the caller's barrier ends the last pass). mark(i)
// follows pass i's barrier.
template <int D, int kG, class Team, class Buf, class Mark>
__device__ __forceinline__ double lumped_fastdiag(const Team& tm, const Buf& R, const Buf& U, const Buf& V,
                                                  const double* const* S, const double* isc, const Interior& in,
                                                  Mark mark) {
  double rz = 0.0;
#pragma unroll
  for (int i = 0; i < 2 * D; ++i) {
    const int a = i < D ? i : 2 * D - 1 - i;
    const int lines = 2 * in.nint / (int)in.len[a].d;
    const Buf& src = i == 0 ? R : (i % 2 == 0 ? V : U);
    const Buf& dst = i % 2 == 0 ? U : V;
    if (i < D - 1) {
      line_pass<double, kG, 1, true>(tm, src, S[a], in, a, lines, [&](int q, double v, double) { dst[q] = v; });
    } else if (i == D - 1) {  // times the mode scales' inverses
      line_pass<double, kG, 1, true>(tm, src, S[a], in, a, lines,
                                     [&](int q, double v, double) { dst[q] = v * isc[q]; });
    } else if (i < 2 * D - 1) {
      line_pass<double, kG, 1, false>(tm, src, S[a], in, a, lines, [&](int q, double v, double) { dst[q] = v; });
    } else {
      line_pass<double, kG, 1, false>(tm, src, S[a], in, a, lines, [&](int q, double v, double) {
        dst[q] = v;
        rz = fma(R[q], v, rz);
      });
    }
    if (i < 2 * D - 1) {
      tm.sync();
      mark(i);
    }
  }
  return rz;
}

// z = M r on the interior as one dense product a field (K3's dense
// placement): z_f[q] = sum_j Md_f[j][q] r_f[j] (M is symmetric; reading it
// by columns keeps a warp's lanes on consecutive words), into V; returns
// this thread's part of <r, z> over the interior.
template <int kThreads>
__device__ __forceinline__ double dense_pc(const double* R, double* V, const double* Md, int nint) {
  double rz = 0.0;
  for (int t = threadIdx.x; t < 2 * nint; t += kThreads) {
    const int f = t >= nint, q = t - f * nint;
    const double* m = Md + f * nint * nint + q;
    const double* r = R + f * nint;
    double acc[4] = {0.0, 0.0, 0.0, 0.0};
    int j = 0;
    for (; j + 4 <= nint; j += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[u] = fma(m[(j + u) * nint], r[j + u], acc[u]);
    }
    for (; j < nint; ++j) acc[0] = fma(m[j * nint], r[j], acc[0]);
    const double v = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    V[t] = v;
    rz = fma(R[t], v, rz);
  }
  return rz;
}

template <int D, int kThreads, int kPer, bool kCluster>
__global__ void __launch_bounds__(kThreads, 1)
fused_pcg_kernel(const double* __restrict__ b, double* __restrict__ xo, int* __restrict__ its_out,
                 const double* Sx, const double* Sy, const double* Sz, const double* __restrict__ isc_in,
                 const double* __restrict__ dense_in, DppWeights<double> w, bool simplex, Grid g, Interior in,
                 TeamGeom geo, double rtol, int max_it) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kG = kThreads < kDirectMaxThreads ? 1 : (2 * kPer < 4 ? 2 * kPer : 4);  // lines a pass task
  constexpr bool kDense = kThreads == kDenseThreads && !kCluster;
  using Buf = Spread<double, kCluster>;
  __shared__ double red[kPcgRows][kWarps];
  __shared__ double blk[kPcgRows];  // a cluster's block totals
  extern __shared__ __align__(16) unsigned char smem[];
  const Team<kThreads, kCluster> tm(geo.nb);
  const int n = g.nx * g.ny * g.nz, nint = in.nint, tid = threadIdx.x;
  const int me = tm.thread(), all = tm.size();
  PERPHIL_DIRECT_PROF(DirectProf prof; prof.start());
  auto no_mark = [](int) {};
  // p (node layout, zero on the boundary), r, z and the transform buffer
  // (interior layout): this block's chunks; then, on one block, the mode
  // scales' inverses and the eigenbases, or the dense matrices
  double* base = reinterpret_cast<double*>(smem);
  const int pc = (int)geo.pchunk.d, ic = (int)geo.ichunk.d;
  const Buf P{base, geo.pchunk}, R{base + pc, geo.ichunk}, V{base + pc + ic, geo.ichunk},
      U{base + pc + 2 * ic, geo.ichunk};
  const double* S[3] = {Sx, Sy, Sz};
  const double* isc = isc_in;
  double* Md = base + pc + 2 * ic;
  if constexpr (kDense) {
    stage_async(Md, dense_in, 2 * nint * nint);
  } else if constexpr (!kCluster) {
    double* sc = base + pc + 3 * ic;
    stage_mats<double, D>(sc + 2 * nint, Sx, Sy, Sz, in, S);
    stage_async(sc, isc_in, 2 * nint);
    isc = sc;
  }
  for (int e = tid; e < pc; e += kThreads) base[e] = 0.0;  // this block's chunk of p
  // a cluster: every block running (and its chunk of p zeroed) before any
  // thread touches another block's shared memory
  if constexpr (kCluster) tm.sync();

  int node[kPer];
  double x1[kPer], x2[kPer], r1[kPer], r2[kPer];
  double part = 0.0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int q = me + k * all;
    x1[k] = x2[k] = r1[k] = r2[k] = 0.0;
    node[k] = 0;
    if (q < nint) {
      node[k] = interior_node<D>(g, in, q);
      r1[k] = b[node[k]];
      r2[k] = b[n + node[k]];
      R[q] = r1[k];
      R[nint + q] = r2[k];
      part = fma(r1[k], r1[k], fma(r2[k], r2[k], part));
    }
  }
  warp_partial(part, red[kRowRr], false);
  double bb = 0.0;
  for (int t = me; t < n - nint; t += all) {
    const int e = boundary_node<D>(g, t);
    bb = fma(b[e], b[e], fma(b[n + e], b[n + e], bb));
  }
  warp_partial(bb, red[kRowBb], false);
  stage_wait();
  tm.sync();
  PERPHIL_DIRECT_PROF(prof.mark(kPcgSetup));
  auto precondition = [&](auto mark) {
    if constexpr (kDense) {
      return dense_pc<kThreads>(R.base, V.base, Md, nint);
    } else {
      return lumped_fastdiag<D, kG>(tm, R, U, V, S, isc, in, mark);
    }
  };

  warp_partial(precondition(no_mark), red[kRowRz], false);
  double t3[3];
  team_totals<kWarps>(tm, red, blk, {kRowBb, kRowRr, kRowRz}, false, t3);
  const double B = t3[0];  // ||b_b||^2
  double rr = t3[1] + B;
  double rz = t3[2] + B;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int q = me + k * all;
    if (q < nint) {
      P[node[k]] = V[q];
      P[n + node[k]] = V[nint + q];
    }
  }
  double rho = 1.0, pi = 1.0, xi = 0.0;  // r_b = rho b_b, p_b = pi b_b, x_b = xi b_b
  double rnorm = sqrt(rr);
  const double tol = rtol * rnorm;
  int its = 0;
  PERPHIL_DIRECT_PROF(prof.mark(kPcgFirstPc));
  while (rnorm > tol && its < max_it) {
    tm.sync();  // p complete
    double pap = 0.0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int q = me + k * all;
      if (q < nint) {
        double y1, y2;
        if (simplex) {  // the stencil's zeros skipped (the launcher checked they are zeros)
          interior_apply<D, kSimplexOffsets<D>>(P, n, w, g, node[k], y1, y2);
        } else {
          interior_apply<D, kFullOffsets<D>>(P, n, w, g, node[k], y1, y2);
        }
        pap = fma(P[node[k]], y1, fma(P[n + node[k]], y2, pap));
        R[q] = y1;  // A p, until r goes back here
        R[nint + q] = y2;
      }
    }
    warp_partial(pap, red[kRowPap], false);
    PERPHIL_DIRECT_PROF(prof.mark(kPcgMatvec));
    double t1[1];
    team_totals<kWarps>(tm, red, blk, {kRowPap}, false, t1);
    const double alpha = rz / (t1[0] + pi * pi * B);
    PERPHIL_DIRECT_PROF(prof.mark(kPcgPap));
    part = 0.0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int q = me + k * all;
      if (q < nint) {
        x1[k] = fma(alpha, P[node[k]], x1[k]);
        x2[k] = fma(alpha, P[n + node[k]], x2[k]);
        r1[k] = fma(-alpha, R[q], r1[k]);
        r2[k] = fma(-alpha, R[nint + q], r2[k]);
        R[q] = r1[k];
        R[nint + q] = r2[k];
        part = fma(r1[k], r1[k], fma(r2[k], r2[k], part));
      }
    }
    warp_partial(part, red[kRowRr], false);
    xi = fma(alpha, pi, xi);
    rho = fma(-alpha, pi, rho);
    tm.sync();
    PERPHIL_DIRECT_PROF(prof.mark(kPcgUpdate));
#ifdef PERPHIL_DIRECT_PROFILE
    auto mark = [&](int i) { prof.mark(kPcgPass + i); };
#else
    auto mark = no_mark;
#endif
    warp_partial(precondition(mark), red[kRowRz], false);
    double t2[2];
    team_totals<kWarps>(tm, red, blk, {kRowRr, kRowRz}, false, t2);
    PERPHIL_DIRECT_PROF(prof.mark(kPcgPass + 2 * D - 1));
    const double bpart = rho * rho * B;
    rr = t2[0] + bpart;
    const double rz_new = t2[1] + bpart;
    const double beta = rz_new / rz;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int q = me + k * all;
      if (q < nint) {
        P[node[k]] = fma(beta, P[node[k]], V[q]);
        P[n + node[k]] = fma(beta, P[n + node[k]], V[nint + q]);
      }
    }
    pi = fma(beta, pi, rho);
    rz = rz_new;
    ++its;
    rnorm = sqrt(rr);
    PERPHIL_DIRECT_PROF(prof.mark(kPcgTail));
    if (!isfinite(rnorm)) break;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (me + k * all < nint) {
      xo[node[k]] = x1[k];
      xo[n + node[k]] = x2[k];
    }
  }
  for (int t = me; t < n - nint; t += all) {
    const int e = boundary_node<D>(g, t);
    xo[e] = xi * b[e];
    xo[n + e] = xi * b[n + e];
  }
  if (me == 0) *its_out = its;
  if constexpr (kCluster) tm.sync();  // no block leaves while another reads its shared memory
  PERPHIL_DIRECT_PROF(prof.mark(kPcgEnd); prof.flush(pcg_prof));
}

// Every placement's kernel in D dimensions, as f(kernel pointer, threads):
// the planned one (plan non-null) or all of them.
template <int D, class F>
cudaError_t pcg_placements(const DirectPlan* plan, F f) {
#define PERPHIL_PCG_PLACEMENT(T, P, C)                                                        \
  if (plan == nullptr || (plan->threads == T && plan->per == P && (plan->blocks > 1) == C)) { \
    const cudaError_t e = f(fused_pcg_kernel<D, T, P, C>, T);                                 \
    if (plan != nullptr || e != cudaSuccess) return e;                                        \
  }
  PERPHIL_PCG_PLACEMENT(64, 1, false)
  PERPHIL_PCG_PLACEMENT(128, 1, false)
  PERPHIL_PCG_PLACEMENT(256, 1, false)
  PERPHIL_PCG_PLACEMENT(512, 1, false)
  PERPHIL_PCG_PLACEMENT(512, 2, false)
  PERPHIL_PCG_PLACEMENT(512, 4, false)
  PERPHIL_PCG_PLACEMENT(512, 8, false)
  PERPHIL_PCG_PLACEMENT(512, 1, true)
  PERPHIL_PCG_PLACEMENT(512, 2, true)
  PERPHIL_PCG_PLACEMENT(512, 4, true)
  PERPHIL_PCG_PLACEMENT(512, 8, true)
#undef PERPHIL_PCG_PLACEMENT
  return plan == nullptr ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace perphil

// b, x: (2, nz*ny*nx) f64; its: one int32 (device); Sx/Sy/Sz: f64 (n, n)
// lumped eigenvector matrices per axis (Sz unused in 2D; equal matrices
// share one pointer and are staged once); sc: (2, nint) f64 lumped mode
// scales' inverses per field; dense: (2, nint, nint) f64, each field's preconditioner
// as one matrix, read on the dense placement (64 threads) alone and null
// elsewhere; weights: 81 host doubles [S1 | S2 | C]; placement: 4
// host ints or null, set to the plan's threads, nodes a thread owns,
// dynamic shared memory in bytes and blocks. Refuses (cudaErrorInvalidValue)
// a grid the plan does not place.
extern "C" int perphil_fused_pcg(const double* b, double* x, int* its, const double* Sx, const double* Sy,
                                 const double* Sz, const double* isc, const double* dense, const double* weights,
                                 int nz, int ny, int nx, int dim, double rtol, int max_it, int* placement,
                                 void* stream) {
  using namespace perphil;
  if (dim != 2 && dim != 3) return (int)cudaErrorInvalidValue;
  const int na[3] = {nx - 2, ny - 2, nz - 2};
  const double* mats[3] = {Sx, Sy, Sz};
  long mat_elems = 0;
  for (int a = 0; a < dim; ++a) {
    bool seen = false;
    for (int a2 = 0; a2 < a; ++a2) seen = seen || mats[a2] == mats[a];
    if (!seen) mat_elems += (long)na[a] * na[a];
  }
  DirectPlan plan;
  if (!direct_plan(kDirectK3, nz, ny, nx, dim, mat_elems, plan) ||
      (plan.threads == kDenseThreads && dense == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (placement != nullptr) {
    placement[0] = plan.threads;
    placement[1] = plan.per;
    placement[2] = plan.bytes;
    placement[3] = plan.blocks;
  }
  const DppWeights<double> w = weights_from_host<double>(weights);
  const bool simplex = (nonzero_offsets(w) & ~(dim == 3 ? kSimplexOffsets<3> : kSimplexOffsets<2>)) == 0u;
  const Grid g{nz, ny, nx};
  const Interior in = interior_of(g, dim);
  const TeamGeom geo = team_geom(plan, nz * ny * nx, in.nint);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto kernel, int threads) {
    return launch_team(kernel, plan, threads, st, b, x, its, Sx, Sy, Sz, isc, dense, w, simplex, g, in, geo, rtol,
                       max_it);
  };
  return (int)(dim == 3 ? pcg_placements<3>(&plan, go) : pcg_placements<2>(&plan, go));
}

// The largest static shared memory of K3's kernels in `dim` dimensions, in
// bytes (-1 where the runtime cannot say, -2 for an unknown dim): what it
// leaves of the block's 232,448 B must hold kDirectSmemBudget.
extern "C" int perphil_fused_pcg_static_smem(int dim) {
  using namespace perphil;
  if (dim != 2 && dim != 3) return -2;
  int most = 0;
  auto get = [&](auto kernel, int) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess && (int)attr.sharedSizeBytes > most) most = (int)attr.sharedSizeBytes;
    return err;
  };
  const cudaError_t err = dim == 3 ? pcg_placements<3>(nullptr, get) : pcg_placements<2>(nullptr, get);
  return err == cudaSuccess ? most : -1;
}

#ifdef PERPHIL_DIRECT_PROFILE
// Copies K3's phase counters (PcgPhase, cycles of thread 0 summed over the
// launches since the last take) to `out` on the host, then zeroes them.
extern "C" int perphil_fused_pcg_profile_take(unsigned long long* out) {
  const unsigned long long zero[perphil::kProfSlots] = {};
  cudaError_t err = cudaMemcpyFromSymbol(out, perphil::pcg_prof, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(perphil::pcg_prof, zero, sizeof(zero));
  return (int)err;
}
#endif
