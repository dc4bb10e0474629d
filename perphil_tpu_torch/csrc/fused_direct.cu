// K2: the whole direct solve on small quad/hex meshes, in one thread block
// whose shared memory holds the working set.
//
// Replaces perphil_tpu/ops/pallas_direct.py::fused_direct_solve (:228;
// _build_direct :79, pallas_call :209): an f32 tensor fast-diagonalization
// solve (per-axis eigen-transforms, closed-form 2x2 solves per mode, inverse
// transforms) followed by 5 fixed refinement steps with the stencil matvec,
// on a packed double-float VMEM layout. What it computes is
// FusedDirectSolver.plain: native f64 replaces the TPU's double-float (the
// residual is f64, the correction solve f32, x accumulates in f64); each f32
// solve is scaled by the max of its right-hand side (ops/mixed.py:233-237);
// boundary rows take b exactly (pallas_direct.py:184-193).
//
// Bound on the H100: latency. A solve is six f32 transforms and five f64
// matvecs over a few thousand values, microseconds of arithmetic in a chain
// of dependent phases. The design keeps the chain inside one SM where one
// block's shared memory holds the working set, and inside one thread block
// cluster where it does not (direct_smem.cuh has the plan and the shared
// device code):
//   - Shared memory holds x (f64, node layout, zero on the boundary, which
//     the interior rows never read), the two f32 interior transform buffers,
//     and on one block a11/a22, the determinants' inverses (taken on the
//     host) and the f32 eigenbases, staged once with cp.async (a cluster
//     spreads x and the buffers over its blocks and reads the rest from
//     device memory). Each thread owns interior nodes of both fields and keeps b and each
//     step's residual r in registers, from the max reduction to the scaled
//     f32 write. Device memory is read for b and written for x.
//   - The boundary takes b once, at entry. The twin then adds the boundary
//     residual each step, which is exactly 0 (identity rows): b_b - b_b.
//     Adding +0 changes no value, so the kernel skips it.
//   - A refinement step crosses 2 d + 2 barriers: the max reduction, the
//     f32 write, one after each transform pass. The 2x2 mode solves run in
//     the last forward pass (a task computes both fields' outputs of a
//     mode); the last inverse pass adds s u to x where it writes.
//   - All indices are 32-bit, divisions by the grid's lengths are
//     multiply-shifts (FastDiv); the block size and the nodes a thread owns
//     are constants of the placement the launcher picks.
// No TF32 and no FMA contraction matter here: the f32 transforms differ from
// the twin's tensordot by order, and the f64 refinements make up for it (K2
// agrees with its twin to rounding).

#include "direct_smem.cuh"

namespace perphil {

// Phase clocks (direct_smem.cuh, DirectProf): each phase ends after its
// barrier; kDirPass + i is transform pass i.
enum DirectPhase { kDirSetup, kDirMatvec, kDirMax, kDirWrite, kDirPass, kDirEnd = kDirPass + 6 };
#ifdef PERPHIL_DIRECT_PROFILE
__device__ unsigned long long direct_prof[kProfSlots];
#endif

// x += s * fastdiag32(W0) on the interior: W0 holds (f32)(r / s) of both
// fields; the passes alternate W0 / W1, the last adds into x (node layout).
// mark(i) follows pass i's barrier; idet holds the determinants' inverses.
template <int D, int kG, class Team, class X32, class X64, class Mark>
__device__ __forceinline__ void add_solve(const Team& tm, const X32& W0, const X32& W1, const X64& X,
                                          const float* const* S, const float* a11, const float* a22,
                                          const float* idet, float a12, double s, const Grid& g, const Interior& in,
                                          Mark mark) {
  const int nint = in.nint, n = g.nx * g.ny * g.nz;
#pragma unroll
  for (int i = 0; i < 2 * D; ++i) {
    const int a = i < D ? i : 2 * D - 1 - i;
    const int lines = nint / (int)in.len[a].d;  // of one field
    const X32& src = i % 2 == 0 ? W0 : W1;
    const X32& dst = i % 2 == 0 ? W1 : W0;
    if (i < D - 1) {
      line_pass<float, kG, 1, true>(tm, src, S[a], in, a, 2 * lines, [&](int q, float v, float) { dst[q] = v; });
    } else if (i == D - 1) {  // the last forward pass and the 2x2 solves of its modes
      line_pass<float, kG, 2, true>(tm, src, S[a], in, a, lines, [&](int q, float f1, float f2) {
        dst[q] = (a22[q] * f1 - a12 * f2) * idet[q];
        dst[nint + q] = (a11[q] * f2 - a12 * f1) * idet[q];
      });
    } else if (i < 2 * D - 1) {
      line_pass<float, kG, 1, false>(tm, src, S[a], in, a, 2 * lines, [&](int q, float v, float) { dst[q] = v; });
    } else {
      line_pass<float, kG, 1, false>(tm, src, S[a], in, a, 2 * lines, [&](int qq, float v, float) {
        const int f = qq >= nint;
        X[f * n + interior_node<D>(g, in, qq - f * nint)] += (double)v * s;
      });
    }
    tm.sync();
    mark(i);
  }
}

template <int D, int kThreads, int kPer, bool kCluster>
__global__ void __launch_bounds__(kThreads, 1)
fused_direct_kernel(const double* __restrict__ b, double* __restrict__ xo, const float* Sx, const float* Sy,
                    const float* Sz, const float* __restrict__ a11_in, const float* __restrict__ a22_in,
                    const float* __restrict__ idet_in, float a12, DppWeights<double> w, Grid g, Interior in,
                    TeamGeom geo, int refinements) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kG = kThreads < kDirectMaxThreads ? 1 : (2 * kPer < 4 ? 2 * kPer : 4);  // lines a pass task
  __shared__ double red[1][kWarps];
  __shared__ double blk[1];  // a cluster's block totals
  extern __shared__ __align__(16) unsigned char smem[];
  const Team<kThreads, kCluster> tm(geo.nb);
  const int n = g.nx * g.ny * g.nz, nint = in.nint, tid = threadIdx.x;
  const int me = tm.thread(), all = tm.size();
  PERPHIL_DIRECT_PROF(DirectProf prof; prof.start());
#ifdef PERPHIL_DIRECT_PROFILE
  auto mark = [&](int i) { prof.mark(kDirPass + i); };
#else
  auto mark = [](int) {};
#endif
  // x (node layout, zero on the boundary) and the two f32 transform
  // buffers: this block's chunks; then, on one block, a11, a22, the
  // determinants' inverses and the f32 eigenbases
  double* xbase = reinterpret_cast<double*>(smem);
  const int pc = (int)geo.pchunk.d, ic = (int)geo.ichunk.d;
  float* wbase = reinterpret_cast<float*>(xbase + pc);
  const Spread<double, kCluster> X{xbase, geo.pchunk};
  const Spread<float, kCluster> W0{wbase, geo.ichunk}, W1{wbase + ic, geo.ichunk};
  const float* S[3] = {Sx, Sy, Sz};
  const float *a11 = a11_in, *a22 = a22_in, *idet = idet_in;
  if constexpr (!kCluster) {
    float* c = wbase + 2 * ic;
    stage_mats<float, D>(c + 3 * nint, Sx, Sy, Sz, in, S);
    stage_async(c, a11_in, nint);
    stage_async(c + nint, a22_in, nint);
    stage_async(c + 2 * nint, idet_in, nint);
    a11 = c;
    a22 = c + nint;
    idet = c + 2 * nint;
  }
  for (int e = tid; e < pc; e += kThreads) xbase[e] = 0.0;  // this block's chunk of x
  // a cluster: every block running (and its chunk of x zeroed) before any
  // thread touches another block's shared memory
  if constexpr (kCluster) tm.sync();

  int node[kPer];
  double b1[kPer], b2[kPer], r1[kPer], r2[kPer];
  double m = 0.0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int q = me + k * all;
    node[k] = 0;
    b1[k] = b2[k] = 0.0;
    if (q < nint) {
      node[k] = interior_node<D>(g, in, q);
      b1[k] = b[node[k]];
      b2[k] = b[n + node[k]];
      m = fmax(m, fmax(fabs(b1[k]), fabs(b2[k])));
    }
    r1[k] = b1[k];
    r2[k] = b2[k];
  }
  for (int t = me; t < n - nint; t += all) {
    const int e = boundary_node<D>(g, t);
    const double u = b[e], v = b[n + e];
    xo[e] = u;
    xo[n + e] = v;
    m = fmax(m, fmax(fabs(u), fabs(v)));
  }
  warp_partial(m, red[0], true);
  stage_wait();
  for (int step = 0; step <= refinements; ++step) {
    if (step > 0) {  // r = b - A x on the owned interior nodes
      m = 0.0;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (me + k * all < nint) {
          double y1, y2;
          interior_apply<D, kFullOffsets<D>>(X, n, w, g, node[k], y1, y2);
          r1[k] = b1[k] - y1;
          r2[k] = b2[k] - y2;
          m = fmax(m, fmax(fabs(r1[k]), fabs(r2[k])));
        }
      }
      warp_partial(m, red[0], true);
    }
    PERPHIL_DIRECT_PROF(prof.mark(step > 0 ? kDirMatvec : kDirSetup));
    double total[1];
    team_totals<kWarps>(tm, red, blk, {0}, true, total);
    const double s = fmax(total[0], 1e-30);
    const double inv_s = 1.0 / s;  // r / s to f32: one f64 rounding more at most
    PERPHIL_DIRECT_PROF(prof.mark(kDirMax));
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int q = me + k * all;
      if (q < nint) {
        W0[q] = (float)(r1[k] * inv_s);
        W0[nint + q] = (float)(r2[k] * inv_s);
      }
    }
    tm.sync();
    PERPHIL_DIRECT_PROF(prof.mark(kDirWrite));
    add_solve<D, kG>(tm, W0, W1, X, S, a11, a22, idet, a12, s, g, in, mark);
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (me + k * all < nint) {
      xo[node[k]] = X[node[k]];
      xo[n + node[k]] = X[n + node[k]];
    }
  }
  if constexpr (kCluster) tm.sync();  // no block leaves while another reads its shared memory
  PERPHIL_DIRECT_PROF(prof.mark(kDirEnd); prof.flush(direct_prof));
}

// Every placement's kernel in D dimensions, as f(kernel pointer, threads):
// the planned one (plan non-null) or all of them.
template <int D, class F>
cudaError_t direct_placements(const DirectPlan* plan, F f) {
#define PERPHIL_DIRECT_PLACEMENT(T, P, C)                                                     \
  if (plan == nullptr || (plan->threads == T && plan->per == P && (plan->blocks > 1) == C)) { \
    const cudaError_t e = f(fused_direct_kernel<D, T, P, C>, T);                              \
    if (plan != nullptr || e != cudaSuccess) return e;                                        \
  }
  PERPHIL_DIRECT_PLACEMENT(64, 1, false)
  PERPHIL_DIRECT_PLACEMENT(128, 1, false)
  PERPHIL_DIRECT_PLACEMENT(256, 1, false)
  PERPHIL_DIRECT_PLACEMENT(512, 1, false)
  PERPHIL_DIRECT_PLACEMENT(512, 2, false)
  PERPHIL_DIRECT_PLACEMENT(512, 4, false)
  PERPHIL_DIRECT_PLACEMENT(512, 8, false)
  PERPHIL_DIRECT_PLACEMENT(512, 1, true)
  PERPHIL_DIRECT_PLACEMENT(512, 2, true)
  PERPHIL_DIRECT_PLACEMENT(512, 4, true)
  PERPHIL_DIRECT_PLACEMENT(512, 8, true)
#undef PERPHIL_DIRECT_PLACEMENT
  return plan == nullptr ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace perphil

// b, x: (2, nz*ny*nx) f64; Sx/Sy/Sz: f32 (n, n) eigenvector matrices per
// axis (Sz unused in 2D; equal matrices share one pointer and are staged
// once); a11/a22/idet: (nint,) f32 (idet: the determinants' inverses);
// weights: 81 host doubles [S1 | S2 | C];
// placement: 4 host ints or null, set to the plan's threads, nodes a thread
// owns, dynamic shared memory in bytes and blocks. Refuses
// (cudaErrorInvalidValue) a grid the plan does not place.
extern "C" int perphil_fused_direct(const double* b, double* x, const float* Sx, const float* Sy, const float* Sz,
                                    const float* a11, const float* a22, const float* idet, float a12,
                                    const double* weights, int nz, int ny, int nx, int dim, int refinements,
                                    int* placement, void* stream) {
  using namespace perphil;
  if ((dim != 2 && dim != 3) || refinements < 0) return (int)cudaErrorInvalidValue;
  const int na[3] = {nx - 2, ny - 2, nz - 2};
  const float* mats[3] = {Sx, Sy, Sz};
  long mat_elems = 0;
  for (int a = 0; a < dim; ++a) {
    bool seen = false;
    for (int a2 = 0; a2 < a; ++a2) seen = seen || mats[a2] == mats[a];
    if (!seen) mat_elems += (long)na[a] * na[a];
  }
  DirectPlan plan;
  if (!direct_plan(kDirectK2, nz, ny, nx, dim, mat_elems, plan)) return (int)cudaErrorInvalidValue;
  if (placement != nullptr) {
    placement[0] = plan.threads;
    placement[1] = plan.per;
    placement[2] = plan.bytes;
    placement[3] = plan.blocks;
  }
  const DppWeights<double> w = weights_from_host<double>(weights);
  const Grid g{nz, ny, nx};
  const Interior in = interior_of(g, dim);
  const TeamGeom geo = team_geom(plan, nz * ny * nx, in.nint);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto kernel, int threads) {
    return launch_team(kernel, plan, threads, st, b, x, Sx, Sy, Sz, a11, a22, idet, a12, w, g, in, geo,
                       refinements);
  };
  return (int)(dim == 3 ? direct_placements<3>(&plan, go) : direct_placements<2>(&plan, go));
}

// The largest static shared memory of K2's kernels in `dim` dimensions, in
// bytes (-1 where the runtime cannot say, -2 for an unknown dim): what it
// leaves of the block's 232,448 B must hold kDirectSmemBudget.
extern "C" int perphil_fused_direct_static_smem(int dim) {
  using namespace perphil;
  if (dim != 2 && dim != 3) return -2;
  int most = 0;
  auto get = [&](auto kernel, int) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess && (int)attr.sharedSizeBytes > most) most = (int)attr.sharedSizeBytes;
    return err;
  };
  const cudaError_t err = dim == 3 ? direct_placements<3>(nullptr, get) : direct_placements<2>(nullptr, get);
  return err == cudaSuccess ? most : -1;
}

#ifdef PERPHIL_DIRECT_PROFILE
// Copies K2's phase counters (DirectPhase, cycles of thread 0 summed over
// the launches since the last take) to `out` on the host, then zeroes them.
extern "C" int perphil_fused_direct_profile_take(unsigned long long* out) {
  const unsigned long long zero[perphil::kProfSlots] = {};
  cudaError_t err = cudaMemcpyFromSymbol(out, perphil::direct_prof, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(perphil::direct_prof, zero, sizeof(zero));
  return (int)err;
}
#endif
