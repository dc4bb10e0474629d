// The fused Picard NGS kernel as it was first ported (value e on block
// (e >> 2) mod nb, every neighbour read through distributed shared memory, a
// cluster barrier after every colour), kept outside the package's build as
// the yardstick of csrc/fused_ngs.cu: tools/profile_kernels.py --only ngs
// builds it alone and times both kernels in turns on the same inputs. Its
// host tables are the tool's (cluster_lists). What follows is the source as
// it stood, but for the exported names (perphil_fused_ngs_cluster*).
//
// fused_ngs: the whole pinned-colouring SNES ngs Picard solve on a 2D quad
// mesh in one launch.
//
// Replaces no Pallas kernel: in the JAX package this solve is one XLA
// while-loop on the device (perphil_tpu/solvers/solver.py:1852-1911,
// _build_nonlinear_solver's native-f64 ngs branch; on the TPU the
// double-float twin _build_ngs_solver_df, :1665-1830), whose sweep is
// ColoredNGSSweeper.sweep (perphil_tpu/ops/ilu.py:924). What it computes is
// FusedNGSSolver.plain bit for bit:
//   x = x0 (the BC lift); f0 = ||b - A x||; tol = max(rtol f0, atol);
//   while fn > tol and its < max_it:
//     for each colour c, ascending: x[c] += (b - A x)[c] / diag[c]
//     fn = ||b - A x||; its += 1
// A is the BC-eliminated two-field operator: a row of field f at an
// interior node takes 0.0 plus w[f][f' * 9 + q] * x[f', node + offset q],
// field 0's nine taps then field 1's, each product and sum rounded on its
// own (__dmul_rn / __dadd_rn: nvcc would contract them into FMAs), a
// boundary neighbour reading 0.0. Boundary rows are identity rows whose
// residual is exactly 0 at the lift, so they neither update nor add to the
// norm. The norm is the halving tree over the 2n squares
// (krylov.tree_sum), in the cluster order of krylov.tree_sum_cluster.
//
// Bound on the H100: latency. At 2D N=128 (5135 iterations, 14 colours)
// the arithmetic is ~2.5 MFLOP an iteration, 0.39 ms in all at 34 TFLOP/s
// f64; but every colour depends on the one before, so a solve is 77,025
// phases that each end at a barrier across every block holding the vector.
// What the design does about it:
//   - x, b and the residual live in shared memory for the whole solve;
//     past 512 values they are spread over a thread block cluster of 2-16
//     blocks, placed as the fused GMRES frame places a vector
//     (fused_gmres.cuh, "Ownership": value e on block (e >> 2) mod nb, in
//     slot ((e >> 2) / nb) * 4 + e mod 4), and a row reads its neighbours
//     through distributed shared memory. Nothing but the result touches
//     device memory inside the loop (and the norm's 4 nb partials).
//   - The colouring is distance-1 on the whole monolithic pattern, so no
//     row of a colour reads another of the same colour: a colour's residual
//     and update are one phase, one cluster barrier.
//   - Each block walks its own rows of a colour from a compacted list (the
//     host sorts every block's interior rows by colour), so a phase costs
//     what the colour holds, not a pass over the vector.
//   - The residual the norm computes at the end of an iteration serves
//     colour 0 of the next (the JAX df loop's reuse): an iteration is one
//     stencil pass over the colours 1.. plus one full residual, and
//     ncolours + 1 barriers (the norm's inside its tree).
//   - The 18 neighbours of a row are loaded before its chain of sums.
//   - The stop test runs in every block on the same bits (each block
//     finishes the tree itself), so the loop needs no broadcast.

#include <cooperative_groups.h>

#include "fused_gmres_kernel.cuh"

namespace perphil {
namespace ngs_cluster {

constexpr int kNgsMaxColors = 32;
// The dynamic shared memory a launch may plan with: x, b, the residual (3
// nloc doubles) and the block's colour lists (nloc ints), nloc the values a
// block owns. The host's plan (ops/fused_ngs.py, which reads this line)
// mirrors the launcher's; the kernel's static shared memory must leave it.
constexpr int kNgsSmemBudget = 230400;
constexpr int kNgsResultSlots = 6;

// Per field f of the row, its 18 taps: field 0's nine (offsets (dy, dx)
// row-major), then field 1's; then the two diagonals.
struct NgsWeights {
  double w[2][18];
  double diag[2];
};

struct NgsGeom {
  int nb, log_nb, log_s, nloc, bytes;
};

// Phase clocks, for tools/profile_kernels.py --only ngs-phases alone: a
// build with PERPHIL_NGS_PROFILE adds thread 0 of block 0's cycles in each
// phase to ngs_prof (the package's library holds no counter): a colour's
// rows, the cluster barrier after them, the norm's residual rows, the
// norm's tree (its cluster barrier inside).
enum NgsPhase { kNgsColour, kNgsColourBarrier, kNgsResidual, kNgsTree, kNgsPhases };
#ifdef PERPHIL_NGS_PROFILE
__device__ unsigned long long ngs_prof[kNgsPhases];
#endif

// The launcher's placement of L values (the frame's blocks and leaves).
inline bool ngs_geometry(long L, int ncolors, NgsGeom& g) {
  g = NgsGeom{};
  g.nb = gmres_blocks(L);
  while ((1 << g.log_nb) < g.nb) ++g.log_nb;
  while (((long)kGmresThreads * g.nb << g.log_s) < L) ++g.log_s;
  if (g.log_s > kMaxLogS || ncolors < 1 || ncolors > kNgsMaxColors) return false;
  const long piece = 4L * g.nb;
  g.nloc = (int)(4 * (L / piece) + (L % piece < 4 ? L % piece : 4));
  const long bytes = (28L * g.nloc + 15) / 16 * 16;
  if (bytes > kNgsSmemBudget) return false;
  g.bytes = (int)bytes;
  return true;
}

__global__ void __launch_bounds__(kGmresThreads, 1)
fused_ngs_kernel(const double* b, const double* x0, double* x, const int* lists, const int* cptr_g,
                 double* xchg, double* result, NgsWeights wt, int nx, int ny, int ncolors, double rtol,
                 double atol, int max_it, NgsGeom geom) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ double part[1][64];
  __shared__ double scal[1];
  __shared__ double ws[2][18], dg[2];
  __shared__ int cptr[kNgsMaxColors + 1];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = nx * ny, L = 2 * n, S = 1 << geom.log_s, nbm = geom.nb - 1, log_nb = geom.log_nb;
  const Own o{(int)cluster.block_rank(), geom.nb, ((((lane >> 2) << 4) | warp) << 2) | (lane & 3),
              geom.log_s};
  Reducer rd{part, xchg, 0};
  double* xs = reinterpret_cast<double*>(dyn);
  double* bs = xs + geom.nloc;
  double* rs = bs + geom.nloc;
  int* list = reinterpret_cast<int*>(rs + geom.nloc);

  if (tid < 36) ws[tid / 18][tid % 18] = wt.w[tid / 18][tid % 18];
  if (tid < 2) dg[tid] = wt.diag[tid];
  if (tid <= ncolors) cptr[tid] = cptr_g[o.b * (ncolors + 1) + tid];
  for (int i = tid; i < geom.nloc; i += kGmresThreads) rs[i] = 0.0;
  for (int s = 0; s < S; ++s) {
    const int i = o.slot(s), e = o.elem(i);
    if (e < L) {
      xs[i] = x0[e];
      bs[i] = b[e];
    }
  }
  __syncthreads();
  for (int k = tid; k < cptr[ncolors]; k += kGmresThreads) list[k] = lists[(long)o.b * geom.nloc + k];
  cluster.sync();  // every block's x in place before any remote read
#ifdef PERPHIL_NGS_PROFILE
  const bool clocked = o.b == 0 && tid == 0;
  long long t0 = clock64(), clk[kNgsPhases] = {};
  auto mark = [&](int phase) {
    if (clocked) {
      const long long now = clock64();
      clk[phase] += now - t0;
      t0 = now;
    }
  };
#else
  auto mark = [](int) {};
#endif

  // x[e] from its owner's shared memory
  auto xload = [&](int e) {
    const int piece = e >> 2;
    return *cluster.map_shared_rank(xs + (((piece >> log_nb) << 2) | (e & 3)), piece & nbm);
  };
  // (b - A x) at interior row e, own slot i
  auto residual = [&](int e, int i) {
    const int f = e >= n ? 1 : 0, idx = e - f * n;
    const int j = idx / nx, c = idx - j * nx;
    double u[18];
#pragma unroll
    for (int t = 0; t < 18; ++t) {
      const int q = t % 9, dy = q / 3 - 1, dx = q % 3 - 1;
      const int jj = j + dy, ii = c + dx;
      const bool outer = jj == 0 || jj == ny - 1 || ii == 0 || ii == nx - 1;
      u[t] = outer ? 0.0 : xload((t / 9) * n + idx + dy * nx + dx);
    }
    double acc = 0.0;
#pragma unroll
    for (int t = 0; t < 18; ++t) acc = __dadd_rn(acc, __dmul_rn(ws[f][t], u[t]));
    return __dsub_rn(bs[i], acc);
  };
  auto interior = [&](int e) {
    const int idx = e >= n ? e - n : e;
    const int j = idx / nx, c = idx - j * nx;
    return j > 0 && j < ny - 1 && c > 0 && c < nx - 1;
  };
  // the residual of every own row into rs, then ||b - A x|| on the cluster tree
  auto norm = [&]() {
    for (int s = 0; s < S; ++s) {
      const int i = o.slot(s), e = o.elem(i);
      if (e < L && interior(e)) rs[i] = residual(e, i);
    }
    mark(kNgsResidual);
    cluster_tree_rows(rd, o, 1, scal, [&](int, int s) {
      const int i = o.slot(s), e = o.elem(i);
      if (e >= L) return 0.0;
      const double v = rs[i];
      return __dmul_rn(v, v);
    });
    mark(kNgsTree);
    return __dsqrt_rn(scal[0]);
  };

  const double f0 = norm();
  const double rel_tol = __dmul_rn(rtol, f0);
  const double tol = atol > rel_tol ? atol : rel_tol;  // Python's max(rtol * f0, atol)
  double fn = f0;
  int its = 0;
  while (fn > tol && its < max_it) {
    for (int c = 0; c < ncolors; ++c) {
      for (int k = cptr[c] + tid; k < cptr[c + 1]; k += kGmresThreads) {
        const int i = list[k], e = o.elem(i);
        const double r = c == 0 ? rs[i] : residual(e, i);
        xs[i] = __dadd_rn(xs[i], __ddiv_rn(r, dg[e >= n ? 1 : 0]));
      }
      mark(kNgsColour);
      cluster.sync();
      mark(kNgsColourBarrier);
    }
    fn = norm();
    ++its;
  }
  for (int s = 0; s < S; ++s) {
    const int i = o.slot(s), e = o.elem(i);
    if (e < L) x[e] = xs[i];
  }
  if (o.b == 0 && tid == 0) {
    result[0] = (double)its;
    result[1] = fn;
    result[2] = f0;
    result[3] = (double)geom.nb;
    result[4] = (double)(1 << geom.log_s);
    result[5] = (double)geom.bytes;
  }
#ifdef PERPHIL_NGS_PROFILE
  if (clocked) {
    for (int k = 0; k < kNgsPhases; ++k) atomicAdd(ngs_prof + k, (unsigned long long)clk[k]);
  }
#endif
  cluster.sync();  // no block leaves while another may still read its shared memory
}

}  // namespace ngs_cluster
}  // namespace perphil

// b, x0, x: (2, ny, nx) f64 (b the lifted right-hand side, x0 the BC lift, x
// out); lists: (nb, nloc) int32, per block its interior rows' slots sorted
// by colour; cptr: (nb, ncolors + 1) int32, each block's colour bounds in
// its list; xchg: kXchgDoubles f64 of scratch (the norm's exchange between
// blocks); result: kNgsResultSlots f64 [iterations, fn, f0, blocks, leaves a
// thread, dynamic bytes]; weights: 38 host doubles (NgsWeights). blocks and
// nloc: the host's plan, which must be the launcher's.
extern "C" int perphil_fused_ngs_cluster(const double* b, const double* x0, double* x, const int* lists,
                                 const int* cptr, double* xchg, double* result, const double* weights,
                                 int ny, int nx, int ncolors, double rtol, double atol, int max_it,
                                 int blocks, int nloc, void* stream) {
  using namespace perphil;
  using namespace perphil::ngs_cluster;
  NgsGeom geo;
  if (nx < 3 || ny < 3 || max_it < 0 || !ngs_geometry(2L * nx * ny, ncolors, geo) || geo.nb != blocks ||
      geo.nloc != nloc) {
    return (int)cudaErrorInvalidValue;
  }
  NgsWeights w;
  for (int t = 0; t < 18; ++t) {
    w.w[0][t] = weights[t];
    w.w[1][t] = weights[18 + t];
  }
  w.diag[0] = weights[36];
  w.diag[1] = weights[37];
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, fused_ngs_kernel);
  if (err != cudaSuccess) return (int)err;
  // the plan's budget is the host's; a kernel that leaves less refuses
  if (kMaxSmemPerBlock - (long)fa.sharedSizeBytes < kNgsSmemBudget) return (int)cudaErrorLaunchOutOfResources;
  err = cudaFuncSetAttribute(fused_ngs_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fused_ngs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.bytes);
  if (err != cudaSuccess) return (int)err;
  // one cluster of geo.nb blocks; a card that cannot place it refuses the launch
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(geo.nb);
  cfg.blockDim = dim3(kGmresThreads);
  cfg.dynamicSmemBytes = (size_t)geo.bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = geo.nb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_ngs_kernel, b, x0, x, lists, cptr, xchg, result, w, nx, ny, ncolors,
                           rtol, atol, max_it, geo);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

#ifdef PERPHIL_NGS_PROFILE
// Copies the phase counters (NgsPhase, cycles summed over the launches since
// the last take) to `out` on the host, then zeroes them.
extern "C" int perphil_fused_ngs_cluster_profile_take(unsigned long long* out) {
  const unsigned long long zero[perphil::ngs_cluster::kNgsPhases] = {};
  cudaError_t err = cudaMemcpyFromSymbol(out, perphil::ngs_cluster::ngs_prof, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(perphil::ngs_cluster::ngs_prof, zero, sizeof(zero));
  return (int)err;
}
#endif
