// K4-K8: the whole restarted GMRES(m) solve in one thread block, with the
// preconditioner inside the kernel. This header holds what the launcher
// (fused_gmres.cu) and the kernel's translation units share;
// fused_gmres_kernel.cuh holds the kernel, and one fused_gmres_pc_*.cu per
// preconditioner instantiates it, so that nvcc builds them in parallel.
//
// Replaces perphil_tpu/ops/pallas_gmres.py::fused_gmres_df (:2368;
// _build_cycle :1204, pallas_call :1810) in all its pc_type branches, and
// ::fused_gmres_ef64 (:2323; _build_cycle_ef64 :1843, pallas_call :2278):
//   K4  pc none / jacobi;
//   K5  pc none, the f64-faithful TPU kernel (here the same code as K4);
//   K6  pc fieldsplit_lu (pallas_gmres.py:1237-1240 builds its data,
//       :1403-1414 and :1416-1481 apply it): multiplicative 2x2 fieldsplit
//       whose blocks are inner PCGs to 1e-13 with a fast-diag preconditioner;
//   K7  pc ilu (:1229-1231, :1375-1385): monolithic ILU(0) wavefront sweeps;
//   K8  pc fieldsplit_ilu (:1232-1236, :1393-1402): K6's frame with inner
//       ILU(0)-PCG to 1e-8 / 1e-12.
// The TPU needs double-float (K4, K6-K8) and f32 triples (K5) only because
// Mosaic has no f64; here every role is native f64, and the wrapper counts
// a launch under the role's name.
//
// What it computes is ops/krylov.py::gmres with FusedGMRESSolver.plain's
// preconditioner, bit for bit where the twin's order can be kept:
// left-preconditioned GMRES(m) with PETSc's stopping tests (convergence,
// max_it, divergence, a non-finite estimate, a cycle with no step), classical
// Gram-Schmidt, a sequential Givens chain and a written-out
// back-substitution. Every dot product, norm and basis combination is the
// same pairwise halving tree as the twin's tree_sum, and every multiply and
// add rounds on its own (__dmul_rn/__dadd_rn: nvcc would otherwise contract
// them into FMAs). The matvecs keep apply_stencil's order (S pass, C pass,
// then their sum), which is not dpp_apply_node's interleaved, contracted
// order. The ILU sweeps (ilu_sweep.cuh) and the inner PCG keep the twin's
// order too, so K7 and K8 equal their twins bit for bit; K6's fast-diag
// transforms are plain per-axis loops, whose sums run in another order than
// torch.matmul's, so K6 agrees with its twin to rounding.
//
// Bound on the H100: latency. A step is one stencil matvec, the
// preconditioner and (j+1) dot products and axpys over a few thousand nodes,
// so a host loop would spend its time in launches and in reading each
// Hessenberg column back. Here the restart loop runs inside one block of
// kGmresThreads threads; the basis (m+1) x 2n f64 lives in device scratch and
// stays L2-resident (2.1 MB at 2D N=64); the Hessenberg, g and the rotations
// live in shared memory, and thread 0 runs the scalar recurrences between
// barriers. The ILU sweeps take one barrier per wavefront level (2D N=64:
// 197 levels per sweep, at most ~66 rows each, so most threads idle); the
// inner PCGs take ~8 barriers per iteration. Left for later PRs: several
// blocks with a grid-wide barrier, levels merged where rows allow, the
// fast-diag transforms as small matrix products.
//
// Reductions. A halving tree over L values (zero-padded to a power of two
// Lt = J * kGmresThreads) equals: thread c sums its strided set
// {c + t * kGmresThreads} as a halving tree, then the kGmresThreads partials
// are halved. A halving tree over J values is the balanced pairwise tree over
// them in bit-reversed index order, so each thread pushes its leaves in that
// order into a pairwise accumulator (TreeAcc). Loads stay coalesced.

#pragma once

#include "dpp_stencil.cuh"
#include "ilu_sweep.cuh"

namespace perphil {

constexpr int kGmresThreads = 512;
constexpr int kMaxBasis = 32;     // m + 1
constexpr int kRowChunk = 8;      // rows per batched block reduction
constexpr int kMaxLogLeaves = 8;  // leaves per thread <= 256

enum PcKind {
  kPcNone = 0,
  kPcJacobi = 1,
  kPcFieldsplitLu = 2,
  kPcIlu = 3,
  kPcFieldsplitIlu = 4,
};

struct GmresParams {
  double rtol, atol, dtol;
  int max_it, restart;
  int log_j;   // log2 of the leaves per thread, 2n values
  int log_jf;  // the same for one field (n values)
  double in_rtol, in_atol;  // the fieldsplit roles' inner PCG
  int in_max;
  double coef;  // -(beta/mu), the coupling's scale
};

// The preconditioner's device data (pointers and sizes; the offset table and
// the mass stencil travel in PcTables and are copied to shared memory).
struct PcData {
  const double* dinv;                  // jacobi: (2n)
  const double* F0;                    // ilu: (noffs, 2n); fieldsplit_ilu: field 0's (noffs, n)
  const double* F1;                    // fieldsplit_ilu: field 1's (noffs, n)
  const int* level_ptr;                // ilu / fieldsplit_ilu schedule
  const int* level_rows;
  int nlev;
  const double *Sx, *Sy, *Sz, *sc;     // fieldsplit_lu: 1D eigenbases, (2, nint) mode scales
  double* work;                        // scratch, 10n f64 (pc >= 2)
};

struct PcTables {
  IluMeta meta;
  double mass[27];  // the consistent-mass stencil M (the coupling is coef * M)
};

// Everything one launch takes.
struct GmresArgs {
  const double* b;
  const double* x0;
  double* x;
  double* V;
  double* result;
  DppWeights<double> w;
  Grid g;
  GmresParams prm;
  PcData pd;
  PcTables tab;
  int dim;
};

// Launch the kernel for preconditioner PC (instantiated in fused_gmres_pc_*.cu).
template <int PC>
void launch_fused_gmres(const GmresArgs& a, cudaStream_t st);

}  // namespace perphil
