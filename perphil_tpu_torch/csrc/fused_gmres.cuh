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
//   K8  pc fieldsplit_ilu (:1232-1236, :1393-1402): K6's frame whose blocks
//       are the preset's own GMRES(30) + ILU(0) to 1e-8 / 1e-12 (in_restart
//       > 0, the JAX package's native-f64 _block_solver), or the TPU
//       kernel's ILU(0)-PCG at those tolerances (in_restart 0).
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
// then their sum), which is not K1's interleaved, contracted order. The ILU
// sweeps (ilu_sweep.cuh) and the inner block solves (PCG, or K8's literal
// GMRES, the frame's own parts on one field) keep the twin's order too, so
// K7 and K8 equal their twins bit for bit; K6's fast-diag
// transforms sum in another order than torch.matmul's, so K6 agrees with its
// twin to rounding.
//
// Bound on the H100: latency, then the L2 reads of the basis. A step is one
// stencil matvec, the preconditioner and (j+1) dot products and axpys over a
// few thousand values: 0.08 ms of arithmetic for 3307 steps at 2D N=64. One
// block on one SM spent 147 us a step there on dependent per-thread chains
// and chunked reductions. What the design does about it:
//   - One vector is spread over a thread block cluster of nb <= 16 blocks
//     (cudaLaunchKernelEx, up to the non-portable size 16; a card that
//     cannot place the cluster refuses the launch), joined by the hardware cluster barrier: 3 a step, 5 with a
//     block preconditioner (K6-K8). The
//     launcher takes nb = min(16, Lt / 512), so K5's <= 512 DoF stay one
//     block; a cooperative grid was not needed.
//   - Ownership. With Lt = 512 * nb * S (S leaves a thread), value e belongs
//     to thread tau = e mod (512 nb), tau = (h * nb + b) * 4 + lo: block b,
//     7 bits h and 2 bits lo of the thread. A block so owns 32-byte pieces
//     at a stride of 32 nb bytes: whole sectors, and a thread owns S values.
//     Every phase of a step (matvec row, dots, Gram-Schmidt, scaling) works
//     on the thread's own values; only the matvec's neighbours and the
//     reductions cross threads.
//   - The block's slice of the basis lives in dynamic shared memory where
//     (m+1) slices fit (2D N=64 on 16 blocks: 131 KB); each new vector also
//     goes to device memory, for the matvec, whose neighbours other blocks
//     own. Larger systems keep the basis in device scratch, L2-resident.
//   - The matvec's input: a block's values are scattered over the grid, so
//     their neighbours are too, and every 8-byte load past L1 costs a
//     32-byte sector (3D: 54 a value; the matvec alone took 16 of 30 us a
//     step at tet nx=16). Where 2n doubles fit, each block first copies the
//     whole vector to shared memory in 16-byte loads (68 KB at 2D N=64) and
//     takes the stencil from there. It is given room before the basis slice.
//   - All j+1 dots of a step go in one pass over w, one tree (below).
//   - The Givens chain, R, g and the back-substitution run in every block
//     on thread 0, redundantly: the same bits, no broadcast.
//   - basis_comb is a fixed-depth tree over k with independent loads.
//   - The fieldsplit roles' inner block solves (K6, K8) run on every block
//     too, with
//     the frame's ownership over one field's n values, its slices in the
//     shared memory the matvec's input copy leaves free while the
//     preconditioner runs, and its dots on the cluster tree. K6's fast-diag
//     is a small dense product per axis, lines spread over the blocks, one
//     cluster barrier a phase; K8's ILU(0) sweeps stay on block 0, between
//     two cluster barriers: on 2D fields a line pipeline on ceil(ny / 32)
//     warps (field_sweep.cuh), no handshake a level; on 3D fields the ring
//     of ilu_sweep.cuh. K7 sweeps on block 0 alone. K8's literal inner
//     GMRES keeps its basis ((in_restart + 1) n values) in device scratch
//     and its Givens state (R, g, cs, sn) in device scratch of each block's
//     own, read by thread 0; the frame's h, y and scal, dead while the
//     preconditioner runs, carry its dots, back-substitution and norms. Its
//     shared-memory plan is the PCG mode's.
//
// Reductions. The halving tree over L values zero-padded to Lt reduces the
// high bits of e first: s (the thread's own leaves, a pairwise tree in
// bit-reversed order, TreeAcc), then h (the top 3 bits are lane bits:
// shuffles; the low 4 are the warp: shared memory, one warp per row), then b
// (4 values a row and block meet in a small device buffer; every block
// finishes the tree redundantly), then lo. Padding leaves are +0.0 without a
// load, but their additions are kept: x + (+0.0) changes no bit except
// (-0.0) + (+0.0) = +0.0, which the twin's tree also produces, so dropping
// an add could flip the sign of a zero.

#pragma once

#include "dpp_stencil.cuh"
#include "ilu_sweep.cuh"

namespace perphil {

constexpr int kGmresThreads = 512;
constexpr int kMaxBasis = 32;     // m + 1
constexpr int kMaxLogS = 5;       // the frame: leaves per thread <= 32
constexpr int kMaxCluster = 16;   // blocks sharing one vector
constexpr int kXchgDoubles = 2 * kMaxBasis * 4 * kMaxCluster;  // two reduction exchange regions
// f64 of one block's inner GMRES Givens state: R (kMaxBasis columns of
// kMaxBasis), g (kMaxBasis + 1), cs and sn (kMaxBasis each), rounded up to
// 256-byte pieces (ops/fused_gmres.py reads this line)
constexpr int kInnerStateDoubles = 1152;
// The dynamic shared memory every launch plans with, on every role: the
// block's 227 KB (kMaxSmemPerBlock, 232,448 B) less the kernel's static
// shared memory (the reductions' partials, R, the Givens state and the
// tables). It leaves 27,904 B for that; the largest static shared memory of
// any unit is 27,888 B (K8's profile unit, its counters included), a margin
// of 16 B: a unit that grows its static shared memory by more refuses every
// launch, which tests/test_torch_kernels.py checks on the card for each
// role (perphil_fused_gmres_static_smem). The host's gate (ops/fused_gmres.py,
// which reads this line) and the launcher plan with this one number, so a
// mesh the gate admits is one the launcher places.
constexpr int kGmresSmemBudget = 204544;

enum PcKind {
  kPcNone = 0,
  kPcJacobi = 1,
  kPcFieldsplitLu = 2,
  kPcIlu = 3,
  kPcFieldsplitIlu = 4,
};

// Per stencil, bit o set where weight o is not zero.
struct StencilMasks {
  unsigned s1, s2, c;
};

inline StencilMasks stencil_masks(const DppWeights<double>& w) {
  StencilMasks m{0u, 0u, 0u};
  for (int o = 0; o < 27; ++o) {
    if (w.s1[o] != 0.0) m.s1 |= 1u << o;
    if (w.s2[o] != 0.0) m.s2 |= 1u << o;
    if (w.c[o] != 0.0) m.c |= 1u << o;
  }
  return m;
}

struct GmresParams {
  double rtol, atol, dtol;
  int max_it, restart;
  double in_rtol, in_atol;  // the fieldsplit roles' inner block solve
  int in_max;
  int in_restart;           // K8: > 0 the literal inner GMRES(in_restart), 0 the PCG
  double in_dtol;           // the inner GMRES's divergence tolerance
  double coef;  // -(beta/mu), the coupling's scale
  StencilMasks nz;
};

// The preconditioner's device data (pointers and sizes; the offset table and
// the mass stencil travel in PcTables and are copied to shared memory).
struct PcData {
  const double* dinv;                  // jacobi: (2n)
  const double *F0L, *F0U;             // ilu: the factor's packed sides; fieldsplit_ilu: field 0's
  const double *F1L, *F1U;             // fieldsplit_ilu: field 1's
  const double *L0L, *L0U, *L1L, *L1U; // fieldsplit_ilu on a 2D field: each field's sides by row, for the line
                                       // pipeline (field_sweep.cuh), or null (the ring)
  const int* level_ptr;                // ilu / fieldsplit_ilu schedule
  const int* level_rows;
  int nlev;
  const double *Sx, *Sy, *Sz, *sc;     // fieldsplit_lu: 1D eigenbases, (2, nint) mode scales
  double* work;                        // scratch (pc >= 2): t (2n), the inner solve's buffers (10n in
                                       // all), then K8's literal inner GMRES: its basis
                                       // ((in_restart + 1) n) and each block's kInnerStateDoubles
};

struct PcTables {
  IluMeta meta;
  double mass[27];   // the consistent-mass stencil M (the coupling is coef * M)
  double sw[2][27];  // the fieldsplit roles' field stencils S1, S2 (for their inner matvec)
};

// The launch geometry, chosen by the launcher from L = 2n and what fits.
struct GmresGeom {
  int nb, log_nb;   // blocks in the cluster (a power of two)
  int log_s;        // log2 of the leaves per thread: Lt = 512 * nb << log_s
  int nloc;         // values a block owns at most: the stride of its basis slice
  int z_smem;       // 1: each block copies the matvec's input vector to shared memory
  int basis_smem;   // 1: the block's basis slice lives in dynamic shared memory
  IluPlan ilu;      // the ILU roles' stage (K7, K8), first in dynamic shared memory
  int line_warps;   // K8 on a 2D field: the line pipeline's warps (its edge lines are ilu.bytes), 0: the ring
  // the fieldsplit roles' inner PCG (K6, K8), spread over the cluster as the
  // frame's vectors are: the field's n values by the same ownership rule
  int log_sf;       // log2 of a thread's leaves of one field
  int nlocf;        // field values a block owns at most: the stride of its slices
  int lines;        // K6: lines a block transforms in a pass, at most
  int nmax;         // K6: the longest axis of the interior grid
  int pc_bytes;     // the region of the matvec's input copy, which the inner PCG reuses while the preconditioner runs
  int p_smem;       // 1: each block copies p to shared memory for the field matvec
  int s_smem;       // 1 (K6): each block copies the eigenbases to shared memory for a transform
  int bytes;        // dynamic shared memory in all
};

// doubles of a launch's result before the profile units' phase counters:
// iterations, residual norm, converged, blocks, basis slice in shared memory,
// ILU z in shared memory, matvec input in shared memory, p in shared
// memory, eigenbases in shared memory, the fieldsplit roles' inner block
// solves' iterations and solves (PCG or GMRES), and K8's line pipeline's
// warps (0: the ring)
constexpr int kResultSlots = 12;

// Host: blocks for L values: min(kMaxCluster, Lt / kGmresThreads).
inline int gmres_blocks(long L) {
  long Lt = kGmresThreads;
  while (Lt < L) Lt *= 2;
  int nb = 1;
  while (nb * 2 <= kMaxCluster && (long)kGmresThreads * nb * 2 <= Lt) nb *= 2;
  return nb;
}

// Everything one launch takes.
struct GmresArgs {
  const double* b;
  const double* x0;
  double* x;
  double* V;
  double* xchg;    // kXchgDoubles of scratch
  double* result;  // kResultSlots (above)
  int max_level_rows;
  DppWeights<double> w;
  Grid g;
  GmresParams prm;
  PcData pd;
  PcTables tab;
  int dim;
};

// Choose the geometry and launch the kernel for preconditioner PC
// (instantiated in fused_gmres_pc_*.cu).
template <int PC>
cudaError_t launch_fused_gmres(const GmresArgs& a, cudaStream_t st);
// The static shared memory of PC's kernel in `dim` dimensions, in bytes, or
// -1 where the runtime cannot say (instantiated beside launch_fused_gmres).
template <int PC>
int fused_gmres_static_smem(int dim);

}  // namespace perphil
