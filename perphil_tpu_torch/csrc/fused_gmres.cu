// The launcher of the fused GMRES kernel K4-K8 (fused_gmres.cuh says what it
// computes and how; fused_gmres_kernel.cuh holds the kernel).

#include "fused_gmres.cuh"

// b, x0, x: (2, nz*ny*nx) f64; V: (restart + 1) * 2 * nodes f64 scratch;
// work: 10 * nodes f64 scratch (pc >= 2, else unused), and for pc 4 with
// in_restart > 0 (the literal inner GMRES) (in_restart + 1) * nodes more and
// kInnerStateDoubles for each block of the cluster; xchg: 4096 f64 of
// scratch (the reductions' exchange between blocks); result: kResultSlots
// f64 (fused_gmres.cuh);
// weights: 81 host doubles
// [S1 | S2 | C]; mass: 27 host doubles (the M stencil; pc 2 and 4).
// pc 1 (jacobi): dinv (2n). pc 3 (ilu): F0L, F0U, the factor's lower and
// upper sides packed by level, the level schedule and the host offset table
// ilu_meta. pc 4 (fieldsplit_ilu): F0L, F0U, F1L, F1U per field, their
// (shared) schedule and table, and on a 2D field L0L, L0U, L1L, L1U, the
// same sides laid out by row for the line pipeline (field_sweep.cuh; null:
// every sweep on the ring). pc 2 (fieldsplit_lu):
// Sx, Sy, Sz (n x n per axis; Sz unused in 2D; equal matrices may share one
// pointer, and are then copied to shared memory once) and sc (2, nint). Unused
// pointers may be null. restart + 1 <= 32. max_level_rows: the rows of the
// schedule's widest level (pc 3, 4). in_rtol, in_atol, in_max: the
// fieldsplit roles' inner block solve; in_restart > 0 (pc 4 only, at most
// kMaxBasis - 1) makes it GMRES(in_restart) with divergence at in_dtol, 0 PCG.
#ifndef PERPHIL_FUSED_GMRES_SYMBOL
#define PERPHIL_FUSED_GMRES_SYMBOL perphil_fused_gmres
#endif
extern "C" int PERPHIL_FUSED_GMRES_SYMBOL(const double* b, const double* x0, double* x, double* V,
                                   double* work, double* xchg, double* result, const double* weights,
                                   const double* mass, const double* dinv, const double* F0L,
                                   const double* F0U, const double* F1L,
                                   const double* F1U, const double* L0L, const double* L0U,
                                   const double* L1L, const double* L1U, const int* level_ptr,
                                   const int* level_rows,
                                   const int* ilu_meta, const double* Sx, const double* Sy,
                                   const double* Sz, const double* sc, int nz, int ny, int nx,
                                   int dim, int pc, int noffs, int nlev, double rtol, double atol,
                                   double dtol, int max_it, int restart, double coef,
                                   double in_rtol, double in_atol, int in_max,
                                   int in_restart, double in_dtol, int max_level_rows, void* stream) {
  using namespace perphil;
  if (xchg == nullptr || (dim != 2 && dim != 3) || nx < 1 || ny < 1 || nz < 1 || (dim == 2 && nz != 1) ||
      restart < 1 || restart + 1 > kMaxBasis || pc < kPcNone || pc > kPcFieldsplitIlu || in_restart < 0 ||
      in_restart + 1 > kMaxBasis || (in_restart > 0 && pc != kPcFieldsplitIlu)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool ilu = pc == kPcIlu || pc == kPcFieldsplitIlu;
  const bool fields = pc == kPcFieldsplitLu || pc == kPcFieldsplitIlu;
  if ((pc == kPcJacobi && dinv == nullptr) || (pc >= kPcFieldsplitLu && work == nullptr) ||
      (ilu && (F0L == nullptr || F0U == nullptr || level_ptr == nullptr || level_rows == nullptr || nlev < 1)) ||
      (pc == kPcFieldsplitIlu && (F1L == nullptr || F1U == nullptr)) ||
      (pc == kPcFieldsplitLu && (Sx == nullptr || Sy == nullptr || sc == nullptr ||
                                 nx < 3 || ny < 3 || (dim == 3 && nz < 3))) ||
      (fields && mass == nullptr) || (ilu && max_level_rows < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  PcTables tab{};
  if (ilu && !ilu_meta_from_host(ilu_meta, noffs, tab.meta)) return (int)cudaErrorInvalidValue;
  if (fields) {
    for (int o = 0; o < 27; ++o) {
      tab.mass[o] = mass[o];
      tab.sw[0][o] = weights[o];
      tab.sw[1][o] = weights[27 + o];
    }
  }
  const GmresArgs a{b, x0, x, V, xchg, result, max_level_rows, weights_from_host<double>(weights),
                    Grid{nz, ny, nx},
                    GmresParams{rtol, atol, dtol, max_it, restart, in_rtol, in_atol, in_max, in_restart,
                                in_dtol, coef, stencil_masks(weights_from_host<double>(weights))},
                    PcData{dinv, F0L, F0U, F1L, F1U, L0L, L0U, L1L, L1U, level_ptr, level_rows, nlev, Sx, Sy, Sz,
                           sc, work},
                    tab, dim};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#ifdef PERPHIL_FUSED_GMRES_ONLY
  // a probe unit that builds one role
  err = pc == PERPHIL_FUSED_GMRES_ONLY ? launch_fused_gmres<PERPHIL_FUSED_GMRES_ONLY>(a, st) : cudaErrorInvalidValue;
#else
  switch (pc) {
    case kPcJacobi: err = launch_fused_gmres<kPcJacobi>(a, st); break;
    case kPcFieldsplitLu: err = launch_fused_gmres<kPcFieldsplitLu>(a, st); break;
    case kPcIlu: err = launch_fused_gmres<kPcIlu>(a, st); break;
    case kPcFieldsplitIlu: err = launch_fused_gmres<kPcFieldsplitIlu>(a, st); break;
    default: err = launch_fused_gmres<kPcNone>(a, st); break;
  }
#endif
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The static shared memory of pc's kernel in `dim` dimensions, in bytes (-1
// where the runtime cannot say, -2 for an unknown pc or dim): what each role
// leaves of kMaxSmemPerBlock must hold kGmresSmemBudget.
#ifndef PERPHIL_FUSED_GMRES_SMEM_SYMBOL
#define PERPHIL_FUSED_GMRES_SMEM_SYMBOL perphil_fused_gmres_static_smem
#endif
extern "C" int PERPHIL_FUSED_GMRES_SMEM_SYMBOL(int pc, int dim) {
  using namespace perphil;
  if (dim != 2 && dim != 3) return -2;
#ifdef PERPHIL_FUSED_GMRES_ONLY
  return pc == PERPHIL_FUSED_GMRES_ONLY ? fused_gmres_static_smem<PERPHIL_FUSED_GMRES_ONLY>(dim) : -2;
#else
  switch (pc) {
    case kPcNone: return fused_gmres_static_smem<kPcNone>(dim);
    case kPcJacobi: return fused_gmres_static_smem<kPcJacobi>(dim);
    case kPcFieldsplitLu: return fused_gmres_static_smem<kPcFieldsplitLu>(dim);
    case kPcIlu: return fused_gmres_static_smem<kPcIlu>(dim);
    case kPcFieldsplitIlu: return fused_gmres_static_smem<kPcFieldsplitIlu>(dim);
    default: return -2;
  }
#endif
}
