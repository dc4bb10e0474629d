// The fused GMRES kernel (pc none) with its phase clocks compiled in: built
// only by tools/profile_kernels.py, never into the package's library.

#define PERPHIL_GMRES_PROFILE 1
#include "../fused_gmres_kernel.cuh"

// As perphil_fused_gmres for pc none (fused_gmres.cu); result: 7 + 7 f64,
// the last seven the cycles block 0's thread 0 spent in each phase
// (ProfPhase: apply, dots, Gram-Schmidt and norm, Givens, scaling, the
// step's last cluster barrier, the restart work).
extern "C" int perphil_fused_gmres_profile(const double* b, const double* x0, double* x, double* V,
                                           double* xchg, double* result, const double* weights,
                                           int nz, int ny, int nx, int dim, double rtol,
                                           double atol, double dtol, int max_it, int restart,
                                           void* stream) {
  using namespace perphil;
  if ((dim != 2 && dim != 3) || restart < 1 || restart + 1 > kMaxBasis) {
    return (int)cudaErrorInvalidValue;
  }
  const DppWeights<double> w = weights_from_host<double>(weights);
  const GmresArgs a{b, x0, x, V, xchg, result, 0, w, Grid{nz, ny, nx},
                    GmresParams{rtol, atol, dtol, max_it, restart, 0, 0.0, 0.0, 0, 0.0,
                                stencil_masks(w)},
                    PcData{}, PcTables{}, dim};
  const cudaError_t err = launch_fused_gmres<kPcNone>(a, static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
