// structured_ilu_apply with the sweep's cycle counters compiled in: built
// only by tools/profile_kernels.py, never into the package's library.

#define PERPHIL_ILU_PROFILE 1
#include "../ilu_apply.cu"

// Copies the five counters (ilu_sweep.cuh: ilu_prof) to `out` on the host,
// then sets them to zero.
extern "C" int perphil_ilu_profile_take(long long* out) {
  const long long zero[5] = {0, 0, 0, 0, 0};
  cudaError_t err = cudaMemcpyFromSymbol(out, perphil::ilu_prof, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(perphil::ilu_prof, zero, sizeof(zero));
  return (int)err;
}
