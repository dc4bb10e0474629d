// structured_ilu_apply: one structured ILU(0) application z = U^{-1} L^{-1} r
// in one thread block, for StructuredILU0.apply_flat on the card beyond the
// fused GMRES envelope (the monolithic ILU of GMRES+ILU at 2D N=128/256, the
// per-field ILU of the inner GMRES blocks of SS-GMRES+ILU there).
//
// Replaces no Pallas kernel: in the JAX package this apply is XLA
// (perphil_tpu/ops/ilu.py:716-728, StructuredILU0.apply_flat, a lax.scan over
// padded level batches, or the parallel-prefix trisolves). A torch-op
// wavefront would cost ~15 launches per level, ~12,000 per apply at 2D
// N=128; here it is one launch.
//
// Bound on the H100: latency. Two sweeps of nlev levels each (2D N=128:
// 389), one barrier per level, and a level holds at most a few hundred rows,
// so most of the 512 threads idle and one SM works. The factor (27 offsets x
// 33,282 rows x 8 B = 7.2 MB at N=128) streams through L2 once per sweep.
// Later PRs: several levels per barrier where rows allow, or the
// parallel-prefix form across blocks.

#include "ilu_sweep.cuh"

namespace perphil {

constexpr int kIluThreads = 512;

__global__ void __launch_bounds__(kIluThreads)
ilu_apply_kernel(const double* r, double* z, double* y, const double* F, const int* level_ptr,
                 const int* level_rows, IluMeta meta, int nrows, int nlev) {
  __shared__ IluMeta m;
  if (threadIdx.x == 0) m = meta;
  __syncthreads();
  ilu_apply(F, nrows, m, level_ptr, level_rows, nlev, r, y, z);
}

}  // namespace perphil

// r, z, y: (nrows,) f64 (y is scratch); F: (noffs, nrows) f64 factor;
// level_ptr: (nlev + 1,) int32, level_rows: (nrows,) int32; meta: the host
// int32 offset table (ops/ilu.py StructuredILU0.meta).
extern "C" int perphil_structured_ilu_apply(const double* r, double* z, double* y, const double* F,
                                            const int* level_ptr, const int* level_rows,
                                            const int* meta, int noffs, int nrows, int nlev,
                                            void* stream) {
  using namespace perphil;
  IluMeta m;
  if (nrows < 1 || nlev < 1 || !ilu_meta_from_host(meta, noffs, m)) {
    return (int)cudaErrorInvalidValue;
  }
  ilu_apply_kernel<<<1, kIluThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      r, z, y, F, level_ptr, level_rows, m, nrows, nlev);
  return (int)cudaGetLastError();
}
