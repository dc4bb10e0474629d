// Structured ILU(0) application z = U^{-1} L^{-1} r as two wavefront sweeps
// inside one thread block: the device function that the standalone apply
// (ilu_apply.cu) and the fused GMRES kernel's K7/K8 preconditioners share.
//
// The factor is stored by offset, F[t * nrows + row] (ops/ilu.py's
// StructuredILU0.factors); the levels come as CSR (level_ptr, level_rows).
// Every row of a level depends only on rows of lower levels (upper sweep:
// higher levels), so a level's rows update in parallel, one barrier per
// level. The arithmetic is the plain sweep's (StructuredILU0._sweep) bit for
// bit: acc = rhs[row], then acc - f[t] * z[col] over the offsets in stored
// order, each product and difference rounded on its own (__dmul_rn /
// __dsub_rn: nvcc would contract them into FMAs), then a divide by the
// diagonal on the upper sweep. A column below row 0 reads row 0 and one past
// the last row reads zero (the plain sweep's clip onto its zero pad); z
// starts at zero. Entries of offsets that fall outside the grid are zero, so
// whatever such a read finds adds nothing.
#pragma once

#include <cuda_runtime.h>

namespace perphil {

constexpr int kMaxSideOffsets = 40;  // 3D monolithic: 27 + 13 per side
constexpr int kMaxOffsets = 81;

// The offset table, as ops/ilu.py's StructuredILU0.meta lays it out:
// [nlow, nup, center, low[40], up[40], delta[noffs]].
struct IluMeta {
  int nlow, nup, center;
  int low[kMaxSideOffsets];
  int up[kMaxSideOffsets];
  int delta[kMaxOffsets];
};

// Host: the table from its int32 layout; false if it does not fit.
inline bool ilu_meta_from_host(const int* m, int noffs, IluMeta& out) {
  if (noffs < 1 || noffs > kMaxOffsets || m[0] < 0 || m[0] > kMaxSideOffsets || m[1] < 0 ||
      m[1] > kMaxSideOffsets || m[2] < 0 || m[2] >= noffs) {
    return false;
  }
  out.nlow = m[0];
  out.nup = m[1];
  out.center = m[2];
  for (int q = 0; q < kMaxSideOffsets; ++q) {
    out.low[q] = m[3 + q];
    out.up[q] = m[3 + kMaxSideOffsets + q];
  }
  for (int t = 0; t < kMaxOffsets; ++t) out.delta[t] = t < noffs ? m[3 + 2 * kMaxSideOffsets + t] : 0;
  return true;
}

// One sweep: z = L^{-1} rhs (kUpper false, unit lower) or U^{-1} rhs (kUpper
// true). `m` should live in shared memory (it is indexed at run time). Begins
// and ends with a barrier, so rhs written before the call and z read after it
// are safe.
template <bool kUpper>
__device__ void ilu_sweep(const double* F, int nrows, const IluMeta& m, const int* level_ptr,
                          const int* level_rows, int nlev, const double* rhs, double* z) {
  for (int e = threadIdx.x; e < nrows; e += blockDim.x) z[e] = 0.0;
  __syncthreads();
  const int nt = kUpper ? m.nup : m.nlow;
  const int* offs = kUpper ? m.up : m.low;
  for (int s = 0; s < nlev; ++s) {
    const int lv = kUpper ? nlev - 1 - s : s;
    const int end = level_ptr[lv + 1];
    for (int i = level_ptr[lv] + threadIdx.x; i < end; i += blockDim.x) {
      const int row = level_rows[i];
      double acc = rhs[row];
      for (int q = 0; q < nt; ++q) {
        const int t = offs[q];
        const int col = max(row + m.delta[t], 0);
        const double zc = col < nrows ? z[col] : 0.0;
        acc = __dsub_rn(acc, __dmul_rn(F[(size_t)t * nrows + row], zc));
      }
      if (kUpper) acc = __ddiv_rn(acc, F[(size_t)m.center * nrows + row]);
      z[row] = acc;
    }
    __syncthreads();
  }
}

// z = U^{-1} L^{-1} r, with y (nrows) as scratch.
__device__ __forceinline__ void ilu_apply(const double* F, int nrows, const IluMeta& m,
                                          const int* level_ptr, const int* level_rows, int nlev,
                                          const double* r, double* y, double* z) {
  ilu_sweep<false>(F, nrows, m, level_ptr, level_rows, nlev, r, y);
  ilu_sweep<true>(F, nrows, m, level_ptr, level_rows, nlev, y, z);
}

}  // namespace perphil
