// band_trisolve_syncfree: a variant of band_trisolve (csrc/band_trisolve.cu)
// for tools/profile_kernels.py --only band, built alone: the same apply on
// the same level-ordered factor (one block's schedule: a level's slices in
// order), with per-row ready flags in place of level barriers. A persistent
// grid (cooperative launch: every block resident) deals the slices, in level
// order, to its warps round robin; a lane spins only on the flags of the rows
// it reads (ld.acquire.gpu), then reads their values through L2, and
// publishes its own value with st.release.gpu of its flag. A warp takes its
// slices in order, and a slice reads only slices of earlier levels, so the
// earliest unfinished slice can always proceed. The forward sweep writes y
// and its flags, the backward one x and its own (a backward row may finish
// while a forward row that reads its y is still waiting), each flag set to
// the launch's epoch (flags start at 0; a lane reads only its row's own
// entries, never the padding). Each product, difference and quotient is rounded on its own,
// as in the package's kernel, so the result is its bits.

#include <cuda_runtime.h>

namespace perphil {

constexpr int kSyncThreads = 256;
constexpr int kSyncMaxWidth = 40;
constexpr int kSyncRowBits = 25;

__device__ __forceinline__ int sync_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void sync_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" : : "l"(p), "r"(v) : "memory");
}

__global__ void __launch_bounds__(kSyncThreads)
band_syncfree_kernel(const double* __restrict__ r, double* __restrict__ z, double* vy, double* vx, int* fy, int* fx,
                     const unsigned char* __restrict__ blob, const int4* __restrict__ slices,
                     const int* __restrict__ perm, int nsl_l, int nsl, int epoch) {
  const double* f64 = reinterpret_cast<const double*>(blob);
  const int* i32 = reinterpret_cast<const int*>(blob);
  const int lane = threadIdx.x & 31;
  const int gwarp = (blockIdx.x * kSyncThreads + threadIdx.x) >> 5;
  const int warps = gridDim.x * (kSyncThreads / 32);
  for (int j = gwarp; j < nsl; j += warps) {
    const int4 sl = __ldg(slices + j);  // the slice's values, diagonals, columns, rows words (element offsets)
    const int word = __ldg(i32 + sl.w + lane);
    if (word < 0) continue;
    const int row = word & ((1 << kSyncRowBits) - 1), len = word >> kSyncRowBits;
    const bool upper = j >= nsl_l;
    const int* flag = upper ? fx : fy;
    const double* vec = upper ? vx : vy;
    double acc;
    if (upper) {
      while (sync_acquire(fy + row) < epoch) {
      }
      acc = __ldcg(vy + row);
    } else {
      acc = __ldg(r + __ldg(perm + row));
    }
    double v[kSyncMaxWidth];
#pragma unroll
    for (int k = 0; k < kSyncMaxWidth; ++k) {
      if (k < len) {
        const int c = __ldg(i32 + sl.z + 32 * k + lane);
        while (sync_acquire(flag + c) < epoch) {
        }
        v[k] = __ldcg(vec + c);
      }
    }
#pragma unroll
    for (int k = 0; k < kSyncMaxWidth; ++k) {
      if (k < len) acc = __dsub_rn(acc, __dmul_rn(__ldg(f64 + sl.x + 32 * k + lane), v[k]));
    }
    if (upper) {
      acc = __ddiv_rn(acc, __ldg(f64 + sl.y + lane));
      __stcg(vx + row, acc);
      z[__ldg(perm + row)] = acc;
      sync_release(fx + row, epoch);
    } else {
      __stcg(vy + row, acc);
      sync_release(fy + row, epoch);
    }
  }
}

}  // namespace perphil

// r, z: (n,) f64 natural order; vy, vx: (n,) f64; fy, fx: (n,) int32 flags
// (0 before the first launch); blob: the package's level-ordered factor on
// one block (ops/bandsolve.py::level_schedule); slices: per slice, in level
// order (the forward sweep's nsl_l first), the element offsets of its
// values and diagonals (f64) and of its columns and rows words (int32) in
// blob; epoch: this launch's flag value, larger than every earlier launch's.
extern "C" int perphil_band_trisolve_syncfree(const double* r, double* z, double* vy, double* vx, int* fy, int* fx,
                                              const unsigned char* blob, const int* slices, const int* perm,
                                              int nsl_l, int nsl, int epoch, void* stream) {
  using namespace perphil;
  if (nsl < 1 || nsl_l < 0 || nsl_l > nsl || epoch < 1) return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, band_syncfree_kernel, kSyncThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  int grid = sms * per_sm;
  const int need = (nsl + kSyncThreads / 32 - 1) / (kSyncThreads / 32);
  if (grid > need) grid = need;
  const int4* sl = reinterpret_cast<const int4*>(slices);
  void* args[] = {(void*)&r,  (void*)&z,    (void*)&vy,  (void*)&vx,    (void*)&fy,  (void*)&fx,
                  (void*)&blob, (void*)&sl, (void*)&perm, (void*)&nsl_l, (void*)&nsl, (void*)&epoch};
  err = cudaLaunchCooperativeKernel((const void*)band_syncfree_kernel, dim3(grid), dim3(kSyncThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
