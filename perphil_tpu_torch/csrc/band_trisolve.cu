// band_trisolve: one banded block triangular solve of the ordering-parity
// ILU apply (pc_factor_mat_ordering_type=rcm), for ops/bandsolve.py::tri_apply.
//
// Replaces no Pallas kernel: in the JAX package this solve is XLA
// (perphil_tpu/ops/bandsolve.py:164, tri_apply, a lax.scan of two dense f32
// matvecs a block). Here it is f64 and one cooperative launch a factor.
//
// What it computes: P is (nb, B, B) f64, block k holding X_k (the inverse of
// the k-th B x B diagonal block of the factor) and C_k (its coupling to the
// neighbouring block) in disjoint positions: lower (unit diagonal implied)
// X_k at columns < row, C_k at columns >= row + pad; upper X_k at columns
// >= row, C_k at columns <= row - pad (pad = B - bandwidth >= 1). With
// r = (nb * B,) the recurrence is
//
//   u = r_k - C_k y_{k-1};  y_k = u + X_k u     (lower, k = 0 .. nb-1)
//   u = r_k - C_k y_{k+1};  y_k = X_k u         (upper, k = nb-1 .. 0)
//
// with no coupling at the first step taken.
//
// Bound on the H100: bytes. A block is 36.8 MB at B = 2144 (tet nx=40), far
// beyond shared memory or a cluster's, so each step is two dependent
// matvecs over the whole card. Each row reads only its masked part: about
// B - pad entries of the B a step, both halves together (the packed blocks
// are 4.85 GB for the four factors at nx=40). The entries a factor needs
// (ops/bandsolve.py::tri_apply_traffic: 1.15 GB at nx=40) read once take
// 0.345 ms at 3.35 TB/s.
//
// Design: a persistent grid, launched cooperatively (every block resident),
// with a grid-wide barrier between the coupling half-step (u) and the
// inverse half-step (y_k), and after it. The rows go out in pairs, row p
// with row B-1-p, so that a pair's masked ranges add up to about one row in
// both half-steps (row i's coupling range shrinks with i where its inverse
// range grows); the grid is two blocks an SM (at most a block a pair) and
// each block takes an equal share of the pairs, one more at most. A block
// takes its rows kBandRows at a time: its threads walk the union of the
// rows' column ranges two columns a thread (16-byte loads), 64 consecutive
// columns a warp, each thread keeping one f64 sum a row, then the sums meet
// in a fixed order (warp butterfly, then the warps in order), so a result
// does not depend on the schedule. The vector (y_{k+-1} or u) is read
// through L2 (ld.global.cg: another SM wrote it in this launch), the blocks
// with streaming loads.

#include <cuda_runtime.h>

namespace perphil {

constexpr int kBandThreads = 256;
constexpr int kBandWarps = kBandThreads / 32;
constexpr int kBandRows = 10;  // rows a pass: one f64 sum each a thread
constexpr int kBandBlocksPerSm = 2;

struct GridBarrier {
  unsigned int count;
  unsigned int generation;
};

// Every block of a cooperative launch arrives, then all leave: release of
// this block's writes before arriving, acquire of the others' after leaving.
__device__ __forceinline__ void grid_sync(GridBarrier* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = &bar->generation;
    const unsigned int g = *gen;
    __threadfence();
    if (atomicAdd(&bar->count, 1u) == gridDim.x - 1) {
      atomicExch(&bar->count, 0u);
      __threadfence();
      atomicAdd(&bar->generation, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// Row q of the pair order: row q/2 for even q, B-1-q/2 for odd q.
__device__ __forceinline__ int pair_row(int q, int B) { return (q & 1) ? B - 1 - (q >> 1) : (q >> 1); }

// The masked column range [lo, hi) of row i in one half-step.
__device__ __forceinline__ void row_range(int i, int B, int pad, bool lower, bool coupling, int& lo, int& hi) {
  if (lower) {
    if (coupling) { lo = i + pad; hi = B; } else { lo = 0; hi = i; }
  } else {
    if (coupling) { lo = 0; hi = i - pad + 1; } else { lo = i; hi = B; }
  }
  if (hi < lo) hi = lo;
}

// One half-step on this block's rows [q0, q1) of the pair order: for each
// row i, s = sum over its masked range of Pk[i, j] * vec[j] (increasing j
// a thread), then
//   coupling: u[i] = rk[i] - s
//   inverse:  yk[i] = (lower ? u[i] : 0) + s
__device__ void half_step(const double* __restrict__ Pk, const double* vec, const double* __restrict__ rk,
                          double* u, double* yk, int B, int pad, bool lower, bool coupling, int q0, int q1) {
  __shared__ double part[kBandWarps][kBandRows];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int qb = q0; qb < q1; qb += kBandRows) {
    int row[kBandRows], lo[kBandRows], hi[kBandRows];
    int jmin = B, jmax = 0;
#pragma unroll
    for (int t = 0; t < kBandRows; ++t) {
      const int q = qb + t;
      row[t] = q < q1 ? pair_row(q, B) : 0;
      lo[t] = hi[t] = 0;
      if (q < q1) row_range(row[t], B, pad, lower, coupling, lo[t], hi[t]);
      if (hi[t] > lo[t]) {
        jmin = min(jmin, lo[t]);
        jmax = max(jmax, hi[t]);
      }
    }
    double acc[kBandRows];
#pragma unroll
    for (int t = 0; t < kBandRows; ++t) acc[t] = 0.0;
    // column pairs (2c, 2c+1): B is even and a row starts 256-byte aligned
    for (int c = (jmin >> 6 << 5) + threadIdx.x; 2 * c < jmax; c += kBandThreads) {
      const int j = 2 * c;
      const double2 v = __ldcg(reinterpret_cast<const double2*>(vec) + c);
      double2 p[kBandRows];
#pragma unroll
      for (int t = 0; t < kBandRows; ++t) {
        p[t] = make_double2(0.0, 0.0);
        if (j + 1 >= lo[t] && j < hi[t]) p[t] = __ldcs(reinterpret_cast<const double2*>(Pk + (size_t)row[t] * B) + c);
      }
#pragma unroll
      for (int t = 0; t < kBandRows; ++t) {
        if (j >= lo[t] && j < hi[t]) acc[t] = fma(p[t].x, v.x, acc[t]);
        if (j + 1 >= lo[t] && j + 1 < hi[t]) acc[t] = fma(p[t].y, v.y, acc[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < kBandRows; ++t) {
      double s = acc[t];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) part[warp][t] = s;
    }
    __syncthreads();
    const int q = qb + (int)threadIdx.x;
    if (threadIdx.x < kBandRows && q < q1) {
      double s = 0.0;
      for (int w = 0; w < kBandWarps; ++w) s += part[w][threadIdx.x];
      const int i = pair_row(q, B);
      if (coupling) {
        u[i] = rk[i] - s;
      } else {
        yk[i] = lower ? __ldcg(u + i) + s : s;
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kBandThreads, kBandBlocksPerSm)
band_trisolve_kernel(const double* __restrict__ P, const double* __restrict__ r, double* y, double* u,
                     GridBarrier* bar, int nb, int B, int pad, int lower) {
  // an equal share of the B/2 pairs a block, one more for the first ones
  const int pairs = B / 2, share = pairs / gridDim.x, extra = pairs % gridDim.x;
  const int b = blockIdx.x;
  const int q0 = 2 * (b * share + min(b, extra));
  const int q1 = q0 + 2 * (share + (b < extra ? 1 : 0));
  const size_t BB = (size_t)B * B;
  for (int step = 0; step < nb; ++step) {
    const int k = lower ? step : nb - 1 - step;
    const double* Pk = P + (size_t)k * BB;
    const double* rk = r + (size_t)k * B;
    if (step == 0) {
      // no block to couple to: u = r_k
      for (int q = q0 + (int)threadIdx.x; q < q1; q += kBandThreads) {
        const int i = pair_row(q, B);
        u[i] = rk[i];
      }
    } else {
      const double* prev = y + (size_t)(lower ? k - 1 : k + 1) * B;
      half_step(Pk, prev, rk, u, nullptr, B, pad, lower != 0, true, q0, q1);
    }
    grid_sync(bar);
    half_step(Pk, u, rk, u, y + (size_t)k * B, B, pad, lower != 0, false, q0, q1);
    if (step + 1 < nb) grid_sync(bar);
  }
}

}  // namespace perphil

// P: (nb, B, B) f64 packed [inverse | coupling] blocks; r, y: (nb * B,) f64
// (right-hand side in, solution out); u: (B,) f64 scratch; barrier: two
// zeroed 32-bit words; lower: 1 for the forward (unit-lower) recurrence, 0
// for the backward one. B is a multiple of 32, 1 <= pad <= B; every pointer
// 16-byte aligned.
extern "C" int perphil_band_trisolve(const double* P, const double* r, double* y, double* u, void* barrier,
                                     int nb, int B, int pad, int lower, void* stream) {
  using namespace perphil;
  if (nb < 1 || B < 32 || B % 32 != 0 || pad < 1 || pad > B) return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, band_trisolve_kernel, kBandThreads, 0);
  }
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  int grid = sms * (per_sm < kBandBlocksPerSm ? per_sm : kBandBlocksPerSm);
  if (grid > B / 2) grid = B / 2;  // at least a pair a block
  GridBarrier* bar = static_cast<GridBarrier*>(barrier);
  void* args[] = {(void*)&P, (void*)&r, (void*)&y, (void*)&u, (void*)&bar,
                  (void*)&nb, (void*)&B, (void*)&pad, (void*)&lower};
  err = cudaLaunchCooperativeKernel((const void*)band_trisolve_kernel, dim3(grid), dim3(kBandThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
