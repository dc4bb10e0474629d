// K8's field ILU(0) sweep pair on 2D fields as a line pipeline: z = U^{-1}
// L^{-1} r for one field's block inside the fused GMRES kernel (K8,
// fused_gmres_kernel.cuh::field_pc), on block 0 of the cluster. It replaces,
// for those fields, the ring of ilu_sweep.cuh (which K7, the standalone
// apply and 3D fields keep).
//
// What it computes is the plain sweep's (ops/ilu.py::_clip_sweep on
// StructuredILU0's tables) bit for bit: a row is acc = rhs[row], then acc -
// f[q] * z[col] over the side's four offsets in stored order, each product
// and difference rounded on its own (__dmul_rn / __dsub_rn), then on the
// upper side __ddiv_rn by the diagonal. z starts at zero; a column below row
// 0 reads row 0 as it stands at that level, one past the last row reads
// zero.
//
// Why a pipeline: a field's level key is x + 2y, so a level holds at most one
// node of each grid line y, and a sweep of a 129^2 field is 385 levels of at
// most 65 rows. The ring paid a full / empty mbarrier handshake, shared-memory
// round trips for z and a barrier of its consumer warps at every level
// (~1,231 cycles a level, almost all of it synchronisation). Here:
//   - a lane owns kLineSlots grid lines (pipeline line j = (32 kLineSlots w +
//     32 k + lane) for warp w, slot k), the warps ceil(ny / (32 kLineSlots));
//     at step t the slot of line j computes position p = t - 2j where that
//     lies in [0, nx). The lower sweep runs lines y = j at x = p; the upper
//     sweep the mirror image, y = ny - 1 - j, x = nx - 1 - p, so that both
//     read their neighbours from line j - 1 at positions p - 1, p, p + 1,
//     computed at steps t - 3, t - 2 and t - 1, and the line's own value at
//     p - 1 from step t - 1.
//   - Each step a lane passes the value it computed the step before to the
//     lane above by one shuffle (lane 31's slot k to lane 0's slot k + 1),
//     which keeps it in a 3-deep register history. Across warps the top line
//     of warp w writes its values to an edge line in shared memory, which
//     starts each sweep as a signalling NaN (no arithmetic result is one);
//     warp w + 1 loads the value its lane 0 needs beside the step's shuffle
//     and, only where it still finds the NaN, spins on it (a rare path out
//     of line). No barrier, mbarrier or z load lies on a step's path: one
//     per sweep pair before it starts and one between the sweeps (the upper
//     reads the lower's y, other lanes' rows, from device memory).
//   - Every slot runs its row's arithmetic each step; a slot with no row
//     keeps nothing, so no branch lies on the step's path either.
//   - The upper side's divide by the diagonal is the quotient by the
//     diagonal's reciprocal corrected by two FMAs (line_div), the bits of
//     __ddiv_rn without its ~400 cycles on the step's path.
//   - The row's entries and right-hand side do not depend on the chain: each
//     lane copies its rows kLineAhead steps ahead by cp.async into a ring of
//     its own in shared memory (no register holds them, no other lane reads
//     them: cp.async.wait_group, no barrier), from the factor laid out by
//     row (StructuredILU0.line_tables: a row's four lower entries, or its four
//     upper entries, the diagonal and its reciprocal, in 16-byte pieces) and
//     the right-hand side's 16-byte piece that holds the row, past L1 (other
//     blocks wrote it). Each piece of a warp's 32 lanes lies side by side:
//     no bank conflict.
//   - The sweeps are functions of their own (not inlined), so that the
//     kernel's other phases' registers do not crowd them.
//   - Where the twin reads a column outside the grid, or one not computed
//     yet at that level, the slot takes the twin's value by rule (zero, row
//     0, or the line's own first value), never what a register holds.
// Fields narrower than kLineMinNx nodes (whose wrapped columns read rows of
// lines two below) and 3D fields take the ring.
#pragma once

#include <cstdint>

#include "ilu_sweep.cuh"

namespace perphil {

// lines a lane owns (a probe build may define another count)
#ifdef PERPHIL_K8_LINE_SLOTS
constexpr int kLineSlots = PERPHIL_K8_LINE_SLOTS;
#else
constexpr int kLineSlots = 1;
#endif
// rows of a lane in flight, and so the steps a lane copies its rows ahead
// (and the stages of its ring: a step's copies go into the stage it has just
// read)
constexpr int kLineRowsAhead = 12;
constexpr int kLineAhead = kLineSlots >= kLineRowsAhead ? 1 : kLineRowsAhead / kLineSlots;
// a row's stage: four 16-byte pieces (six factor doubles, then the piece of
// rhs that holds the row), each piece of a warp's 32 lanes side by side, so
// that a warp's copy or load of a piece is 512 contiguous bytes
constexpr int kLineRowBytes = 64;
constexpr int kLineMinNx = 5;
constexpr int kLineMaxWarps = 16;   // the fused kernel's block
constexpr int kLineBarrier = 2;     // the named barrier of the sweep's warps
constexpr unsigned long long kLineEmpty = 0x7ff4000000000001ull;  // a signalling NaN
// steps each warp of a sweep runs past its last row, rows empty: a probe
// build's measure of an empty step (0 in the package)
#ifdef PERPHIL_K8_EXTRA_STEPS
constexpr int kLineExtraSteps = PERPHIL_K8_EXTRA_STEPS;
#else
constexpr int kLineExtraSteps = 0;
#endif
// the probe build of K8 before the pipeline (csrc/profile/fused_gmres_k8_ring.cu) keeps every field on the ring
#ifdef PERPHIL_K8_RING
constexpr bool kLineRing = true;
#else
constexpr bool kLineRing = false;
#endif

// Warps of the pipeline for a 2D field of nx x ny nodes whose factor has the
// 9-point offsets in the schedule x + 2y (lower deltas -nx-1, -nx, -nx+1, -1
// in stored order, upper 1, nx-1, nx, nx+1, nx + 2 (ny - 1) levels); 0 where
// the ring runs instead.
inline int line_warps(const IluMeta& m, int dim, int nx, int ny, int nlev) {
  if (kLineRing) return 0;
  const int low[4] = {-nx - 1, -nx, -nx + 1, -1}, up[4] = {1, nx - 1, nx, nx + 1};
  if (dim != 2 || nx < kLineMinNx || ny < 2 || nlev != nx + 2 * (ny - 1) || m.nlow != 4 || m.nup != 4) return 0;
  for (int q = 0; q < 4; ++q) {
    if (m.delta[m.low[q]] != low[q] || m.delta[m.up[q]] != up[q]) return 0;
  }
  const int w = (ny + 32 * kLineSlots - 1) / (32 * kLineSlots);
  return w <= kLineMaxWarps ? w : 0;
}

// Shared memory of the pipeline: the edge lines of both sweeps, then each
// warp's ring of row stages.
inline long line_ring_bytes(int warps) { return (long)warps * kLineAhead * kLineSlots * 32 * kLineRowBytes; }
inline long line_bytes(int warps, int nx) {
  return (warps > 1 ? 16L * (warps - 1) * nx : 0) + line_ring_bytes(warps);
}

#ifdef PERPHIL_GMRES_PROFILE
// The profile build's clocks: the cycles thread 0 (warp 0, the pipeline's
// head, which waits on no other warp) spends in a step's parts: the shuffle
// and the wait for its rows' copies, its row, the next copies. The kernel
// adds them to its result after its own phases (kLineProfSlots).
static __device__ long long line_prof[3];
#define PERPHIL_LINE_MARK(i)                                \
  do {                                                      \
    const long long now_ = clock64();                       \
    line_clk_[i] += now_ - line_t0_;                        \
    line_t0_ = now_;                                        \
  } while (0)
#else
#define PERPHIL_LINE_MARK(i) \
  do {                       \
  } while (0)
#endif
constexpr int kLineProfSlots = 3;

__device__ __forceinline__ bool line_empty(double v) {
  return __double_as_longlong(v) == (long long)kLineEmpty;
}

// The edge value at shared address `addr`, once its writer has stored it (a
// wait that outlasts ~2^35 cycles is a fault of the protocol: trap). Not
// inlined: it is the rare path of a step.
static __device__ __noinline__ double line_wait(unsigned addr) {
  double v = lds_f64(addr);
  if (!line_empty(v)) return v;
  const long long t0 = clock64();
  do {
    if (clock64() - t0 > (1ll << 35)) __trap();
    v = lds_f64(addr);
  } while (line_empty(v));
  return v;
}

__device__ __forceinline__ void cp_async16_ca(unsigned smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(smem), "l"(__cvta_generic_to_global(gmem))
               : "memory");
}

__device__ __forceinline__ void cp_async16_cg(unsigned smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem), "l"(__cvta_generic_to_global(gmem))
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ double2 lds_f64x2(unsigned addr) {
  double2 v;
  asm volatile("ld.shared.v2.f64 {%0, %1}, [%2];\n" : "=d"(v.x), "=d"(v.y) : "r"(addr) : "memory");
  return v;
}

// One sweep over lines (kUpper: the upper side, mirrored): F the side's
// factor by row (4 doubles a row, upper 6), rhs and out (nx * ny values) in
// device memory (rhs readable 8 bytes either side: a piece of 16 is copied);
// edges: 2 (warps - 1) nx doubles of shared memory, this sweep's half filled
// with kLineEmpty, then the warps' rings.
// acc / d correctly rounded, the bits __ddiv_rn gives, with r = RN(1 / d)
// from the factor's table: q = RN(acc r), the remainder acc - q d exact by
// one FMA, then RN(q + remainder r) by another (Markstein's theorem: r within
// half an ulp of 1 / d and q within an ulp of acc / d make it the correctly
// rounded quotient). About 25 cycles of dependent latency on an H100 where
// __ddiv_rn takes about 400 on a step's path. A zero takes acc r (the
// quotient's signed zero); a quotient far from 1, where an intermediate could
// leave the normal range, and a non-finite one take __ddiv_rn.
// `live` false (a slot with no row this step): never the slow divide.
__device__ __forceinline__ double line_div(double acc, double d, double r, bool live) {
  double q = __dmul_rn(acc, r);
  const double c = __fma_rn(__fma_rn(-q, d, acc), r, q);
  const double m = fabs(c);
  q = acc == 0.0 ? q : c;
  if (live && acc != 0.0 && !(m >= 0x1p-960 && m <= 0x1p960)) q = __ddiv_rn(acc, d);
  return q;
}

template <bool kUpper>
__device__ __noinline__ void line_sweep(const double* F, const double* rhs, double* out, double* edges, int nx,
                                        int ny, int warps) {
  constexpr int K = kLineSlots, D = kLineAhead, kItems = kUpper ? 6 : 4;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int steps = nx + 2 * (ny - 1);
  const int j0 = 32 * K * w;
  const int jlast = min(ny, j0 + 32 * K) - 1;
  const int t0 = j0 > 0 ? 2 * j0 - 1 : 0, t1 = min(steps, nx + 2 * jlast) + kLineExtraSteps;
  const unsigned eb = smem_addr(edges);
  const unsigned half = eb + (kUpper ? 8u * (unsigned)((warps - 1) * nx) : 0u);
  const unsigned below = half + 8u * (unsigned)((w - 1) * nx), top = half + 8u * (unsigned)(w * nx);
  // this lane's stages, after the edge lines: the warp's [d][k][piece][lane]
  // of 16 bytes
  const unsigned ring = eb + 16u * (unsigned)((warps - 1) * nx) + (unsigned)(w * D * K * 32 * kLineRowBytes) +
                        16u * (unsigned)lane;
  auto stage = [&](int d, int k) { return ring + (unsigned)((d * K + k) * 32 * kLineRowBytes); };
  const bool writer = lane == 31 && w < warps - 1, reader = lane == 0 && w > 0;
  int j[K];
#pragma unroll
  for (int k = 0; k < K; ++k) j[k] = j0 + 32 * k + lane;

  // copy the row of line jj at step s into stage st: its entries, then the
  // 16-byte piece of rhs that holds it
  auto fetch = [&](int s, int jj, unsigned st) {
    const int p = s - 2 * jj;
    if (p < 0 || p >= nx || jj >= ny) return;
    const int y = kUpper ? ny - 1 - jj : jj, x = kUpper ? nx - 1 - p : p;
    const int row = x + y * nx;
    const double* f = F + (size_t)kItems * row;
#pragma unroll
    for (int h = 0; h < kItems / 2; ++h) cp_async16_ca(st + 512u * h, f + 2 * h);
    cp_async16_cg(st + 1536u, reinterpret_cast<const void*>(reinterpret_cast<uintptr_t>(rhs + row) & ~(uintptr_t)15));
  };
  // lane 0's value from the warp below at step s, its top line at p + 1:
  // loaded by the whole warp (one address, no branch) beside the step's
  // shuffle, and only where it is not written yet, waited for (line_wait,
  // the rare path: no loop lies on a step's path)
  auto cross = [&](int s) {
    const int at = s - 2 * j[0] + 1;
    const double v = w > 0 ? lds_f64(below + 8u * (unsigned)min(max(at, 0), nx - 1)) : 0.0;
    return reader && at >= 0 && at < nx && line_empty(v) ? line_wait(below + 8u * (unsigned)at) : v;
  };

  double h1[K], h2[K], h3[K], own[K], first[K];
#pragma unroll
  for (int k = 0; k < K; ++k) h1[k] = h2[k] = h3[k] = own[k] = first[k] = 0.0;
#pragma unroll 1
  for (int d = 0; d < D; ++d) {
#pragma unroll
    for (int k = 0; k < K; ++k) fetch(t0 + d, j[k], stage(d, k));
    cp_async_commit();
  }
#ifdef PERPHIL_GMRES_PROFILE
  long long line_t0_ = clock64(), line_clk_[kLineProfSlots] = {0, 0, 0};
#endif
  for (int t = t0; t < t1; t += D) {
    // a turn of the ring unrolled: each stage's offsets are constants, and
    // the scheduler overlaps a step's loads with the step before
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int s = t + d;
      if (s >= t1) break;  // the same for the whole warp
      // the values the lines below computed at step s - 1
      double got[K];
#pragma unroll
      for (int k = 0; k < K; ++k) got[k] = __shfl_sync(0xffffffffu, own[k], (lane + 31) & 31);
      const double below_top = cross(s);
      if (lane == 0) {
#pragma unroll
        for (int k = K - 1; k > 0; --k) got[k] = got[k - 1];
        got[0] = below_top;
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        h3[k] = h2[k];
        h2[k] = h1[k];
        h1[k] = got[k];
      }
      cp_async_wait<D - 1>();  // this step's rows have landed
      PERPHIL_LINE_MARK(0);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        // every slot runs the row's arithmetic (no branch on the step's
        // path); only a live slot's result is kept
        const int jj = j[k], p = s - 2 * jj;
        const bool live = p >= 0 && p < nx && jj < ny;
        const unsigned st = stage(d, k);
        const int y = kUpper ? ny - 1 - jj : jj, x = kUpper ? nx - 1 - p : p;
        const int row = x + y * nx;
        const unsigned odd = (unsigned)((reinterpret_cast<uintptr_t>(rhs + row) >> 3) & 1);
        double a[4];  // the twin's z at the side's offsets, in stored order
        if constexpr (!kUpper) {
          // (-1,-1), (0,-1), (+1,-1), (-1,0); line 0 reads row 0 below the grid
          a[0] = jj >= 1 ? (p >= 1 ? h3[k] : (jj == 1 ? h2[k] : 0.0)) : (p >= 1 ? first[k] : 0.0);
          a[1] = jj >= 1 ? h2[k] : (p >= 1 ? first[k] : 0.0);
          a[2] = jj >= 1 ? (p < nx - 1 ? h1[k] : first[k]) : (p >= 1 ? first[k] : 0.0);
          a[3] = p >= 1 ? own[k] : 0.0;
        } else {
          // (+1,0), (-1,+1), (0,+1), (+1,+1), mirrored; past the last row reads zero
          a[0] = p >= 1 ? own[k] : 0.0;
          a[1] = p == nx - 1 ? first[k] : (jj >= 1 ? h1[k] : 0.0);
          a[2] = jj >= 1 ? h2[k] : 0.0;
          a[3] = jj >= 1 && p >= 1 ? h3[k] : 0.0;
        }
        const double2 f01 = lds_f64x2(st), f23 = lds_f64x2(st + 512u), b = lds_f64x2(st + 1536u);
        const double f[4] = {f01.x, f01.y, f23.x, f23.y};
        double acc = odd ? b.y : b.x;
#pragma unroll
        for (int q = 0; q < 4; ++q) acc = __dsub_rn(acc, __dmul_rn(f[q], a[q]));
        if constexpr (kUpper) {
          const double2 dr = lds_f64x2(st + 1024u);  // the diagonal and its reciprocal
          acc = line_div(acc, dr.x, dr.y, live);
        }
        own[k] = live ? acc : own[k];
        first[k] = live && p == 0 ? acc : first[k];
        if (live) {
          out[row] = acc;
          if (k == K - 1 && writer) sts_f64(top + 8u * (unsigned)p, acc);
        }
      }
      PERPHIL_LINE_MARK(1);
#pragma unroll
      for (int k = 0; k < K; ++k) fetch(s + D, j[k], stage(d, k));
      cp_async_commit();
      PERPHIL_LINE_MARK(2);
    }
  }
  cp_async_wait<0>();
#ifdef PERPHIL_GMRES_PROFILE
  if (threadIdx.x == 0 && blockIdx.x == 0) {
    for (int i = 0; i < kLineProfSlots; ++i) line_prof[i] += line_clk_[i];
  }
#endif
}

// z = U^{-1} L^{-1} r for a 2D field of nx x ny nodes on `warps` warps of
// the block (the others return at once): FL, FU the factor's sides by row
// (StructuredILU0.line_tables), y (device memory) the lower sweep's output,
// edges line_bytes(warps, nx) of shared memory. r is complete in device
// memory before the call, and r and y are readable 8 bytes either side; z is
// written when every warp of the pipeline has returned (the caller's
// barrier).
__device__ inline void line_sweep_pair(const double* FL, const double* FU, const double* r, double* y, double* z,
                                       double* edges, int nx, int ny, int warps) {
  if ((int)(threadIdx.x >> 5) >= warps) return;
  const int threads = 32 * warps;
  for (int e = threadIdx.x; e < 2 * (warps - 1) * nx; e += threads) {
    edges[e] = __longlong_as_double((long long)kLineEmpty);
  }
  named_barrier(kLineBarrier, threads);
  line_sweep<false>(FL, r, y, edges, nx, ny, warps);
  named_barrier(kLineBarrier, threads);  // y complete
  line_sweep<true>(FU, y, z, edges, nx, ny, warps);
}

}  // namespace perphil
