// Structured ILU(0) application z = U^{-1} L^{-1} r as two wavefront sweeps
// inside one thread block: the device function that the standalone apply
// (ilu_apply.cu) and the fused GMRES kernel's K7/K8 preconditioners share.
//
// The levels come as CSR (level_ptr, level_rows). Each sweep reads its side
// of the factor packed by level (ops/ilu.py's StructuredILU0.packed_lower /
// packed_upper): level lv's block starts at items * level_ptr[lv] and holds
// [q][r], q < items the side's offsets in stored order (the upper side: then
// the diagonal), r the level's rows in level_rows order. A level's rows are
// scattered over the grid, so the factor by offset, F[t * nrows + row], costs
// a 32-byte sector for every 8 bytes used; packed, a level is one run.
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
//
// What bounds a sweep is the latency of one level, not bytes: a level holds
// tens to a few hundred rows, and only z[col] depends on the level before.
// Fetching level s + 1 from all threads and waiting for it at level s's
// barrier keeps the fetch's round trip on the critical path (2.88 us a level
// against 1.77 for a plain loop at 2D N=128 on an H100), and so do a row's
// nt z loads when each waits for the one before. So the block is split by
// warp (IluStage):
//   - Producer warps (of the last kIluProducerWarps, at most as many as the
//     ring has stages) run ahead through the levels, each warp those that
//     are its turn: a level's packed factor block as one linear run of
//     cp.async, plus its row indices and right-hand side, into a ring of
//     `stages` level buffers; the copies' completion arrives on the stage's "full"
//     mbarrier (cp.async.mbarrier.arrive.noinc), so no thread waits for it.
//     (With the factor by offset this gather alone took ~1500 sector
//     requests a level at 2D N=64, and bounded the sweep.)
//   - Consumer warps, only as many as the widest level needs, wait on
//     "full", read a row's entries from shared memory, load its z[col] in
//     groups of up to fourteen independent loads (straight code for the
//     offset counts the package's meshes give), run the chain of differences, store
//     z, and meet at a named barrier of the consumer warps alone (one a
//     level); one of them then arrives on the stage's "empty" mbarrier.
//   - The level bounds and the per-offset column deltas sit in shared memory
//     for the whole sweep. Where nrows doubles fit, z itself
//     lives in shared memory (and is stored to device memory as computed,
//     without waiting); else z stays in device memory, one L2 round trip a
//     level.
// A schedule whose widest level does not fit two stages (very wide levels,
// which have the parallelism to hide their loads) takes the direct loop.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace perphil {

constexpr int kMaxSideOffsets = 40;  // 3D monolithic: 27 + 13 per side
constexpr int kMaxOffsets = 81;
constexpr int kMaxSmemPerBlock = 232448;  // Hopper: 227 KB a block, static + dynamic

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

constexpr int kIluProducerWarps = 4;
constexpr int kIluMaxStages = 8;
constexpr int kIluConsumerBarrier = 1;  // the named barrier of the consumer warps

// How a sweep's shared memory is laid out, in bytes from the start of the
// region it is given: chosen on the host from what fits (ilu_plan), read on
// the device (ilu_stage).
struct IluPlan {
  int cap;         // rows of the widest level; 0: no stage, the direct loop
  int slots;       // stage doubles per row of a level: max(nlow, nup) + 2
  int stages;      // level buffers in the ring (2..kIluMaxStages)
  int z_smem;      // 1: z (nrows + 1 doubles) lives in shared memory (only beside a ring)
  int lp_smem;     // 1: level_ptr (nlev + 1 ints) is copied to shared memory
  int bytes;       // the whole region
};

// Host: the layout for a factor of nrows rows, nlev levels (the widest of
// max_rows rows) within `budget` bytes: the level bounds, the ring, then z.
// gs: the Gauss-Seidel mode's stage, a row's every off-centre entry and its
// diagonal (ilu_sweep's kGS).
inline IluPlan ilu_plan(const IluMeta& m, int nrows, int nlev, int max_rows, long budget, bool gs = false) {
  IluPlan p{0, (gs ? m.nlow + m.nup : (m.nlow > m.nup ? m.nlow : m.nup)) + 2, 0, 0, 0, 0};
  long used = 0;
  const long lp = 8 * (((long)nlev + 2) / 2);  // ints, kept 8-byte aligned
  if (lp <= budget / 4) {
    p.lp_smem = 1;
    used += lp;
  }
  auto ring = [&](int stages) {
    return (long)stages * max_rows * p.slots * 8 + 8 * (((long)stages * max_rows + 1) / 2);
  };
  const long zbytes = 8L * (nrows + 1);  // and the zero that a column past the last row reads
  // z in shared memory is worth more than a deeper ring: where it can fit
  // beside two stages, the ring is as deep as still leaves it room
  const long keep = used + ring(2) + zbytes <= budget ? zbytes : 0;
  for (int stages = kIluMaxStages; max_rows > 0 && stages >= 2 && p.cap == 0; --stages) {
    if (used + ring(stages) + keep <= budget) {
      p.cap = max_rows;
      p.stages = stages;
      used += ring(stages);
    }
  }
  if (p.cap > 0 && used + zbytes <= budget) {  // the direct loop keeps z in device memory
    p.z_smem = 1;
    used += zbytes;
  }
  p.bytes = (int)((used + 15) / 16 * 16);  // what follows it starts on 16 bytes
  return p;
}

// Device: the pointers into the region.
struct IluStage {
  const int* lp;  // level_ptr, in shared memory where the plan says so
  double* data;   // `stages` buffers of slots * cap doubles, or null
  int* rows;      // `stages` buffers of cap ints
  double* z;      // nrows + 1 doubles, or null
  int cap, slots, stages;
};

// Call with every thread of the block; ends with a barrier.
__device__ inline IluStage ilu_stage(const IluPlan& p, unsigned char* base, const int* level_ptr,
                                     int nrows, int nlev) {
  IluStage st{level_ptr, nullptr, nullptr, nullptr, p.cap, p.slots, p.stages};
  if (p.lp_smem) {
    int* lp = reinterpret_cast<int*>(base);
    for (int e = threadIdx.x; e <= nlev; e += blockDim.x) lp[e] = level_ptr[e];
    st.lp = lp;
    base += 8 * ((nlev + 2) / 2);
  }
  if (p.cap > 0) {
    st.data = reinterpret_cast<double*>(base);
    base += (long)p.stages * p.cap * p.slots * 8;
    st.rows = reinterpret_cast<int*>(base);
    base += 8 * (((long)p.stages * p.cap + 1) / 2);
  }
  if (p.z_smem) st.z = reinterpret_cast<double*>(base);
  __syncthreads();
  return st;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(smem)),
               "l"(__cvta_generic_to_global(gmem))
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(smem)),
               "l"(__cvta_generic_to_global(gmem))
               : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_inval(unsigned long long* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Arrives on `bar` once every cp.async this thread has issued so far has
// landed; the thread itself goes on.
__device__ __forceinline__ void mbar_arrive_on_copies(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Spins until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

constexpr int kIluRowChunk = 14;  // z loads in flight per row (28 registers of f64 pairs)

__device__ __forceinline__ double lds_f64(unsigned addr) {
  double v;
  asm volatile("ld.shared.f64 %0, [%1];\n" : "=d"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ int lds_s32(unsigned addr) {
  int v;
  asm volatile("ld.shared.s32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void sts_f64(unsigned addr, double v) {
  asm volatile("st.shared.f64 [%0], %1;\n" ::"r"(addr), "d"(v) : "memory");
}

// Where a sweep keeps z. kShared: in shared memory, by its 32-bit address (so
// that the loads are shared-memory loads, not generic ones), nrows + 1
// doubles of which the last stays zero (the plain sweep's pad), mirrored to
// device memory as computed; else in device memory alone.
template <bool kShared>
struct IluZ {
  unsigned shared;
  double* global;
  int nrows;
  // z[col], col >= 0; zero past the last row
  __device__ __forceinline__ double load(int col) const {
    if (kShared) return lds_f64(shared + 8u * (unsigned)min(col, nrows));
    return col < nrows ? global[col] : 0.0;
  }
  __device__ __forceinline__ void store(int row, double v) const {
    if (kShared) sts_f64(shared + 8u * (unsigned)row, v);
    global[row] = v;
  }
};

// One row: acc = rhs - sum f * z[col] in stored offset order. dq(q) is the
// q-th offset's column delta, fq(q) its factor entry of the row. kNt > 0: the
// offsets' count, known when compiling, so that the loop is straight code
// with up to kIluRowChunk z loads in flight ahead of the chain of
// differences; kNt == 0: nt at run time, in predicated groups of eight.
template <int kNt, class Z, class DeltaAt, class FactorAt>
__device__ __forceinline__ double ilu_row(double acc, int row, int nt, const Z& z, DeltaAt dq,
                                          FactorAt fq) {
  constexpr int kChunk = kNt == 0 ? 8 : (kNt <= 16 ? kNt : kIluRowChunk);
  const int count = kNt == 0 ? nt : kNt;
#pragma unroll
  for (int q0 = 0; q0 < count; q0 += kChunk) {
    double zc[kChunk], f[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      if (q0 + u < count) {
        zc[u] = z.load(max(row + dq(q0 + u), 0));
        f[u] = fq(q0 + u);
      }
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      if (q0 + u < count) acc = __dsub_rn(acc, __dmul_rn(f[u], zc[u]));
    }
  }
  return acc;
}

// What a sweep's loops share.
struct IluSweep {
  const double* P;        // the side's packed factor
  const double* rhs;
  const int* level_rows;
  const int* lp;          // level bounds
  const int* dq;          // shared memory: the side's column deltas
  unsigned z_shared;      // z's shared-memory address, or 0
  double* z_global;
  int nrows, nlev, nt, items;
  unsigned long long *full, *empty;
};

// Levels run upwards on the lower sweep, downwards on the upper one; walking
// them needs one bound a level.
template <bool kUpper>
struct LevelWalk {
  const int* lp;
  int lv, edge;  // the next level and its bound that the one before left
  __device__ LevelWalk(const int* lp_, int nlev) : lp(lp_), lv(kUpper ? nlev - 1 : 0), edge(lp_[kUpper ? nlev : 0]) {}
  // the next level's first position and row count
  __device__ __forceinline__ void next(int& beg, int& cnt) {
    const int other = lp[kUpper ? lv : lv + 1];
    beg = kUpper ? other : edge;
    cnt = kUpper ? edge - other : other - edge;
    edge = other;
    lv += kUpper ? -1 : 1;
  }
};

// The ring's next stage and the parity of its barrier's phase.
struct RingWalk {
  int slot = 0;
  unsigned parity = 0;
  __device__ __forceinline__ void advance(int stages) {
    if (++slot == stages) {
      slot = 0;
      parity ^= 1u;
    }
  }
};

// Cycles one thread spends in up to three phases, added to ilu_prof[base..]
// when it goes out of use. Compiled in only under PERPHIL_ILU_PROFILE
// (csrc/profile/ilu_apply_profile.cu); otherwise every call is empty.
#ifdef PERPHIL_ILU_PROFILE
// consumer thread 0: waiting for a full stage, a level's rows, the level's
// barrier; producer thread 0: waiting for an empty stage, issuing the copies
__device__ long long ilu_prof[5];
struct IluClock {
  long long t0, acc[3];
  bool on;
  __device__ explicit IluClock(bool on_) {
    on = on_;
    t0 = on_ ? clock64() : 0;
    acc[0] = acc[1] = acc[2] = 0;
  }
  __device__ __forceinline__ void mark(int i) {
    if (on) {
      const long long t = clock64();
      acc[i] += t - t0;
      t0 = t;
    }
  }
  __device__ void flush(int base, int count) {
    for (int i = 0; on && i < count; ++i) ilu_prof[base + i] += acc[i];
  }
};
#else
struct IluClock {
  __device__ explicit IluClock(bool) {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void flush(int, int) {}
};
#endif

// Producer warps: fill the ring, as far ahead as it is deep, each warp the
// levels that are its turn, so that `warps` levels are in flight at once. A
// stage holds the level's packed block [q * cnt + r] and, at items * cap, its
// rows' right-hand sides.
// `warps` must not exceed the ring's stages: a warp's step s waits for the
// consumer to have left level s - stages, told by the parity of empty[slot]
// alone, and a parity cannot tell a barrier that is on time from one two
// phases behind. The warp's step before, s - warps, has waited for level
// s - warps - stages; with warps <= stages that is level s - 2 stages or
// later, so the barrier is at most one phase behind and the wait holds. It
// also keeps two warps from arriving on one stage's `full` in one phase.
template <bool kUpper>
__device__ void ilu_produce(const IluSweep& w, const IluStage& st, int pt, int warps) {
  const int lane = pt & 31, turn = pt >> 5;
  IluClock clk(pt == 0);
  const size_t stage_doubles = (size_t)st.cap * st.slots;
  int slot = turn;
  unsigned parity = 0;
  for (int s = turn; s < w.nlev; s += warps) {
    while (slot >= st.stages) {
      slot -= st.stages;
      parity ^= 1u;
    }
    if (s >= st.stages) mbar_wait(&w.empty[slot], parity ^ 1u);
    clk.mark(0);
    const int lv = kUpper ? w.nlev - 1 - s : s;
    const int beg = w.lp[lv], cnt = w.lp[lv + 1] - beg;
    double* dst = st.data + slot * stage_doubles;
    int* rw = st.rows + slot * st.cap;
    const double* blk = w.P + (size_t)w.items * beg;
    for (int r = lane; r < cnt; r += 32) {
      cp_async4(rw + r, w.level_rows + beg + r);
      cp_async8(dst + w.items * st.cap + r, w.rhs + __ldg(w.level_rows + beg + r));
    }
    for (int i = lane; i < w.items * cnt; i += 32) cp_async8(dst + i, blk + i);
    mbar_arrive_on_copies(&w.full[slot]);
    slot += warps;
    clk.mark(1);
  }
  clk.flush(3, 2);
}

// Consumer warps (`threads` threads, whole warps): a level's rows, then the
// named barrier among themselves. kGS: divide by the diagonal on the forward
// walk (the Gauss-Seidel mode).
template <bool kUpper, int kNt, bool kZShared, bool kGS = false>
__device__ void ilu_consume(const IluSweep& w, const IluStage& st, int threads) {
  const IluZ<kZShared> z{w.z_shared, w.z_global, w.nrows};
  IluClock clk(threadIdx.x == 0);
  int dqr[kNt == 0 ? 1 : kNt];  // the column deltas, in registers
  if constexpr (kNt > 0) {
#pragma unroll
    for (int q = 0; q < kNt; ++q) dqr[q] = w.dq[q];
  }
  LevelWalk<kUpper> levels(w.lp, w.nlev);
  RingWalk ring;
  // the stage by its shared-memory addresses: through the generic pointers
  // the compiler, inside the fused GMRES kernel, made generic loads of them
  // and took the offsets one at a time
  const int cap = st.cap, nt = w.nt;
  const unsigned data0 = smem_addr(st.data), rows0 = smem_addr(st.rows);
  const unsigned stage_bytes = 8u * (unsigned)cap * (unsigned)st.slots;
  for (int s = 0; s < w.nlev; ++s) {
    int beg, cnt;
    levels.next(beg, cnt);
    const unsigned d = data0 + (unsigned)ring.slot * stage_bytes;
    const unsigned rw = rows0 + 4u * (unsigned)(ring.slot * cap);
    mbar_wait(&w.full[ring.slot], ring.parity);
    clk.mark(0);
    for (int r = threadIdx.x; r < cnt; r += threads) {
      const int row = lds_s32(rw + 4u * (unsigned)r);
      double acc = ilu_row<kNt>(
          lds_f64(d + 8u * (unsigned)(w.items * cap + r)), row, nt, z,
          [&](int q) { return kNt > 0 ? dqr[kNt > 0 ? q : 0] : w.dq[q]; },
          [&](int q) { return lds_f64(d + 8u * (unsigned)(q * cnt + r)); });
      if (kUpper || kGS) acc = __ddiv_rn(acc, lds_f64(d + 8u * (unsigned)(nt * cnt + r)));
      z.store(row, acc);
    }
    clk.mark(1);
    named_barrier(kIluConsumerBarrier, threads);  // z written, the stage read
    if (threadIdx.x == 0) mbar_arrive(&w.empty[ring.slot]);
    ring.advance(st.stages);
    clk.mark(2);
  }
  clk.flush(0, 3);
}

// One sweep: zg = L^{-1} rhs (kUpper false, unit lower) or U^{-1} rhs (kUpper
// true), rhs and zg in device memory, P the side's packed factor. `m` should
// live in shared memory (it is indexed at run time). Call with all threads
// of a block of at least kIluProducerWarps + 1 warps. Begins and ends with a
// barrier, so rhs written before the call and zg read after it are safe.
// kNt >= 0: the side's offset count as the caller knows it when compiling
// (0: any, at run time); -1: chosen here from the table.
// kGS (with kUpper false): one forward Gauss-Seidel sweep of the matrix P
// holds packed by level, zg = the iterate after it. z starts at z0; a row
// takes rhs less every off-centre entry (all offsets but m.center, in stored
// order) times z read in place, divided by the diagonal (P's last item).
// Lower neighbours lie on earlier levels and hold the new iterate, upper
// neighbours on later ones and still hold z0.
template <bool kUpper, int kNt, bool kGS = false>
__device__ void ilu_sweep(const double* P, int nrows, const IluMeta& m, const IluStage& st,
                          const int* level_rows, int nlev, const double* rhs, double* zg,
                          const double* z0 = nullptr) {
  static_assert(!(kGS && kUpper), "the Gauss-Seidel mode walks the levels forward");
  __shared__ unsigned long long full[kIluMaxStages], empty[kIluMaxStages];
  __shared__ int dq[kGS ? kMaxOffsets : kMaxSideOffsets];  // per offset of this side, its column delta
  const int nt = kGS ? m.nlow + m.nup : (kUpper ? m.nup : m.nlow);
  const int* offs = kUpper ? m.up : m.low;
  const int producers = kIluProducerWarps * 32;
  const int first_producer = (int)blockDim.x - producers;
  const IluSweep w{P, rhs, level_rows, st.lp, dq, st.z != nullptr ? smem_addr(st.z) : 0u, zg,
                   nrows, nlev, nt, nt + (kUpper || kGS ? 1 : 0), full, empty};

  if (st.z != nullptr) {
    for (int e = threadIdx.x; e <= nrows; e += blockDim.x) st.z[e] = kGS && e < nrows ? z0[e] : 0.0;
  }
  if (st.z == nullptr || kGS) {
    for (int e = threadIdx.x; e < nrows; e += blockDim.x) zg[e] = kGS ? z0[e] : 0.0;
  }
  if (threadIdx.x < nt) {
    const int q = threadIdx.x;
    dq[q] = m.delta[kGS ? q + (q >= m.center ? 1 : 0) : offs[q]];
  }
  if (threadIdx.x == 0 && st.data != nullptr) {
    for (int i = 0; i < st.stages; ++i) {
      mbar_init(&full[i], 32);  // the lanes of the producer warp whose turn the level is
      mbar_init(&empty[i], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (st.data == nullptr) {
    // the direct loop: every load of a level after its barrier, z in device
    // memory (ilu_plan gives it no shared copy)
    LevelWalk<kUpper> levels(w.lp, nlev);
    const IluZ<false> z{0u, zg, nrows};
    for (int s = 0; s < nlev; ++s) {
      int beg, cnt;
      levels.next(beg, cnt);
      const double* blk = P + (size_t)w.items * beg;
      for (int r = threadIdx.x; r < cnt; r += blockDim.x) {
        const int row = level_rows[beg + r];
        double acc = ilu_row<0>(rhs[row], row, nt, z, [&](int q) { return dq[q]; },
                                [&](int q) { return blk[q * cnt + r]; });
        if (kUpper || kGS) acc = __ddiv_rn(acc, blk[nt * cnt + r]);
        z.store(row, acc);
      }
      __syncthreads();
    }
    return;
  }

  if ((int)threadIdx.x >= first_producer) {
    // never more producer warps than stages (see ilu_produce); the rest idle
    const int warps = st.stages < kIluProducerWarps ? st.stages : kIluProducerWarps;
    const int pt = (int)threadIdx.x - first_producer;
    if (pt < warps * 32) ilu_produce<kUpper>(w, st, pt, warps);
  } else {
    // as many consumer warps as the widest level needs
    const int avail = first_producer / 32;
    const int warps = (st.cap + 31) / 32 < avail ? (st.cap + 31) / 32 : avail;
    if ((int)threadIdx.x < warps * 32) {
      // straight code for the offsets a side has on quad/hex meshes: 2D
      // fields (4), 2D monolithic and 3D fields (13)
      const int threads = warps * 32;
      auto consume = [&](auto shared) {
        constexpr bool kZShared = decltype(shared)::value;
        if constexpr (kNt >= 0) {
          ilu_consume<kUpper, kNt, kZShared, kGS>(w, st, threads);
        } else {
          switch (nt) {
            case 4: ilu_consume<kUpper, 4, kZShared, kGS>(w, st, threads); break;
            case 13: ilu_consume<kUpper, 13, kZShared, kGS>(w, st, threads); break;
            default: ilu_consume<kUpper, 0, kZShared, kGS>(w, st, threads); break;
          }
        }
      };
      if (st.z != nullptr) {
        consume(std::true_type{});
      } else {
        consume(std::false_type{});
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < st.stages; ++i) {
      mbar_inval(&full[i]);
      mbar_inval(&empty[i]);
    }
  }
}

// z = U^{-1} L^{-1} r, with y (nrows, device memory) as scratch; PL, PU: the
// factor's packed lower and upper sides, on the ring or the direct loop.
// kNt: as for ilu_sweep (both sides have as many offsets on the package's
// meshes).
template <int kNt = -1>
__device__ __forceinline__ void ilu_apply(const double* PL, const double* PU, int nrows,
                                          const IluMeta& m, const IluStage& st,
                                          const int* level_rows, int nlev, const double* r,
                                          double* y, double* z) {
  ilu_sweep<false, kNt>(PL, nrows, m, st, level_rows, nlev, r, y);
  ilu_sweep<true, kNt>(PU, nrows, m, st, level_rows, nlev, y, z);
}

}  // namespace perphil
