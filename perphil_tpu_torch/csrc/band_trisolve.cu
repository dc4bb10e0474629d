// band_trisolve: the ordering-parity ILU apply (pc_factor_mat_ordering_type
// =rcm) as a level-scheduled forward and backward sweep over the combined
// two-field ILU(0) factor, one launch an apply (ops/bandsolve.py,
// level_apply).
//
// Replaces no Pallas kernel: in the JAX package this apply is XLA
// (perphil_tpu/ops/bandsolve.py:164, tri_apply, a lax.scan of dense f32
// band blocks and their inverses, four of them an apply, with the L21/U12
// couplings as stencils between). Here it is the host engine's ilu_apply
// (csrc/csr_solver.cpp:54) on the sparse factor, bit for bit:
//   forward:  s = r[i]; s -= F[i,k] * y[k] over the row's strictly lower
//             entries in CSR order; y[i] = s
//   backward: s = y[i]; s -= F[i,k] * x[k] over its strictly upper entries;
//             x[i] = s / F[i,i]
// each product, difference and quotient rounded on its own (__dmul_rn,
// __dsub_rn, __ddiv_rn: nvcc would contract them into FMAs). The rows of a
// level read only rows of earlier levels (the host's schedule,
// ops/bandsolve.py::level_schedule), so the order within a level is free and
// no row's arithmetic changes. x overwrites y in place: a backward row reads
// its own y and the x of rows of earlier backward levels, all written
// before it. The permutation is folded in: the vector takes r[perm[i]]
// before the first level, z[perm[i]] takes the vector after the last.
//
// Bound on the H100: latency. At tet nx=40 the factor is 3,975,844 entries
// (47.7 MB with their columns, 0.015 ms at 3.35 TB/s), but the two sweeps
// are 407 + 407 dependent levels of at most 720 rows, and a row's chain of
// up to 24 dependent subtractions (and a division) cannot be reordered
// without changing its bits. What the design does about it:
//   - One block or one cluster. The host's plan (ops/bandsolve.py, the rule
//     measured in tools/profile_kernels.py --only band; PERF.md) runs one
//     block with the whole vector in its shared memory, levels separated by
//     __syncthreads, where the vector fits (tet nx <= 16); else a cluster of
//     16 blocks with the vector spread over their shared memory (row i in
//     block i mod 16, read from the others through distributed shared
//     memory), where each block's share and the ring fit; else the cluster
//     with the vector in device memory, read and written through L2.
//   - A cluster's level barrier is an mbarrier exchange: each block arrives
//     on every block's level mbarrier (release at cluster scope) and waits
//     on its own (acquire): 0.60 us an empty level on 16 blocks, the same
//     apply as the hardware cluster barrier (PERF.md).
//   - Each row is a lane: block b takes the rows i = b mod nb of a level,
//     sorted by length and cut into slices of 32 (a warp's, so a warp's rows
//     are of similar length); its slices of a level (a segment) are stored
//     contiguously, entry-major, so a warp reads its entries coalesced. A
//     lane issues all its gathers of the vector before its chain.
//   - The entries do not depend on the recurrence: the last warp streams the
//     block's segments into a ring of shared-memory stages, one bulk copy
//     (cp.async.bulk, completing on the stage's mbarrier) a level, up to
//     three levels ahead, so a level waits on its barrier and its gathers,
//     not on device memory; the other warps take the rows.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace perphil {

namespace cg = cooperative_groups;

constexpr int kLevelThreads = 256;
constexpr int kLevelWarps = kLevelThreads / 32;
// The most entries a row may have in one sweep (tet rows have up to 22
// lower and 24 upper ones, hex rows 40); the host refuses a wider factor.
constexpr int kLevelMaxWidth = 40;
constexpr int kLevelMaxStages = 4;
constexpr int kLevelMaxCluster = 16;
// The dynamic shared memory a launch may take (the card's 227 KB a block);
// the host's plan (ops/bandsolve.py, which reads these lines) mirrors the
// launcher's.
constexpr int kLevelSmemBudget = 232448;
// The cluster the plan takes when the vector does not fit one block's
// shared memory: the most blocks, measured fastest at tet nx=16-40
// (tools/profile_kernels.py --only band; PERF.md).
constexpr int kLevelRuleBlocks = 16;
// A lane's rows word: its row in the low kLevelRowBits bits, its entry
// count in the sweep above them (-1: a padding lane).
constexpr int kLevelRowBits = 25;
// Bytes before the descriptors: the ring's mbarriers and the two level
// mbarriers of a cluster.
constexpr int kLevelHeader = 64;
// The last warp streams the block's segments into the ring (its lane 0);
// the others take the rows.
constexpr int kLevelConsumerWarps = kLevelWarps - 1;

// Phase clocks, for tools/profile_kernels.py --only band alone: a build
// with PERPHIL_LEVEL_PROFILE adds thread 0 of block 0's cycles in each
// phase of a level to level_prof (the package's library holds no counter):
// the wait on the stage's mbarrier, its own rows (the gathers, the chain,
// the store), and the level barrier. The producer's copies are off this
// thread's path.
enum LevelPhase { kLevelWait, kLevelRow, kLevelBarrier, kLevelPhases };
#ifdef PERPHIL_LEVEL_PROFILE
__device__ unsigned long long level_prof[kLevelPhases];
#endif

__host__ __device__ inline long level_align128(long bytes) { return (bytes + 127) / 128 * 128; }

// The ring's mbarriers, the block's descriptors, the ring, and, where the
// vector lives in shared memory, the block's share of it: rows i with
// i mod blocks == rank, ceil(n / blocks) doubles.
__host__ __device__ inline long level_smem_bytes(int n, int levels, int stages, int stage_bytes,
                                                 int shared_vector, int blocks) {
  return level_align128(kLevelHeader + 16L * levels) + (long)stages * stage_bytes +
         (shared_vector ? 8L * ((n + blocks - 1) / blocks) : 0L);
}

// Where the vector lives: in device memory (read and written through L2),
// in one block's shared memory, or spread over the cluster's shared memory.
enum LevelVectorPlace { kLevelGlobal, kLevelOneBlock, kLevelDistributed };

__device__ __forceinline__ uint32_t lvl_smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void lvl_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" : : "r"(lvl_smem(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void lvl_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
               :
               : "r"(lvl_smem(dst)), "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(lvl_smem(bar))
               : "memory");
}

__device__ __forceinline__ void lvl_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(lvl_smem(bar)), "r"(parity)
        : "memory");
  }
}

// The vector. kLevelGlobal: in device memory through L2 (another SM wrote it
// since the last barrier); kLevelOneBlock: in shared memory; and
// kLevelDistributed: row i in block i mod nb's shared memory at i / nb (nb a
// power of two, 1 << shift), read from another block's by distributed
// shared memory. A block stores only rows it owns (the host deals row i to
// block i mod nb).
template <int kPlace>
struct LevelVector {
  double* v;
  int shift;
  __device__ __forceinline__ double load(const cg::cluster_group& cluster, int i) const {
    if constexpr (kPlace == kLevelGlobal) {
      return __ldcg(v + i);
    } else if constexpr (kPlace == kLevelOneBlock) {
      return v[i];
    } else {
      return *cluster.map_shared_rank(v + (i >> shift), (unsigned)(i & ((1 << shift) - 1)));
    }
  }
  __device__ __forceinline__ void store(int i, double x) const {
    if constexpr (kPlace == kLevelGlobal) {
      __stcg(v + i, x);
    } else {
      v[i >> shift] = x;
    }
  }
};

// The level barrier of a cluster: every block, once its rows of level l are
// stored (a block barrier), arrives on each block's level mbarrier (parity
// l & 1, nblocks arrivals a phase) with release at cluster scope, one thread
// a block; then every thread waits on its own with acquire at cluster scope.
// A block passes level l + 1's wait only after every block arrived for it,
// which each does after its own wait of level l: no arrival of level l + 2
// reaches a barrier before its phase of level l completed.
__device__ __forceinline__ void cluster_level_barrier(uint64_t* lbar, int l, int nblocks) {
  __syncthreads();
  uint64_t* bar = lbar + (l & 1);
  if ((int)threadIdx.x < nblocks) {
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(lvl_smem(bar)), "r"((int)threadIdx.x));
    asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" : : "r"(remote) : "memory");
  }
  const uint32_t parity = (uint32_t)((l >> 1) & 1);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(lvl_smem(bar)), "r"(parity)
        : "memory");
  }
}

// A build with PERPHIL_LEVEL_CLUSTER_SYNC takes the hardware cluster barrier
// instead (barrier.cluster.arrive.release / wait.acquire), for
// tools/profile_kernels.py --only band alone.
template <int kPlace>
__device__ __forceinline__ void level_barrier(cg::cluster_group& cluster, uint64_t* lbar, int l, int nblocks) {
  if constexpr (kPlace == kLevelOneBlock) {
    __syncthreads();
  } else {
#ifdef PERPHIL_LEVEL_CLUSTER_SYNC
    cluster.sync();
#else
    cluster_level_barrier(lbar, l, nblocks);
#endif
  }
}

// A segment (one block's slices of one level) in device memory and in its
// ring stage: vals (slots f64), diag (lanes f64), cols (slots int32), rows
// (lanes int32), slots = 32 m w, lanes = 32 m; entry k of lane t of slice j
// at 32 (j w + k) + t. A descriptor: [offset / 16 B, m, w, 0].
template <int kPlace>
__global__ void __launch_bounds__(kLevelThreads, 1)
level_trisolve_kernel(const double* __restrict__ r, double* __restrict__ z, double* gvec,
                      const unsigned char* __restrict__ blob, const int4* __restrict__ desc,
                      const int* __restrict__ perm, int n, int nlev_l, int nlev_u, int stages, int stage_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nblocks = kPlace == kLevelOneBlock ? 1 : (int)cluster.num_blocks();
  const int rank = kPlace == kLevelOneBlock ? 0 : (int)cluster.block_rank();
  const int shift = 31 - __clz(nblocks);
  const int nlev = nlev_l + nlev_u;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // the ring's, then the two level mbarriers
  uint64_t* lbar = bars + kLevelMaxStages;
  int4* sdesc = reinterpret_cast<int4*>(smem + kLevelHeader);
  unsigned char* ring = smem + level_align128(kLevelHeader + 16L * nlev);
  double* svec = reinterpret_cast<double*>(ring + (long)stages * stage_bytes);
  const LevelVector<kPlace> vec{kPlace == kLevelGlobal ? gvec : svec, shift};

  for (int l = tid; l < nlev; l += kLevelThreads) sdesc[l] = desc[(long)l * nblocks + rank];
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" : : "r"(lvl_smem(bars + s)) : "memory");
    }
    for (int p = 0; p < 2; ++p) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" : : "r"(lvl_smem(lbar + p)), "r"(nblocks) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" : : : "memory");
  }
  __syncthreads();

  // the producer: level l's segment into stage s, one bulk copy
  const bool producer = tid == kLevelConsumerWarps * 32;
  auto issue = [&](int l, int s) {
    const int4 d = sdesc[l];
    const uint32_t bytes = 384u * (uint32_t)d.y * (uint32_t)(d.z + 1);  // 32 m (12 w + 12)
    lvl_expect(bars + s, bytes);  // an empty segment's phase completes on the arrival alone
    if (bytes) lvl_copy(ring + (long)s * stage_bytes, blob + 16L * d.x, bytes, bars + s);
  };
  if (producer) {
    for (int l = 0; l < stages - 1 && l < nlev; ++l) issue(l, l);
  }
  // r through the permutation: the rows this block holds
  if constexpr (kPlace == kLevelGlobal) {
    for (int i = rank * kLevelThreads + tid; i < n; i += nblocks * kLevelThreads) vec.store(i, __ldg(r + __ldg(perm + i)));
  } else {
    for (int i = (tid << shift) + rank; i < n; i += kLevelThreads << shift) vec.store(i, __ldg(r + __ldg(perm + i)));
  }
  // the vector and every block's mbarriers in place before any remote access
  if constexpr (kPlace == kLevelOneBlock) {
    __syncthreads();
  } else {
    cluster.sync();
  }
#ifdef PERPHIL_LEVEL_PROFILE
  const bool clocked = rank == 0 && tid == 0;
  long long t0 = clock64(), clk[kLevelPhases] = {};
  auto mark = [&](int phase) {
    if (clocked) {
      const long long now = clock64();
      clk[phase] += now - t0;
      t0 = now;
    }
  };
#else
  auto mark = [](int) {};
#endif

  int s = 0;            // level l's stage
  uint32_t parity = 0;  // and the phase of its mbarrier
  for (int l = 0; l < nlev; ++l) {
    if (producer && l + stages - 1 < nlev) issue(l + stages - 1, s == 0 ? stages - 1 : s - 1);
    if (warp < kLevelConsumerWarps) {
      const int4 d = sdesc[l];
      const int m = d.y, w = d.z;
      if (m > 0) {  // an empty segment's stage is not read: no wait
        lvl_wait(bars + s, parity);
        mark(kLevelWait);
        const int slots = 32 * m * w, lanes = 32 * m;
        const double* sv = reinterpret_cast<const double*>(ring + (long)s * stage_bytes);
        const double* sd = sv + slots;
        const int* sc = reinterpret_cast<const int*>(sd + lanes);
        const int* sr = sc + slots;
        const bool upper = l >= nlev_l;
        for (int j = warp; j < m; j += kLevelConsumerWarps) {
          const int word = sr[32 * j + lane];
          if (word < 0) continue;
          // the row's own entries; the segment's padding beyond them (0.0
          // times the zero slot in the twin) would leave acc as it is
          const int row = word & ((1 << kLevelRowBits) - 1), len = word >> kLevelRowBits;
          const int base = 32 * j * w + lane;
          double v[kLevelMaxWidth];
#pragma unroll
          for (int k = 0; k < kLevelMaxWidth; ++k) {
            if (k < len) v[k] = vec.load(cluster, sc[base + 32 * k]);
          }
          double acc = vec.load(cluster, row);
#pragma unroll
          for (int k = 0; k < kLevelMaxWidth; ++k) {
            if (k < len) acc = __dsub_rn(acc, __dmul_rn(sv[base + 32 * k], v[k]));
          }
          if (upper) acc = __ddiv_rn(acc, sd[32 * j + lane]);
          vec.store(row, acc);
        }
        mark(kLevelRow);
      }
    }
    level_barrier<kPlace>(cluster, lbar, l, nblocks);
    mark(kLevelBarrier);
    if (++s == stages) {
      s = 0;
      parity ^= 1u;
    }
  }
  if constexpr (kPlace == kLevelGlobal) {
    for (int i = rank * kLevelThreads + tid; i < n; i += nblocks * kLevelThreads) z[__ldg(perm + i)] = vec.load(cluster, i);
  } else {
    for (int i = (tid << shift) + rank; i < n; i += kLevelThreads << shift) z[__ldg(perm + i)] = svec[i >> shift];
  }
  if constexpr (kPlace != kLevelOneBlock) cluster.sync();  // no block leaves while another may reach its shared memory
#ifdef PERPHIL_LEVEL_PROFILE
  if (clocked) {
    for (int k = 0; k < kLevelPhases; ++k) atomicAdd(level_prof + k, (unsigned long long)clk[k]);
  }
#endif
}

}  // namespace perphil

// r, z: (n,) f64 in the natural order (z out); vec: (n,) f64 scratch in
// device memory (the vector where it does not live in shared memory); blob:
// the level-ordered segments (ops/bandsolve.py::level_schedule): per
// segment its entries' values (f64), the lanes' diagonals (f64), the
// entries' columns (int32) and the lanes' rows words (row and entry count,
// kLevelRowBits; -1 for padding); desc: (levels, blocks) int4 [offset / 16,
// slices, width, 0] (the forward sweep's nlev_l levels, then the backward
// sweep's nlev_u); perm: (n,) int32, the natural index of each permuted row.
// blocks: 1, 2, 4, 8 or 16 (a cluster beyond 1); shared_vector: the vector in
// shared memory (one block's, or spread over the cluster's) or in device
// memory; stages: the ring's depth (2-4); stage_bytes: the largest segment,
// a multiple of 128.
extern "C" int perphil_band_trisolve(const double* r, double* z, double* vec, const unsigned char* blob,
                                     const int* desc, const int* perm, int n, int nlev_l, int nlev_u, int blocks,
                                     int shared_vector, int stages, int stage_bytes, void* stream) {
  using namespace perphil;
  if (n < 1 || nlev_l < 0 || nlev_u < 0 || blocks < 1 || blocks > kLevelMaxCluster || (blocks & (blocks - 1)) ||
      stages < 2 || stages > kLevelMaxStages || stage_bytes < 128 || stage_bytes % 128 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long bytes = level_smem_bytes(n, nlev_l + nlev_u, stages, stage_bytes, shared_vector, blocks);
  if (bytes > kLevelSmemBudget) return (int)cudaErrorInvalidValue;
  using Kernel = void (*)(const double*, double*, double*, const unsigned char*, const int4*, const int*, int, int,
                          int, int, int);
  const int place = !shared_vector ? kLevelGlobal : blocks == 1 ? kLevelOneBlock : kLevelDistributed;
  const Kernel kernel = place == kLevelGlobal    ? level_trisolve_kernel<kLevelGlobal>
                        : place == kLevelOneBlock ? level_trisolve_kernel<kLevelOneBlock>
                                                  : level_trisolve_kernel<kLevelDistributed>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kLevelThreads);
  cfg.dynamicSmemBytes = (size_t)bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  if (place != kLevelOneBlock) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    // a card that cannot place the cluster refuses the launch
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, r, z, vec, blob, reinterpret_cast<const int4*>(desc), perm, n, nlev_l,
                           nlev_u, stages, stage_bytes);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

#ifdef PERPHIL_LEVEL_PROFILE
// Copies the phase counters (LevelPhase, cycles summed over the launches
// since the last take) to `out` on the host, then zeroes them.
extern "C" int perphil_band_trisolve_profile_take(unsigned long long* out) {
  const unsigned long long zero[perphil::kLevelPhases] = {};
  cudaError_t err = cudaMemcpyFromSymbol(out, perphil::level_prof, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(perphil::level_prof, zero, sizeof(zero));
  return (int)err;
}
#endif
