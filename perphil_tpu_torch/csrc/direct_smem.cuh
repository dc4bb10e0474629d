// What K2 (fused_direct.cu) and K3 (fused_pcg.cu) share: the plan that
// places a small-mesh direct solve in one thread block's shared memory, and
// the device code both run there (the owners' ownership, the boundary walk,
// the block reductions, the interior stencil and the fast-diag transform
// passes, templated on the element type: f64 for K3, f32 for K2).
//
// The plan. A solve runs in one block whose dynamic shared memory holds the
// working set that threads read across each other: the vector the stencil
// reads (node layout, zero on the boundary, so the stencil needs no bounds
// test), the interior transform buffers and the staged per-axis eigenbases
// (each distinct matrix once) and mode data. A thread owns interior nodes
// q = t + k * threads (k < per) of both fields and keeps what only it reads
// (K3: x and r; K2: b and r) in registers. The boundary rows of both systems
// are identity rows that no interior row reads, so they are handled by
// walking the boundary once at entry and once at exit, never in the loop.
// Placements: threads the smallest of 64, 128, 256, 512 that gives each
// output of a transform pass (2 nint) its own thread, else 512; per the
// smallest power of two with threads * per >= nint, up to kDirectMaxPer.
// On the 64-thread placement (nint <= 32) K3 applies its preconditioner as
// one dense nint x nint matrix a field (the fast-diag product, built on the
// host), in one phase instead of 2 d passes. A mesh one block does not hold
// runs on a thread block cluster of nb = 2..16 blocks of 512 threads (the
// fewest that hold it): the vectors are spread over the blocks' shared
// memory (Spread: block e / chunk holds element e), the eigenbases and mode
// data stay in device memory, a thread of the cluster owns per interior
// nodes, and every phase ends at the cluster's barrier. The planner in
// ops/fused_direct.py reads the constants below (kDirectSmemBudget,
// kDirectMaxThreads, kDirectMaxPer, kDenseThreads, kDirectMaxCluster) and
// the byte counts of direct_smem_bytes and direct_cluster_bytes, so a mesh
// the gate admits is one the launcher places; a launcher refuses
// (cudaErrorInvalidValue) a mesh its plan does not place.
#pragma once

#include <cooperative_groups.h>

#include "dpp_stencil.cuh"

namespace perphil {

// The dynamic shared memory a launch may plan with: the block's 227 KB
// (232,448 B) less 1,024 B for the kernels' static shared memory (the
// reductions' partials, at most 512 B; tests/test_torch_kernels.py checks
// each kernel's on the card).
constexpr int kDirectSmemBudget = 231424;
constexpr int kDirectMaxThreads = 512;
constexpr int kDirectMaxPer = 8;

enum DirectKind { kDirectK2 = 0, kDirectK3 = 1 };

constexpr int kDenseThreads = 64;  // K3's dense placement

// Host: shared memory of a solve on n nodes (nint interior nodes a field)
// with mat_elems entries in its distinct eigenbases, on `threads` threads.
//   K3 (f64): p (2n, node layout), r, two transform buffers, mode scales
//             (2 nint each), eigenbases: 16 n + 64 nint + 8 mat_elems; on
//             the dense placement p, r, z (2 nint each) and the two dense
//             matrices: 16 n + 32 nint + 16 nint^2;
//   K2:       x (2n f64, node layout), two f32 transform buffers (2 nint
//             each), a11, a22, det (nint f32 each), f32 eigenbases:
//             16 n + 28 nint + 4 mat_elems.
inline long direct_smem_bytes(int kind, long n, long nint, long mat_elems, int threads) {
  if (kind == kDirectK2) return 16 * n + 28 * nint + 4 * mat_elems;
  return threads == kDenseThreads ? 16 * n + 32 * nint + 16 * nint * nint : 16 * n + 64 * nint + 8 * mat_elems;
}

constexpr int kDirectMaxCluster = 16;

// Host: shared memory of each of nb blocks of a cluster: K3 p (2n f64) and
// r and two transform buffers (2 nint f64 each), K2 x (2n f64) and two f32
// transform buffers (2 nint each), each spread in chunks of ceil(/ nb).
inline long direct_cluster_bytes(int kind, long n, long nint, int nb) {
  const long pc = (2 * n + nb - 1) / nb, ic = (2 * nint + nb - 1) / nb;
  return kind == kDirectK3 ? 8 * pc + 24 * ic : 8 * pc + 8 * ic;
}

struct DirectPlan {
  int threads, per, bytes, blocks;
};

// Host: the launcher's plan for a grid of nz x ny x nx nodes (nz == 1 in
// 2D) whose eigenbases hold mat_elems entries; false where it places none.
inline bool direct_plan(int kind, int nz, int ny, int nx, int dim, long mat_elems, DirectPlan& out) {
  if ((dim != 2 && dim != 3) || nx < 3 || ny < 3 || (dim == 3 ? nz < 3 : nz != 1)) return false;
  const long n = (long)nz * ny * nx;
  const long nint = (long)(nx - 2) * (ny - 2) * (dim == 3 ? nz - 2 : 1);
  int threads = 64, per = 1;
  while (threads < kDirectMaxThreads && threads < 2 * nint) threads *= 2;
  while (per < kDirectMaxPer && (long)threads * per < nint) per *= 2;
  const long bytes = direct_smem_bytes(kind, n, nint, mat_elems, threads);
  if ((long)threads * per >= nint && bytes <= kDirectSmemBudget) {
    out = DirectPlan{threads, per, (int)bytes, 1};
    return true;
  }
  for (int nb = 2; nb <= kDirectMaxCluster; nb *= 2) {  // a cluster of 512-thread blocks
    per = 1;
    while (per < kDirectMaxPer && (long)kDirectMaxThreads * nb * per < nint) per *= 2;
    const long cbytes = direct_cluster_bytes(kind, n, nint, nb);
    if ((long)kDirectMaxThreads * nb * per >= nint && cbytes <= kDirectSmemBudget) {
      out = DirectPlan{kDirectMaxThreads, per, (int)cbytes, nb};
      return true;
    }
  }
  return false;
}


// Division of a value below 2^31 by a divisor fixed for the launch, as a
// multiply-high, an add and a shift (Granlund and Montgomery's round-up
// method): a 32-bit division is a sequence of some twenty instructions, on
// the critical path of every transform pass.
struct FastDiv {
  unsigned d, m;
  int l;
};

inline FastDiv make_fastdiv(unsigned d) {  // host; d >= 1
  int l = 0;
  while ((1u << l) < d) ++l;
  const unsigned long long m = ((1ull << 32) * ((1ull << l) - d)) / d + 1;
  return FastDiv{d, (unsigned)m, l};
}

__device__ __forceinline__ int fdiv(int t, const FastDiv& f) {
  return (int)((__umulhi((unsigned)t, f.m) + (unsigned)t) >> f.l);
}

// The chunks of a plan's spread buffers: node vectors (2n values) and
// interior vectors (2 nint); on one block, the whole buffer.
struct TeamGeom {
  int nb;
  FastDiv pchunk, ichunk;
};

inline TeamGeom team_geom(const DirectPlan& plan, int n, int nint) {  // host
  const int nb = plan.blocks;
  return TeamGeom{nb, make_fastdiv((2 * n + nb - 1) / nb), make_fastdiv((2 * nint + nb - 1) / nb)};
}

// The interior grid (nodes minus the boundary layer; iz == 1 in 2D) and the
// divisions its indexing takes: by ix, iy, iz and ix * iy, the axes'
// lengths and strides.
struct Interior {
  int ix, iy, iz, nint;
  FastDiv len[3], stride[3];
};

inline Interior interior_of(const Grid& g, int dim) {  // host
  const int ix = g.nx - 2, iy = g.ny - 2, iz = dim == 3 ? g.nz - 2 : 1;
  return Interior{ix, iy, iz, ix * iy * iz, {make_fastdiv(ix), make_fastdiv(iy), make_fastdiv(iz)},
                  {make_fastdiv(1), make_fastdiv(ix), make_fastdiv(ix * iy)}};
}

// Interior index q -> node index, in 32-bit arithmetic (every grid here has
// far fewer than 2^31 nodes; a 64-bit division is a long software sequence).
template <int D>
__device__ __forceinline__ int interior_node(const Grid& g, const Interior& in, int q) {
  const int t = fdiv(q, in.len[0]), c = q - t * in.ix;
  const int a = D == 3 ? fdiv(t, in.len[1]) : 0, b = t - a * in.iy;
  return ((a + (D == 3 ? 1 : 0)) * g.ny + b + 1) * g.nx + c + 1;
}

// Boundary node number t (t < nodes - nint) -> node index: in 3D the first
// and last planes, then per inner plane its first and last rows and the two
// ends of its inner rows; in 2D the last two alone.
template <int D>
__device__ __forceinline__ int boundary_node(const Grid& g, int t) {
  int plane = 0;
  if (D == 3) {
    const int face = g.ny * g.nx;
    if (t < 2 * face) return t < face ? t : (g.nz - 1) * face + t - face;
    t -= 2 * face;
    const int ring = 2 * g.nx + 2 * (g.ny - 2);
    plane = 1 + t / ring;
    t %= ring;
  }
  const int base = plane * g.ny * g.nx;
  if (t < 2 * g.nx) return base + (t < g.nx ? t : (g.ny - 1) * g.nx + t - g.nx);
  t -= 2 * g.nx;
  return base + (1 + (t >> 1)) * g.nx + ((t & 1) ? g.nx - 1 : 0);
}

// Phase clocks, for tools/profile_kernels.py --only direct alone: a build
// with PERPHIL_DIRECT_PROFILE defined gets kernels whose thread 0 adds the
// cycles between marks to the phase's counter (DirectProf), which the
// unit's perphil_*_profile_take reads; the package's library has none.
#ifdef PERPHIL_DIRECT_PROFILE
constexpr int kProfSlots = 16;
struct DirectProf {
  long long t0, acc[kProfSlots];
  __device__ __forceinline__ void start() {
    if (threadIdx.x == 0) {
      for (int i = 0; i < kProfSlots; ++i) acc[i] = 0;
      t0 = clock64();
    }
  }
  __device__ __forceinline__ void mark(int phase) {
    if (threadIdx.x == 0) {
      const long long now = clock64();
      acc[phase] += now - t0;
      t0 = now;
    }
  }
  __device__ __forceinline__ void flush(unsigned long long* out) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < kProfSlots; ++i) atomicAdd(out + i, (unsigned long long)acc[i]);
    }
  }
};
#define PERPHIL_DIRECT_PROF(expr) expr
#else
#define PERPHIL_DIRECT_PROF(expr) \
  do {                            \
  } while (0)
#endif

// Copy count elements to shared memory with cp.async (4 or 8 bytes each);
// stage_wait() completes this thread's copies, a barrier then shows them to
// the block.
template <typename T>
__device__ __forceinline__ void stage_async(T* dst, const T* src, int count) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "cp.async takes 4 or 8 bytes here");
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst + e);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src + e), "n"(sizeof(T)));
  }
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The eigenbases of the D axes, each distinct pointer staged once from dst
// on; S[a] points at axis a's shared copy. Returns the end of the copies.
template <typename T, int D>
__device__ __forceinline__ T* stage_mats(T* dst, const T* Sx, const T* Sy, const T* Sz, const Interior& in,
                                         const T* S[3]) {
  const T* src[3] = {Sx, Sy, Sz};
  const int na[3] = {in.ix, in.iy, in.iz};
#pragma unroll
  for (int a = 0; a < D; ++a) {
    int same = -1;
#pragma unroll
    for (int a2 = 0; a2 < a; ++a2) {
      if (same < 0 && src[a2] == src[a]) same = a2;
    }
    if (same >= 0) {
      S[a] = S[same];
    } else {
      stage_async(dst, src[a], na[a] * na[a]);
      S[a] = dst;
      dst += na[a] * na[a];
    }
  }
  return dst;
}

// This warp's part of a block reduction: the warp's sum (or max) of v goes
// to row[warp]; after the next barrier, row_total reads the block's, the
// same bits in every thread (a fixed order).
__device__ __forceinline__ void warp_partial(double v, double* row, bool is_max) {
  v = warp_reduce(v, is_max);
  if ((threadIdx.x & 31) == 0) row[threadIdx.x >> 5] = v;
}

template <int kWarps>
__device__ __forceinline__ double row_total(const double* row, bool is_max) {
  double v = row[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) v = is_max ? fmax(v, row[w]) : v + row[w];
  return v;
}

// The threads of one solve: one block (kCluster false) or a thread block
// cluster of nb blocks (the whole grid), kThreads threads each. In a
// cluster the working set is spread over the blocks' shared memory
// (Spread) and every phase ends at the cluster's barrier.
template <int kThreads, bool kCluster>
struct Team {
  int rank, nb;
  __device__ explicit Team(int blocks)
      : rank(kCluster ? (int)cooperative_groups::this_cluster().block_rank() : 0), nb(kCluster ? blocks : 1) {}
  __device__ __forceinline__ int thread() const { return rank * kThreads + (int)threadIdx.x; }
  __device__ __forceinline__ int size() const { return nb * kThreads; }
  __device__ __forceinline__ void sync() const {
    if constexpr (kCluster) {
      cooperative_groups::this_cluster().sync();
    } else {
      __syncthreads();
    }
  }
};

// A buffer of a team: on one block, this block's shared memory; on a
// cluster, element e lives in block e / chunk, at offset e % chunk of the
// same region there (distributed shared memory).
template <typename T, bool kCluster>
struct Spread {
  T* base;
  FastDiv chunk;
  __device__ __forceinline__ T& operator[](int e) const {
    if constexpr (kCluster) {
      const int blk = fdiv(e, chunk);
      return *cooperative_groups::this_cluster().map_shared_rank(base + (e - blk * (int)chunk.d), blk);
    } else {
      return base[e];
    }
  }
};

// Ends a phase whose warps wrote partials (warp_partial) to rows of
// red[row][warp]: out[i] = the total (sum or max) of row rows[i] over the
// team, the same bits in every thread. One block: a barrier, then each
// thread reads the rows. A cluster: a block barrier, the block's totals
// (thread i sums row i) to blk[row], the cluster's barrier, then each
// thread adds the blocks' totals in rank order.
template <int kWarps, int kRows, class Team>
__device__ __forceinline__ void team_totals(const Team& tm, double (*red)[kWarps], double* blk, const int (&rows)[kRows],
                                            bool is_max, double (&out)[kRows]) {
  __syncthreads();
  if (tm.nb == 1) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) out[i] = row_total<kWarps>(red[rows[i]], is_max);
    return;
  }
  if (threadIdx.x < kRows) blk[rows[threadIdx.x]] = row_total<kWarps>(red[rows[threadIdx.x]], is_max);
  tm.sync();
  auto cl = cooperative_groups::this_cluster();
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    double v = *cl.map_shared_rank(blk + rows[i], 0);
    for (int r = 1; r < tm.nb; ++r) {
      const double u = *cl.map_shared_rank(blk + rows[i], r);
      v = is_max ? fmax(v, u) : v + u;
    }
    out[i] = v;
  }
}

// The offsets (bit o: offset o of the 3^d, x fastest) where a stencil of
// Q1 (all) and of the port's P1 simplices (tri: all but the (-1,-1) and
// (+1,+1) corners; tet: 15 of 27) may be nonzero.
template <int D>
constexpr unsigned kFullOffsets = D == 2 ? 0x1ffu : 0x7ffffffu;
template <int D>
constexpr unsigned kSimplexOffsets = D == 2 ? 0xfeu : 0x6c3761bu;

// Host: the offsets where S1, S2 or C is nonzero.
inline unsigned nonzero_offsets(const DppWeights<double>& w) {
  unsigned m = 0u;
  for (int o = 0; o < 27; ++o) {
    if (w.s1[o] != 0.0 || w.s2[o] != 0.0 || w.c[o] != 0.0) m |= 1u << o;
  }
  return m;
}

// Interior row `node` of the BC-eliminated operator on z (both fields, f64,
// node layout, zero on the boundary, so boundary neighbours add nothing;
// a pointer or a Spread; field 2 n further): y1 = S1 z1 +
// C z2, y2 = C z1 + S2 z2 over the offsets of kOffsets (a superset of the
// nonzero ones: a zero weight adds an exact zero). The set is a constant,
// so there is no branch: the loads of a plane of neighbours go out
// together, ahead of the sums (behind a branch per offset they went one
// round trip at a time), and the z1 and z2 terms run in separate chains.
template <int D, unsigned kOffsets, class Z>
__device__ __forceinline__ void interior_apply(const Z& z, int n, const DppWeights<double>& w, const Grid& g,
                                               int node, double& y1, double& y2) {
  const int nynx = g.ny * g.nx;
  double a1u = 0.0, a1v = 0.0, a2u = 0.0, a2v = 0.0;
#pragma unroll
  for (int dz = (D == 3 ? -1 : 0); dz <= (D == 3 ? 1 : 0); ++dz) {
    double u[9], v[9];
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      const int o = (D == 3 ? (dz + 1) * 9 : 0) + q;
      if ((kOffsets >> o) & 1u) {
        const int nb = node + dz * nynx + (q / 3 - 1) * g.nx + (q % 3 - 1);
        u[q] = z[nb];
        v[q] = z[n + nb];
      }
    }
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      const int o = (D == 3 ? (dz + 1) * 9 : 0) + q;
      if ((kOffsets >> o) & 1u) {
        a1u = fma(w.s1[o], u[q], a1u);
        a1v = fma(w.c[o], v[q], a1v);
        a2u = fma(w.c[o], u[q], a2u);
        a2v = fma(w.s2[o], v[q], a2v);
      }
    }
  }
  y1 = a1u + a1v;
  y2 = a2u + a2v;
}

// One pass of the separable transform along axis a of the interior grid
// (length na, stride sa): for each line, out_c = sum_p S[p][c] in_p
// (kForward, S^T) or sum_p S[c][p] in_p (S), S row-major with the
// eigenvectors in its columns. kFields == 1: `lines` lines over both fields
// stacked (2 nint / na), emit(q, v, -); kFields == 2: `lines` lines of
// field 0, each with field 1's line nint further, emit(q, v0, v1) (q in
// field 0). A task is one output column c of kG lines, so one load of S
// feeds kG (or 2 kG) sums; tasks go round the team's threads. The loads of
// kChunk steps of p go out together, ahead of their sums (one step at a
// time, each waited out a shared-memory round trip). `in` is a pointer or
// a Spread.
template <typename T, int kG, int kFields, bool kForward, class Team, class In, class Emit>
__device__ __forceinline__ void line_pass_tasks(const Team& tm, const In& in, const T* S, const Interior& ig, int a,
                                                int lines, Emit emit) {
  constexpr int kChunk = 4;
  const int na = (int)ig.len[a].d, sa = (int)ig.stride[a].d, nint = ig.nint;
  const int ss = kForward ? na : 1;  // S's step in p
  const int groups = (lines + kG - 1) / kG;
  for (int t = tm.thread(); t < groups * na; t += tm.size()) {
    const int grp = fdiv(t, ig.len[a]), c = t - grp * na;
    int base[kG], at[kFields][kG];
#pragma unroll
    for (int u = 0; u < kG; ++u) {
      const int l = min(grp * kG + u, lines - 1);
      base[u] = l + fdiv(l, ig.stride[a]) * sa * (na - 1);  // l % sa + (l / sa) * sa * na
#pragma unroll
      for (int f = 0; f < kFields; ++f) at[f][u] = base[u] + f * nint;
    }
    const T* sp = S + (kForward ? c : c * na);
    T acc[kFields][kG];
#pragma unroll
    for (int f = 0; f < kFields; ++f) {
#pragma unroll
      for (int u = 0; u < kG; ++u) acc[f][u] = T(0);
    }
    int p = 0;
    for (; p + kChunk <= na; p += kChunk) {
      T sv[kChunk], lv[kFields][kG][kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        sv[j] = sp[j * ss];
#pragma unroll
        for (int f = 0; f < kFields; ++f) {
#pragma unroll
          for (int u = 0; u < kG; ++u) lv[f][u][j] = in[at[f][u] + j * sa];
        }
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
#pragma unroll
        for (int f = 0; f < kFields; ++f) {
#pragma unroll
          for (int u = 0; u < kG; ++u) acc[f][u] = fma(sv[j], lv[f][u][j], acc[f][u]);
        }
      }
      sp += kChunk * ss;
#pragma unroll
      for (int f = 0; f < kFields; ++f) {
#pragma unroll
        for (int u = 0; u < kG; ++u) at[f][u] += kChunk * sa;
      }
    }
    for (; p < na; ++p) {
      const T sv = *sp;
#pragma unroll
      for (int f = 0; f < kFields; ++f) {
#pragma unroll
        for (int u = 0; u < kG; ++u) {
          acc[f][u] = fma(sv, in[at[f][u]], acc[f][u]);
          at[f][u] += sa;
        }
      }
      sp += ss;
    }
#pragma unroll
    for (int u = 0; u < kG; ++u) {
      if (grp * kG + u < lines) emit(base[u] + c * sa, acc[0][u], acc[kFields - 1][u]);
    }
  }
}

// line_pass_tasks with kG lines a task where one line a task would leave
// threads a second round, else one line a task (more threads, the same
// depth).
template <typename T, int kG, int kFields, bool kForward, class Team, class In, class Emit>
__device__ __forceinline__ void line_pass(const Team& tm, const In& in, const T* S, const Interior& ig, int a,
                                          int lines, Emit emit) {
  if (kG > 1 && lines * (int)ig.len[a].d > tm.size()) {
    line_pass_tasks<T, kG, kFields, kForward>(tm, in, S, ig, a, lines, emit);
  } else {
    line_pass_tasks<T, 1, kFields, kForward>(tm, in, S, ig, a, lines, emit);
  }
}

// Host: launch `kernel` as `plan` places it: one block, or a cluster of
// plan.blocks blocks (cudaLaunchKernelEx; 16 is a non-portable cluster
// size, allowed here), with plan.bytes of dynamic shared memory.
template <class Kernel, class... Args>
cudaError_t launch_team(Kernel kernel, const DirectPlan& plan, int threads, cudaStream_t st, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.bytes);
  if (err != cudaSuccess) return err;
  if (plan.blocks == 1) {
    kernel<<<1, threads, plan.bytes, st>>>(args...);
    return cudaGetLastError();
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(plan.blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = plan.bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace perphil
