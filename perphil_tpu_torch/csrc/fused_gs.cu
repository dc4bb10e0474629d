// fused_gs: the whole lexicographic SNES ngs Picard solve on a 2D tri or a
// 3D hex/tet mesh in one launch (ops/fused_gs.py, FusedGSSolver.launch).
//
// Replaces no Pallas kernel: in the JAX package this solve is one XLA
// while-loop on the device (perphil_tpu/solvers/solver.py:1871-1911,
// _ngs_from with GaussSeidelSweeper.sweep, perphil_tpu/ops/ilu.py:840, the
// wavefront scan _leveled_clip_sweep with scale_diag). It takes the place of
// the port's host loop of one structured_ilu_apply[gs] launch (the ILU
// sweep's Gauss-Seidel mode, ilu_apply.cu), one K1 residual and one norm
// read back an iteration. What it computes is FusedGSSolver.plain bit for
// bit:
//   x = x0 (the BC lift); r = b - A x; f0 = ||r||; tol = max(rtol f0, atol)
//   while fn > tol and its < max_it:
//     x = one forward lexicographic Gauss-Seidel sweep from x
//     r = b - A x; fn = ||r||; its += 1
// A is the BC-eliminated two-field system (ops/ilu.py::_build_system): a
// boundary row is an identity row, an interior row of field f holds the
// weights of S_f and of C, and an entry pointing at a boundary column is
// zero. So a row's entries come from the host's tap table (GsTaps: per
// field its live entries in the system's stored offset order, each a weight
// and an offset in the block's slab of x), not from the packed matrix, and
// x holds 0.0 at boundary nodes, which makes an entry's 0 the twin's 0 (up
// to the sign of a zero). A sweep row is GaussSeidelSweeper.plain's
// (ilu.py::_clip_sweep): acc = b; acc - w * x over the off-centre entries in
// stored order, each product and difference rounded on its own
// (__dmul_rn / __dsub_rn: nvcc would contract them into FMAs); then
// acc / diagonal (__ddiv_rn); x is read in place. A residual row is
// FusedGSSolver.residual's: acc = b; acc - w * x over every entry in stored
// order, the diagonal at its place. A boundary row's residual is b - x0 at
// the lift and exactly 0 after a sweep (the sweep sets x = b / 1.0 there).
// The norm is the halving tree over the 2n squares (krylov.tree_sum), in the
// cluster order of krylov.tree_sum_cluster.
//
// Bound on the H100: latency. A sweep is one dependent level after another
// (the wavefront schedule: level = x + 2y (+ 4z) + field * 4 (8 in 3D)), 53
// levels of at most 18 rows at tri N=16, 389 of at most 130 at tri N=128,
// and a solve is iterations x levels of them: some 16,000 at tri N=16. A row
// is one chain of up to 53 dependent subtractions and a divide. What the
// design does about it:
//   - Slabs. Block b of a cluster of nb (a power of two, 1-16) owns the
//     interior node rows (2D) or planes (3D) [r0_b, r0_b + rows_b), both
//     fields, in shared memory: x with a halo copy of the row or plane just
//     below and just above, and b. Where the grid fits one block (nb = 1)
//     that is the whole of x and b, and a level costs a barrier of only the
//     warps that hold rows (a named barrier; a __syncwarp where one warp
//     does); no cluster operation runs.
//   - Each block walks its interior rows of a level from a compacted list of
//     16-bit offsets into its slab, sorted by level (the host's gs_tables),
//     with the level's bounds in shared memory.
//   - Pushed halo, neighbour-only waits (fused_ngs's protocol,
//     cluster_halo.cuh): a thread that updates a value on its slab's first
//     or last row writes it into the neighbour's halo with st.async; after a
//     level, thread 0 arrives on each neighbour's mbarrier with the bytes it
//     sent (the host's table), and the sweeping warps wait on the block's
//     own for its neighbours. A level's rows read no value of the same
//     level, and a block passes level q's wait only when both neighbours
//     finished level q, so neighbours are never more than one level apart:
//     a halo value is pushed only after the neighbour's last read of the old
//     value it replaces, and before the first read of the new one.
//   - The norm. With one block every thread takes the residuals of the rows
//     that are its own leaves of the tree (values e = s * 512 + tid, a
//     warp's on consecutive rows), halves their squares in registers, and
//     the block finishes the tree over its threads: no residual is stored.
//     On a cluster every block takes its slab's rows and stores each
//     residual into the slot of its tree owner (block (e >> 2) mod nb,
//     fused_gmres.cuh's ownership), then the tree runs as in fused_ngs
//     (cluster_tree.cuh; two cluster barriers an iteration).
//   - The stop test runs in every block on the same bits (each block
//     finishes the tree itself), so the loop needs no broadcast.

#include <cooperative_groups.h>

#include <cstdint>
#include <vector>

#include "cluster_halo.cuh"
#include "cluster_tree.cuh"

namespace perphil {

// The dynamic shared memory a launch may plan with: a block's slab of x
// with its two halo rows or planes, its slab of b, its slice of the norm's
// tree (on a cluster; one block: kGsStageBytes), its list (16-bit offsets),
// the level bounds and (on a cluster) the halo's bytes a level. The host's
// plan (ops/fused_gs.py, which reads this line) mirrors the launcher's; the
// kernel's static shared memory must leave it.
constexpr int kGsSmemBudget = 228352;
constexpr int kGsResultSlots = 8;
// One block's staging of its threads' partial sums of the norm (half of them).
constexpr int kGsStageBytes = 2048;
// A row's entries at most: the two 3^3 blocks of the two-field stencil.
constexpr int kGsMaxTaps = 54;

// Per row field f, its entries in the system's stored offset order, each a
// weight and an offset in a block's slab of x (the other field's by the
// slab's field stride): the residual's (rw, rd: every live entry) and the
// sweep's (gw, gd: all but the diagonal), and the diagonal. The launcher
// builds them from the host's table and pads each list to the kernel's
// kTaps (the two 3^d blocks' live entries: 14 on triangles, 30 on tets, 54
// on hexes) with weight 0.0 at offset 0 (the row's own x), which leaves acc
// as it is (but for the sign of a zero): a row's loads and chain carry no
// test. The kernel keeps them in shared memory (taken from its parameter
// space by a lane's field, they made a level 1.4-1.9x slower: PERF.md).
constexpr int kGsTapStride = (kGsMaxTaps + 3) / 4 * 4;  // a list's room: whole int4s
struct GsTaps {
  double rw[2][kGsTapStride], gw[2][kGsTapStride], dg[2];
  int rd[2][kGsTapStride], gd[2][kGsTapStride];
};
constexpr int kGsTapCounts[] = {14, 30, 54};

// acc less w[t] * xs[code + d[t]] for t < kN in order, each product and
// difference rounded apart; the lists in shared memory, read as int4 and
// double2 (kPad: the lists' room, a multiple of 4), every load of x issued
// before the chain.
template <int kN, int kPad>
__device__ __forceinline__ double row_chain(const double* xs, int code, const double* w, const int* d, double acc) {
  double u[kN];
#pragma unroll
  for (int q = 0; q < kPad / 4; ++q) {
    const int4 dd = reinterpret_cast<const int4*>(d)[q];
    const int at[4] = {dd.x, dd.y, dd.z, dd.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (4 * q + k < kN) u[4 * q + k] = xs[code + at[k]];
    }
  }
#pragma unroll
  for (int q = 0; q < kPad / 2; ++q) {
    const double2 ww = reinterpret_cast<const double2*>(w)[q];
    if (2 * q < kN) acc = __dsub_rn(acc, __dmul_rn(ww.x, u[2 * q]));
    if (2 * q + 1 < kN) acc = __dsub_rn(acc, __dmul_rn(ww.y, u[2 * q + 1]));
  }
  return acc;
}

struct GsGeom {
  int nb, log_nb;  // blocks of the cluster (a power of two)
  int rows;        // R: interior node rows (2D) or planes (3D) a block owns at most
  int log_s;       // log2 of the norm tree's leaves a thread
  int nloc;        // the tree's values a block owns at most
  int width;       // the list's stride: both fields' interior nodes of R rows or planes
  int nlev;        // the sweep's levels that hold interior rows
  int bytes;       // dynamic shared memory
};

// The probe build (PERPHIL_GS_PROFILE; tools/profile_kernels.py --only gs
// and chip_smoke.py build csrc/fused_gs.cu alone with it) adds the entry
// point perphil_fused_gs_probe, whose launches may ask for
//   - extra_levels empty levels after each sweep's last: the latency floor;
//   - clocks: thread 0 of block 0's cycles in each phase summed into
//     gs_prof: its rows of a level (their loads, chains and divides, the
//     pushes sent), the level barrier and the halo wait, the norm's
//     residual rows, and the tree (with its cluster barriers).
// The package's library holds neither: its launches carry GsProbe{} and its
// level loop runs the sweep's levels alone.
struct GsProbe {
  int extra_levels, clocks;
};
enum GsPhase { kGsRows, kGsWait, kGsNormRows, kGsTree, kGsPhases };
#ifdef PERPHIL_GS_PROFILE
__device__ unsigned long long gs_prof[kGsPhases];
#endif

__host__ __device__ inline long gs_align16(long bytes) { return (bytes + 15) / 16 * 16; }

// The sweep's levels that hold an interior row of a (nz, ny, nx) grid (nz =
// 1 in 2D): the distinct x + 2y + 4z + field * shift over interior nodes.
inline int gs_levels(int dim, int nz, int ny, int nx) {
  const int shift = dim == 2 ? 4 : 8, z0 = dim == 2 ? 0 : 1, z1 = dim == 2 ? 1 : nz - 1;
  const int top = (nx - 2) + 2 * (ny - 2) + 4 * (z1 - 1) + shift + 2;
  std::vector<int> marks(top + 1, 0);
  for (int f = 0; f < 2; ++f) {
    for (int z = z0; z < z1; ++z) {
      for (int y = 1; y < ny - 1; ++y) {
        const int lo = 1 + 2 * y + 4 * z + f * shift;
        ++marks[lo];
        --marks[lo + nx - 2];
      }
    }
  }
  int levels = 0, run = 0;
  for (int k = 0; k <= top; ++k) levels += (run += marks[k]) > 0;
  return levels;
}

// The launcher's placement of a (nz, ny, nx) grid on `blocks` blocks (0:
// the rule, one block where the grid fits, else the most that place it:
// measured fastest, tools/profile_kernels.py --only gs; PERF.md).
// A count is placed where each block gets at least one interior row or
// plane, the norm's tree takes at most 32 leaves a thread with no more
// threads than leaves, a slab's offsets fit 16 bits, and the slab fits in
// kGsSmemBudget.
inline bool gs_place(int dim, int nz, int ny, int nx, int blocks, GsGeom& g) {
  g = GsGeom{};
  if ((dim != 2 && dim != 3) || nx < 3 || ny < 3 || (dim == 3 ? nz < 3 : nz != 1)) return false;
  const int outer = dim == 2 ? ny : nz;
  const long plane = dim == 2 ? nx : (long)ny * nx, inner = dim == 2 ? nx - 2 : (long)(ny - 2) * (nx - 2);
  if (blocks < 1 || blocks > kMaxCluster || (blocks & (blocks - 1)) || blocks > outer - 2) return false;
  const long L = 2L * nz * ny * nx;
  if (blocks > gmres_blocks(L)) return false;
  g.nb = blocks;
  while ((1 << g.log_nb) < g.nb) ++g.log_nb;
  while (((long)kGmresThreads * g.nb << g.log_s) < L) ++g.log_s;
  if (g.log_s > kMaxLogS) return false;
  const long piece = 4L * g.nb;
  g.nloc = (int)(4 * (L / piece) + (L % piece < 4 ? L % piece : 4));
  g.rows = (outer - 2 + g.nb - 1) / g.nb;
  if (2 * (g.rows + 2) * plane > 65536) return false;
  g.width = (int)(2 * g.rows * inner);
  g.nlev = gs_levels(dim, nz, ny, nx);
  const long bytes = gs_align16(8 * 2 * (g.rows + 2) * plane) + gs_align16(8 * 2 * g.rows * plane) +
                     (g.nb > 1 ? gs_align16(8L * g.nloc) : kGsStageBytes) + gs_align16(2L * g.width) +
                     gs_align16(4L * (g.nlev + 1)) + (g.nb > 1 ? gs_align16(8L * g.nlev) : 0);
  if (bytes > kGsSmemBudget) return false;
  g.bytes = (int)bytes;
  return true;
}

inline bool gs_geometry(int dim, int nz, int ny, int nx, int blocks, GsGeom& g) {
  if (blocks != 0) return gs_place(dim, nz, ny, nx, blocks, g);
  if (gs_place(dim, nz, ny, nx, 1, g)) return true;
  for (int nb = kMaxCluster; nb >= 2; nb /= 2) {
    if (gs_place(dim, nz, ny, nx, nb, g)) return true;
  }
  return false;
}

template <int kTaps>
__global__ void __launch_bounds__(kGmresThreads, 1)
fused_gs_kernel(const double* b, const double* x0, double* x, const uint16_t* lists, const int* cptr_g,
                const int* sends_g, double* result, GsTaps taps, int outer, int plane, int ny, int nx,
                double rtol, double atol, int max_it, int sweep_warps, GsGeom geom, GsProbe probe) {
  extern __shared__ __align__(16) unsigned char dyn[];
  constexpr int kPad = (kTaps + 3) / 4 * 4;
  __shared__ __align__(16) double rw[2][kPad], gw[2][kPad];
  __shared__ __align__(16) int rd[2][kPad], gd[2][kPad];
  __shared__ double dg[2];
  __shared__ double part[1][64];
  __shared__ double scal[1], xpart[4];
  __shared__ __align__(8) uint64_t bar[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = geom.nb, nbm = nb - 1, log_nb = geom.log_nb, nlev = geom.nlev, R = geom.rows;
  const int n = outer * plane, L = 2 * n, sw = sweep_warps;
  const Own o{(int)cluster.block_rank(), nb, ((((lane >> 2) << 4) | warp) << 2) | (lane & 3), geom.log_s};
  // the slab: node rows (2D) or planes (3D) [r0, r0 + rows) of the outer - 2
  // interior ones, balanced; "plane" below means either
  const int base = (outer - 2) / nb, extra = (outer - 2) % nb;
  const int r0 = 1 + o.b * base + (o.b < extra ? o.b : extra), rows = base + (o.b < extra ? 1 : 0);
  const int rows_below = o.b > 0 ? base + (o.b - 1 < extra ? 1 : 0) : 0;
  const int fs = (R + 2) * plane;  // a field's stride in xs: its planes with the two halo planes
  // xs: local plane l is plane r0 - 1 + l (l = 0 and rows + 1: the halo)
  double* xs = reinterpret_cast<double*>(dyn);
  double* bs = xs + gs_align16(8L * 2 * fs) / 8;          // own planes only, field stride R plane
  // the tree: a cluster's slice of its values, one block's staging of its threads' partials
  double* rt = bs + gs_align16(8L * 2 * R * plane) / 8;
  uint16_t* list = reinterpret_cast<uint16_t*>(rt + (nb > 1 ? gs_align16(8L * geom.nloc) : kGsStageBytes) / 8);
  int* cptr = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(list) + gs_align16(2L * geom.width));
  int* sends = cptr + gs_align16(4L * (nlev + 1)) / 4;    // a cluster's: per level [down, up]
  const bool down = o.b > 0, up = o.b < nbm;

  // a node's plane and row by float products, exact below 2^22 nodes: the
  // quotient lies 0.5 / plane (or 0.5 / nx) from an integer
  const float inv_plane = 1.0f / (float)plane, inv_nx = 1.0f / (float)nx;
  auto boundary = [&](int node) {
    const int p = (int)(((float)node + 0.5f) * inv_plane), w = node - p * plane;
    const int j = (int)(((float)w + 0.5f) * inv_nx), i = w - j * nx;  // 2D: j = 0
    return p == 0 || p == outer - 1 || i == 0 || i == nx - 1 || (plane != nx && (j == 0 || j == ny - 1));
  };
  if (tid < 2 * kPad) {
    const int f = tid / kPad, t = tid - f * kPad;
    rw[f][t] = taps.rw[f][t];
    rd[f][t] = taps.rd[f][t];
    gw[f][t] = taps.gw[f][t];
    gd[f][t] = taps.gd[f][t];
    if (t == 0) dg[f] = taps.dg[f];
  }
  if (tid == 0 && nb > 1) init_halo_bars(bar, (down ? 1 : 0) + (up ? 1 : 0));
  // the tree's slots: a boundary row's residual at the lift, b - x0
  for (int i = tid; nb > 1 && i < geom.nloc; i += kGmresThreads) {
    const int e = o.elem(i);
    rt[i] = e < L && boundary(e >= n ? e - n : e) ? __dsub_rn(b[e], x0[e]) : 0.0;
  }
  // x: interior nodes from the lift, boundary nodes 0.0; b: own planes
  for (int k = tid; k < 2 * (rows + 2) * plane; k += kGmresThreads) {
    const int f = k / ((rows + 2) * plane), t = k - f * (rows + 2) * plane, node = (r0 - 1) * plane + t;
    xs[f * fs + t] = boundary(node) ? 0.0 : x0[f * n + node];
  }
  for (int k = tid; k < 2 * rows * plane; k += kGmresThreads) {
    const int f = k / (rows * plane), t = k - f * rows * plane;
    bs[f * R * plane + t] = b[f * n + r0 * plane + t];
  }
  for (int k = tid; k <= nlev; k += kGmresThreads) cptr[k] = cptr_g[o.b * (nlev + 1) + k];
  for (int k = tid; nb > 1 && k < 2 * nlev; k += kGmresThreads) sends[k] = sends_g[o.b * 2 * nlev + k];
  __syncthreads();
  for (int k = tid; k < cptr[nlev]; k += kGmresThreads) list[k] = lists[(long)o.b * geom.width + k];
  if (nb > 1) {
    cluster.sync();  // the mbarriers and the tree's slots in place before any remote access
  } else {
    __syncthreads();
  }
#ifdef PERPHIL_GS_PROFILE
  const bool clocked = probe.clocks != 0 && o.b == 0 && tid == 0;
  long long t0 = clock64(), clk[kGsPhases] = {};
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

  // a list entry (a code) is the row's offset in xs: field f = code >= fs,
  // then (local plane) * plane + the node's place in the plane
  auto b_at = [&](int code, int f) { return bs[code - plane - 2 * plane * f]; };
  // b - A x at an interior row: every entry in stored order
  auto residual = [&](int code, int f) { return row_chain<kTaps, kPad>(xs, code, rw[f], rd[f], b_at(code, f)); };
  // the row's Gauss-Seidel update: the off-centre entries, then the divide
  auto sweep_row = [&](int code, int f) {
    return __ddiv_rn(row_chain<kTaps - 1, kPad>(xs, code, gw[f], gd[f], b_at(code, f)), dg[f]);
  };
  // ||b - A x|| after `its` sweeps (a boundary row's residual: b - x0 before
  // the first, 0.0 after it)
  auto norm = [&](int its) {
    if (nb == 1) {
      // one block: thread tid owns the values e = s * 512 + tid, a warp's on
      // consecutive rows (the frame's order puts a warp's lanes on runs of
      // four values 64 apart: every gather of x an 8-way bank conflict); a
      // row's code is e
      auto leaf = [&](int s) {
        const int e = s * kGmresThreads + tid;
        if (e >= L) return 0.0;
        const int f = e >= n ? 1 : 0;
        const double r = !boundary(e - f * n) ? residual(e, f) : its == 0 ? __dsub_rn(b[e], x0[e]) : 0.0;
        return __dmul_rn(r, r);
      };
      // the thread's leaves, two a step, their chains side by side
      TreeAcc<kMaxLogS> acc;
      if (o.log_s == 0) {
        acc.push(leaf(0));
      } else {
#pragma unroll 1
        for (int t = 0; t < (1 << o.log_s); t += 2) {
          const double v0 = leaf(bit_reverse(t, o.log_s)), v1 = leaf(bit_reverse(t + 1, o.log_s));
          acc.push(v0);
          acc.push(v1);
        }
      }
      double v = acc.result(o.log_s);
      mark(kGsNormRows);
      // then the threads, e's bits 8..5 (the warps) through shared memory,
      // 4..0 (the lanes) by shuffles: tid pairs with tid + h
      for (int h = kGmresThreads / 2; h >= 32; h >>= 1) {
        if (tid >= h && tid < 2 * h) rt[tid - h] = v;
        __syncthreads();
        if (tid < h) v = __dadd_rn(v, rt[tid]);
        __syncthreads();
      }
      if (warp == 0) {
        v = add_down(add_down(add_down(add_down(add_down(v, 16), 8), 4), 2), 1);
        if (lane == 0) scal[0] = v;
      }
      __syncthreads();
    } else {
      if (its == 1) {
        for (int i = tid; i < geom.nloc; i += kGmresThreads) {
          const int e = o.elem(i);
          if (e < L && boundary(e >= n ? e - n : e)) rt[i] = 0.0;
        }
      }
      // the residual of every own row into its tree owner's slot
      for (int k = tid; k < cptr[nlev]; k += kGmresThreads) {
        const int code = list[k], f = code >= fs ? 1 : 0;
        const double r = residual(code, f);
        const int e = code - f * fs + f * n + (r0 - 1) * plane, piece = e >> 2;
        *cluster.map_shared_rank(rt + (((piece >> log_nb) << 2) | (e & 3)), piece & nbm) = r;
      }
      mark(kGsNormRows);
      cluster.sync();  // every residual in its tree slot
      cluster_square_tree(cluster, o, rt, L, part, xpart, scal);
    }
    mark(kGsTree);
    return __dsqrt_rn(scal[0]);
  };

  const double f0 = norm(0);
  const double rel_tol = __dmul_rn(rtol, f0);
  const double tol = atol > rel_tol ? atol : rel_tol;  // Python's max(rtol * f0, atol)
  double fn = f0;
  int its = 0, q = 0;  // q: levels so far, which picks the mbarrier and its parity
#ifdef PERPHIL_GS_PROFILE
  const int steps = nlev + probe.extra_levels;  // levels past nlev are empty: the latency floor
#else
  const int steps = nlev;
#endif
  while (fn > tol && its < max_it) {
    if (warp < sw) {
      // the thread's first row of a level, read before the barrier that ends
      // the level before it (the list does not change)
      int lo = cptr[0], hi = nlev > 0 ? cptr[1] : 0, first = lo + tid < hi ? list[lo + tid] : 0;
      for (int l = 0; l < steps; ++l, ++q) {
        uint64_t* const bq = bar + (q & 1);
        for (int k = lo + tid; k < hi; k += 32 * sw) {
          const int code = k == lo + tid ? first : list[k], f = code >= fs ? 1 : 0;
          const double v = sweep_row(code, f);
          xs[code] = v;
          if (nb > 1) {
            const int t = code - f * fs;  // (local plane) * plane + place
            if (down && t < 2 * plane) push(xs + code + rows_below * plane, v, o.b - 1, bq);
            if (up && t >= rows * plane) push(xs + code - rows * plane, v, o.b + 1, bq);
          }
        }
        mark(kGsRows);
        lo = l + 1 < nlev ? cptr[l + 1] : 0;
        hi = l + 1 < nlev ? cptr[l + 2] : 0;
        first = lo + tid < hi ? list[lo + tid] : 0;
        // the level's rows written before the next level reads them: only
        // the warps that sweep meet
        if (sw == 1) {
          __syncwarp();
        } else {
          asm volatile("bar.sync 1, %0;" : : "r"(32 * sw) : "memory");
        }
        if (nb > 1) {
          if (tid == 0) {
            if (down) arrive_remote(bq, o.b - 1, l < nlev ? 8 * sends[2 * l] : 0);
            if (up) arrive_remote(bq, o.b + 1, l < nlev ? 8 * sends[2 * l + 1] : 0);
          }
          wait_parity(bq, (q >> 1) & 1);
        }
        mark(kGsWait);
      }
    } else {
      q += steps;
    }
    __syncthreads();  // the sweep done before any residual reads it
    ++its;
    fn = norm(its);
  }
  // x: the own planes' interior values; their boundary nodes b after a sweep
  // (b / 1.0), the lift before it
  for (int k = tid; k < 2 * rows * plane; k += kGmresThreads) {
    const int f = k / (rows * plane), t = k - f * rows * plane, node = r0 * plane + t, e = f * n + node;
    x[e] = !boundary(node) ? xs[f * fs + plane + t] : its > 0 ? b[e] : x0[e];
  }
  for (int k = tid; k < 2 * plane; k += kGmresThreads) {  // the grid's first and last planes
    const int f = k / plane, w = k - f * plane;
    if (o.b == 0) x[f * n + w] = its > 0 ? b[f * n + w] : x0[f * n + w];
    if (o.b == nbm) {
      const int e = f * n + (outer - 1) * plane + w;
      x[e] = its > 0 ? b[e] : x0[e];
    }
  }
  if (o.b == 0 && tid == 0) {
    result[0] = (double)its;
    result[1] = fn;
    result[2] = f0;
    result[3] = (double)nb;
    result[4] = (double)R;
    result[5] = (double)(1 << geom.log_s);
    result[6] = (double)geom.bytes;
    result[7] = (double)nlev;
  }
#ifdef PERPHIL_GS_PROFILE
  if (clocked) {
    for (int k = 0; k < kGsPhases; ++k) atomicAdd(gs_prof + k, (unsigned long long)clk[k]);
  }
#endif
  if (nb > 1) cluster.sync();  // no block leaves while another may still reach its shared memory
}

// b, x0, x: (2, [nz,] ny, nx) f64 (b the lifted right-hand side, x0 the BC
// lift, x out); lists: (nb, width) uint16, per block its interior rows'
// offsets in its slab sorted by level; cptr: (nb, nlev + 1) int32, each
// block's level bounds in its list; sends: (nb, nlev, 2) int32, the values
// of each level a block pushes to the block below and above; result:
// kGsResultSlots f64 [iterations, fn, f0, blocks, rows, leaves a thread,
// dynamic bytes, levels]; tap_w (2, 54) f64, tap_d (2, 54) int32 and tap_nc
// [n0, n1, c0, c1] int32, host arrays: GsTaps. dim 2 (nz = 1) or 3; blocks
// (0: the launcher's rule), rows, nloc, width and nlev: the host's plan,
// which must be the launcher's; sweep_warps (1-16): the warps that take a
// level's rows (the host's: the widest level a block holds).
inline int launch_fused_gs(const double* b, const double* x0, double* x, const uint16_t* lists, const int* cptr,
                           const int* sends, double* result, const double* tap_w, const int* tap_d,
                           const int* tap_nc, int dim, int nz, int ny, int nx, double rtol, double atol, int max_it,
                           int blocks, int rows, int nloc, int width, int nlev, int sweep_warps, GsProbe probe,
                           void* stream) {
  GsGeom geo;
  if (max_it < 0 || probe.extra_levels < 0 || sweep_warps < 1 || sweep_warps > kGmresThreads / 32 ||
      !gs_geometry(dim, nz, ny, nx, blocks, geo) || geo.rows != rows || geo.nloc != nloc || geo.width != width ||
      geo.nlev != nlev) {
    return (int)cudaErrorInvalidValue;
  }
  // the residual's and the sweep's lists, each padded with weight 0.0 at offset 0
  GsTaps t{};
  for (int f = 0; f < 2; ++f) {
    const int n = tap_nc[f], c = tap_nc[2 + f];
    if (n < 1 || n > kGsMaxTaps || c < 0 || c >= n) return (int)cudaErrorInvalidValue;
    for (int k = 0; k < n; ++k) {
      t.rw[f][k] = tap_w[f * kGsMaxTaps + k];
      t.rd[f][k] = tap_d[f * kGsMaxTaps + k];
      if (k != c) {
        t.gw[f][k - (k > c)] = t.rw[f][k];
        t.gd[f][k - (k > c)] = t.rd[f][k];
      }
    }
    t.dg[f] = t.rw[f][c];
  }
  using Kernel = void (*)(const double*, const double*, double*, const uint16_t*, const int*, const int*, double*,
                          GsTaps, int, int, int, int, double, double, int, int, GsGeom, GsProbe);
  const int taps_needed = tap_nc[0] > tap_nc[1] ? tap_nc[0] : tap_nc[1];
  const Kernel kernel = taps_needed <= kGsTapCounts[0]   ? fused_gs_kernel<kGsTapCounts[0]>
                        : taps_needed <= kGsTapCounts[1] ? fused_gs_kernel<kGsTapCounts[1]>
                                                         : fused_gs_kernel<kGsTapCounts[2]>;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  // the plan's budget is the host's; a kernel that leaves less refuses
  if (kMaxSmemPerBlock - (long)fa.sharedSizeBytes < kGsSmemBudget) return (int)cudaErrorLaunchOutOfResources;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.bytes);
  if (err != cudaSuccess) return (int)err;
  // one cluster of geo.nb blocks; a card that cannot place it refuses the launch
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(geo.nb);
  cfg.blockDim = dim3(kGmresThreads);
  cfg.dynamicSmemBytes = (size_t)geo.bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = geo.nb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int outer = dim == 2 ? ny : nz, plane = dim == 2 ? nx : ny * nx;
  err = cudaLaunchKernelEx(&cfg, kernel, b, x0, x, lists, cptr, sends, result, t, outer, plane, ny, nx, rtol, atol,
                           max_it, sweep_warps, geo, probe);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace perphil

extern "C" int perphil_fused_gs(const double* b, const double* x0, double* x, const uint16_t* lists,
                                const int* cptr, const int* sends, double* result, const double* tap_w,
                                const int* tap_d, const int* tap_nc, int dim, int nz, int ny, int nx,
                                double rtol, double atol, int max_it, int blocks, int rows, int nloc, int width,
                                int nlev, int sweep_warps, void* stream) {
  return perphil::launch_fused_gs(b, x0, x, lists, cptr, sends, result, tap_w, tap_d, tap_nc, dim, nz, ny, nx, rtol,
                                  atol, max_it, blocks, rows, nloc, width, nlev, sweep_warps, perphil::GsProbe{},
                                  stream);
}

#ifdef PERPHIL_GS_PROFILE
// perphil_fused_gs's launch with extra_levels empty levels after each
// sweep's last and, where clocks is nonzero, the phase clocks (GsProbe).
extern "C" int perphil_fused_gs_probe(const double* b, const double* x0, double* x, const uint16_t* lists,
                                      const int* cptr, const int* sends, double* result, const double* tap_w,
                                      const int* tap_d, const int* tap_nc, int dim, int nz, int ny, int nx,
                                      double rtol, double atol, int max_it, int blocks, int rows, int nloc,
                                      int width, int nlev, int sweep_warps, int extra_levels, int clocks,
                                      void* stream) {
  return perphil::launch_fused_gs(b, x0, x, lists, cptr, sends, result, tap_w, tap_d, tap_nc, dim, nz, ny, nx, rtol,
                                  atol, max_it, blocks, rows, nloc, width, nlev, sweep_warps,
                                  perphil::GsProbe{extra_levels, clocks}, stream);
}

// Copies the phase counters (GsPhase, cycles summed over the launches since
// the last take) to `out` on the host, then zeroes them.
extern "C" int perphil_fused_gs_profile_take(unsigned long long* out) {
  const unsigned long long zero[perphil::kGsPhases] = {};
  cudaError_t err = cudaMemcpyFromSymbol(out, perphil::gs_prof, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(perphil::gs_prof, zero, sizeof(zero));
  return (int)err;
}
#endif
