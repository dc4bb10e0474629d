// fused_ngs: the whole pinned-colouring SNES ngs Picard solve on a 2D quad
// mesh in one launch (ops/fused_ngs.py, FusedNGSSolver.launch).
//
// Replaces no Pallas kernel: in the JAX package this solve is one XLA
// while-loop on the device (perphil_tpu/solvers/solver.py:1852-1911,
// _build_nonlinear_solver's native-f64 ngs branch; on the TPU the
// double-float twin _build_ngs_solver_df, :1665-1830), whose sweep is
// ColoredNGSSweeper.sweep (perphil_tpu/ops/ilu.py:924). What it computes is
// FusedNGSSolver.plain bit for bit:
//   x = x0 (the BC lift); f0 = ||b - A x||; tol = max(rtol f0, atol);
//   while fn > tol and its < max_it:
//     for each colour c, ascending: x[c] += (b - A x)[c] / diag[c]
//     fn = ||b - A x||; its += 1
// A is the BC-eliminated two-field operator: a row of field f at an
// interior node takes 0.0 plus w[f][f' * 9 + q] * x[f', node + offset q],
// field 0's nine taps then field 1's, each product and sum rounded on its
// own (__dmul_rn / __dadd_rn: nvcc would contract them into FMAs), a
// boundary neighbour reading 0.0; the update divides by the diagonal
// (__ddiv_rn), as the twin does. Boundary rows are identity rows whose
// residual is exactly 0 at the lift, so they neither update nor add to the
// norm. The norm is the halving tree over the 2n squares (krylov.tree_sum),
// in the cluster order of krylov.tree_sum_cluster.
//
// Bound on the H100: latency. At 2D N=128 (5135 iterations, 14 colours)
// the arithmetic is ~2.5 MFLOP an iteration, 0.36 ms in all at 34 TFLOP/s
// f64; but every colour depends on the one before, so a solve is 71,890
// colour phases and 5,135 norms in a chain. What the design does about it:
//   - Slabs. Block b of a cluster of nb (a power of two, 1-16) owns the
//     interior node rows [r0_b, r0_b + rows_b), both fields, in shared
//     memory (x and b), the rows balanced over the blocks; beside them a
//     halo copy of the node row just below and just above the slab. A row's
//     18 taps read only the block's own shared memory. Boundary nodes hold
//     0.0 there (the boundary columns, and the halo rows that are grid
//     boundary rows), so a tap needs no test: the 0.0 it loads is the 0.0
//     the twin's mask gives. The lift's boundary values go to x from x0.
//   - Pushed halo, neighbour-only waits. A thread that updates a value on
//     its slab's first or last row writes it at once into the neighbour's
//     halo with st.async, which completes its 8 bytes on an mbarrier in the
//     receiver's shared memory. After a colour's rows (__syncthreads),
//     thread 0 arrives on each neighbour's mbarrier with the bytes it sent
//     in that colour (expect_tx, from the host's table); then every thread
//     waits on the block's own mbarrier for its <= 2 neighbours. No cluster
//     barrier stands inside the colour loop. The arrivals and waits keep
//     their default CTA-scope ordering: the pushed bytes become visible
//     through the mbarrier's transaction count, and an arrival follows the
//     block barrier after the sender's last read of its halo. Cluster-scope
//     release and acquire made the solve 1.5x slower at 2D N=128 (PERF.md).
//   - Why one halo buffer is enough. A block passes its wait of colour
//     phase q only when both neighbours have finished phase q (their
//     arrivals come after their rows), so neighbours are never more than
//     one phase apart: while block b runs phase q, a neighbour writes into
//     b's halo only values of colour q. The colouring is distance-1 on the
//     monolithic pattern, so b's rows of colour q read no value of colour q:
//     a halo value is never overwritten while it is being read. The
//     mbarriers alternate by phase parity (bar[q & 1]): phase q+2's bytes
//     and arrivals on bar[q & 1] can come only after the neighbour saw b's
//     arrival of phase q+1, which b makes after its wait of phase q.
//   - The norm. Every thread takes the residuals of its slab's rows in the
//     slab's order (a warp on consecutive columns), two rows' loads issued
//     before their chains, and stores each residual into the slot of its
//     tree owner (block (e >> 2) mod nb, the fused GMRES frame's ownership,
//     fused_gmres.cuh): the halving tree pairs e with e + W/2^k, so no slab
//     holds a subtree. One cluster barrier, then the tree in
//     cluster_tree_rows's order, with the blocks' partials exchanged through
//     distributed shared memory (a second cluster barrier) where the frame
//     goes through device memory: two cluster barriers an iteration. The
//     residuals stay in the tree's layout, and colour 0 of the next
//     iteration reads its rows' there (the JAX df loop's reuse), through
//     distributed shared memory where another block owns the slot.
//   - Each block walks its own rows of a colour from a compacted list of
//     16-bit offsets (the host sorts every block's interior rows by colour),
//     so a phase costs what the colour holds, not a pass over the slab. A
//     colour's rows are sparse, so a warp's 32 taps would crowd a few of
//     shared memory's banks; the host deals each run out by bank
//     (ops/fused_ngs.py::ngs_tables), 6-18% faster than offset order.
//   - The stop test runs in every block on the same bits (each block
//     finishes the tree itself), so the loop needs no broadcast.

#include <cooperative_groups.h>

#include <cstdint>

#include "cluster_halo.cuh"
#include "cluster_tree.cuh"

namespace perphil {

constexpr int kNgsMaxColors = 32;
// The dynamic shared memory a launch may plan with: a block's slab of x
// with its two halo rows (2 (R + 2) nx doubles), its slab of b (2 R nx
// doubles), its slice of the norm's tree (nloc doubles) and its colour list
// (2 R (nx - 2) 16-bit offsets), R the most rows a block owns. The host's
// plan (ops/fused_ngs.py, which reads this line) mirrors the launcher's; the
// kernel's static shared memory must leave it.
constexpr int kNgsSmemBudget = 230400;
constexpr int kNgsResultSlots = 7;
// The block count where the launch leaves it to the launcher: the most
// blocks (up to this) that the mesh allows, measured fastest at 2D
// N=32-255 (tools/profile_kernels.py --only ngs; PERF.md).
constexpr int kNgsRuleBlocks = 16;

// Per field f of the row, its 18 taps: field 0's nine (offsets (dy, dx)
// row-major), then field 1's; then the two diagonals.
struct NgsWeights {
  double w[2][18];
  double diag[2];
};

struct NgsGeom {
  int nb, log_nb;  // blocks of the cluster (a power of two)
  int rows;        // R: interior node rows a block owns at most
  int log_s;       // log2 of the norm tree's leaves a thread
  int nloc;        // the tree's values a block owns at most
  int width;       // the list's stride: 2 R (nx - 2) entries
  int bytes;       // dynamic shared memory
};

// Phase clocks, for tools/profile_kernels.py --only ngs-phases alone: a
// build with PERPHIL_NGS_PROFILE adds thread 0 of block 0's cycles in each
// phase to ngs_prof (the package's library holds no counter): a colour's
// own rows (their pushes issued), the halo (the block barrier, the
// arrivals, the wait for the neighbours), the norm's residual rows (their
// stores to the tree issued), the cluster barrier that publishes them, and
// the tree (its cluster barrier inside).
enum NgsPhase { kNgsRows, kNgsHalo, kNgsNormRows, kNgsSquares, kNgsTree, kNgsPhases };
#ifdef PERPHIL_NGS_PROFILE
__device__ unsigned long long ngs_prof[kNgsPhases];
#endif

__host__ __device__ inline long ngs_align16(long bytes) { return (bytes + 15) / 16 * 16; }

// The launcher's placement of a (ny, nx) grid on `blocks` blocks (0: the
// rule, the most blocks up to kNgsRuleBlocks that place it). A count is
// placed where each block gets at least one interior row, the norm's tree
// takes at most 32 leaves a thread with no more threads than leaves, and
// the slab fits in kNgsSmemBudget.
inline bool ngs_place(int ny, int nx, int ncolors, int blocks, NgsGeom& g) {
  g = NgsGeom{};
  if (nx < 3 || ny < 3 || ncolors < 1 || ncolors > kNgsMaxColors) return false;
  if (blocks < 1 || blocks > kMaxCluster || (blocks & (blocks - 1)) || blocks > ny - 2) return false;
  const long L = 2L * nx * ny;
  if (blocks > gmres_blocks(L)) return false;
  g.nb = blocks;
  while ((1 << g.log_nb) < g.nb) ++g.log_nb;
  while (((long)kGmresThreads * g.nb << g.log_s) < L) ++g.log_s;
  if (g.log_s > kMaxLogS) return false;
  const long piece = 4L * g.nb;
  g.nloc = (int)(4 * (L / piece) + (L % piece < 4 ? L % piece : 4));
  g.rows = (ny - 2 + g.nb - 1) / g.nb;
  g.width = 2 * g.rows * (nx - 2);
  const long bytes = ngs_align16(8L * 2 * (g.rows + 2) * nx) + ngs_align16(8L * 2 * g.rows * nx) +
                     ngs_align16(8L * g.nloc) + ngs_align16(2L * g.width);
  if (bytes > kNgsSmemBudget) return false;
  g.bytes = (int)bytes;
  return true;
}

inline bool ngs_geometry(int ny, int nx, int ncolors, int blocks, NgsGeom& g) {
  if (blocks != 0) return ngs_place(ny, nx, ncolors, blocks, g);
  for (int nb = kNgsRuleBlocks; nb >= 1; nb /= 2) {
    if (ngs_place(ny, nx, ncolors, nb, g)) return true;
  }
  return false;
}

__global__ void __launch_bounds__(kGmresThreads, 1)
fused_ngs_kernel(const double* b, const double* x0, double* x, const uint16_t* lists, const int* cptr_g,
                 const int* sends_g, double* result, NgsWeights wt, int nx, int ny, int ncolors,
                 double rtol, double atol, int max_it, NgsGeom geom) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ double part[1][64];
  __shared__ double scal[1], xpart[4];
  __shared__ double ws[2][18], dg[2];
  __shared__ int cptr[kNgsMaxColors + 1];
  __shared__ int sends[kNgsMaxColors][2];
  __shared__ __align__(8) uint64_t bar[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = nx * ny, L = 2 * n, nb = geom.nb, nbm = nb - 1, log_nb = geom.log_nb;
  const Own o{(int)cluster.block_rank(), nb, ((((lane >> 2) << 4) | warp) << 2) | (lane & 3), geom.log_s};
  // the slab: rows [r0, r0 + rows) of ny - 2 interior rows, balanced
  const int base = (ny - 2) / nb, extra = (ny - 2) % nb;
  const int r0 = 1 + o.b * base + (o.b < extra ? o.b : extra), rows = base + (o.b < extra ? 1 : 0);
  const int rows_below = o.b > 0 ? base + (o.b - 1 < extra ? 1 : 0) : 0;
  const int fs = (geom.rows + 2) * nx;  // a field's stride in xs: its rows with the two halo rows
  // xs: local row l is node row r0 - 1 + l (l = 0 and rows + 1: the halo)
  double* xs = reinterpret_cast<double*>(dyn);
  double* bs = xs + ngs_align16(8L * 2 * fs) / 8;  // own rows only, field stride R nx
  double* rt = bs + ngs_align16(8L * 2 * geom.rows * nx) / 8;
  uint16_t* list = reinterpret_cast<uint16_t*>(rt + ngs_align16(8L * geom.nloc) / 8);
  const bool down = o.b > 0, up = o.b < nbm;

  if (tid < 36) ws[tid / 18][tid % 18] = wt.w[tid / 18][tid % 18];
  if (tid < 2) dg[tid] = wt.diag[tid];
  if (tid <= ncolors) cptr[tid] = cptr_g[o.b * (ncolors + 1) + tid];
  if (tid < 2 * ncolors) sends[tid >> 1][tid & 1] = sends_g[(o.b * ncolors + (tid >> 1)) * 2 + (tid & 1)];
  if (tid == 0 && nb > 1) {
    init_halo_bars(bar, (down ? 1 : 0) + (up ? 1 : 0));
  }
  for (int i = tid; i < geom.nloc; i += kGmresThreads) rt[i] = 0.0;
  // x: interior nodes from the lift, boundary nodes 0.0; b: own rows
  for (int k = tid; k < 2 * (rows + 2) * nx; k += kGmresThreads) {
    const int f = k / ((rows + 2) * nx), t = k - f * (rows + 2) * nx, l = t / nx, i = t - l * nx;
    const int j = r0 - 1 + l;
    const bool inner = j > 0 && j < ny - 1 && i > 0 && i < nx - 1;
    xs[f * fs + t] = inner ? x0[f * n + j * nx + i] : 0.0;
  }
  for (int k = tid; k < 2 * rows * nx; k += kGmresThreads) {
    const int f = k / (rows * nx), t = k - f * rows * nx;
    bs[f * geom.rows * nx + t] = b[f * n + r0 * nx + t];
  }
  __syncthreads();
  for (int k = tid; k < cptr[ncolors]; k += kGmresThreads) list[k] = lists[(long)o.b * geom.width + k];
  cluster.sync();  // the mbarriers and the tree's slots in place before any remote access
#ifdef PERPHIL_NGS_PROFILE
  const bool clocked = o.b == 0 && tid == 0;
  long long t0 = clock64(), clk[kNgsPhases] = {};
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

  // a list entry is the value's offset in xs: field f = code >= fs, then
  // (local row) * nx + column; its node is global value e
  auto elem = [&](int code, int f) { return code - f * fs + f * n + (r0 - 1) * nx; };
  // the tree owner's slot of value e (fused_gmres.cuh, "Ownership")
  auto tree_slot = [&](int e, int& owner) {
    const int piece = e >> 2;
    owner = piece & nbm;
    return ((piece >> log_nb) << 2) | (e & 3);
  };
  auto taps = [&](int code, double (&u)[18]) {
#pragma unroll
    for (int t = 0; t < 18; ++t) {
      const int q = t % 9;
      u[t] = xs[(t / 9) * fs + code - (code >= fs ? fs : 0) + (q / 3 - 1) * nx + (q % 3 - 1)];
    }
  };
  // b - A x at the row, from its taps
  auto chain = [&](int code, int f, const double (&u)[18]) {
    double acc = 0.0;
#pragma unroll
    for (int t = 0; t < 18; ++t) acc = __dadd_rn(acc, __dmul_rn(ws[f][t], u[t]));
    return __dsub_rn(bs[code - nx - 2 * nx * f], acc);
  };
  auto store_residual = [&](int code, int f, double r) {
    int owner;
    const int slot = tree_slot(elem(code, f), owner);
    *cluster.map_shared_rank(rt + slot, owner) = r;
  };
  // the residual of every own row into its tree slot, the loads of two rows
  // issued before their chains, rows in the slab's order (a warp's threads
  // on consecutive columns); then ||b - A x||
  auto norm = [&]() {
    const int cols = nx - 2, per_field = rows * cols, total = 2 * per_field;
    auto code_of = [&](int k) {
      const int f = k >= per_field ? 1 : 0, t = k - f * per_field, l = t / cols;
      return f * fs + (l + 1) * nx + 1 + t - l * cols;
    };
    for (int k = tid; k < total; k += 2 * kGmresThreads) {
      const int k2 = k + kGmresThreads < total ? k + kGmresThreads : k;
      const int c1 = code_of(k), c2 = code_of(k2);
      double u1[18], u2[18];
      taps(c1, u1);
      taps(c2, u2);
      const int f1 = c1 >= fs ? 1 : 0, f2 = c2 >= fs ? 1 : 0;
      const double v1 = chain(c1, f1, u1), v2 = chain(c2, f2, u2);
      store_residual(c1, f1, v1);
      if (k2 != k) store_residual(c2, f2, v2);
    }
    mark(kNgsNormRows);
    cluster.sync();  // every residual in its tree slot
    mark(kNgsSquares);
    cluster_square_tree(cluster, o, rt, L, part, xpart, scal);
    mark(kNgsTree);
    return __dsqrt_rn(scal[0]);
  };

  const double f0 = norm();
  const double rel_tol = __dmul_rn(rtol, f0);
  const double tol = atol > rel_tol ? atol : rel_tol;  // Python's max(rtol * f0, atol)
  double fn = f0;
  int its = 0, q = 0;  // q: colour phases so far, which picks the mbarrier and its parity
  while (fn > tol && its < max_it) {
    for (int c = 0; c < ncolors; ++c, ++q) {
      uint64_t* const bq = bar + (q & 1);
      for (int k = cptr[c] + tid; k < cptr[c + 1]; k += kGmresThreads) {
        const int code = list[k], f = code >= fs ? 1 : 0;
        double r;
        if (c == 0) {
          int owner;
          const int slot = tree_slot(elem(code, f), owner);
          r = *cluster.map_shared_rank(rt + slot, owner);
        } else {
          double u[18];
          taps(code, u);
          r = chain(code, f, u);
        }
        const double v = __dadd_rn(xs[code], __ddiv_rn(r, dg[f]));
        xs[code] = v;
        const int t = code - f * fs;  // (local row) * nx + column
        if (down && t < 2 * nx) push(xs + code + rows_below * nx, v, o.b - 1, bq);
        if (up && t >= rows * nx) push(xs + code - rows * nx, v, o.b + 1, bq);
      }
      mark(kNgsRows);
      __syncthreads();  // the block's rows of this colour read and written
      if (nb > 1) {
        if (tid == 0) {
          if (down) arrive_remote(bq, o.b - 1, 8 * sends[c][0]);
          if (up) arrive_remote(bq, o.b + 1, 8 * sends[c][1]);
        }
        wait_parity(bq, (q >> 1) & 1);
      }
      mark(kNgsHalo);
    }
    fn = norm();
    ++its;
  }
  // x: the own rows' interior values; the boundary from the lift
  for (int k = tid; k < 2 * rows * nx; k += kGmresThreads) {
    const int f = k / (rows * nx), t = k - f * rows * nx, i = t % nx, e = f * n + r0 * nx + t;
    x[e] = i == 0 || i == nx - 1 ? x0[e] : xs[f * fs + nx + t];
  }
  for (int k = tid; k < 2 * nx; k += kGmresThreads) {
    const int f = k / nx, i = k - f * nx;
    if (o.b == 0) x[f * n + i] = x0[f * n + i];
    if (o.b == nbm) x[f * n + (ny - 1) * nx + i] = x0[f * n + (ny - 1) * nx + i];
  }
  if (o.b == 0 && tid == 0) {
    result[0] = (double)its;
    result[1] = fn;
    result[2] = f0;
    result[3] = (double)nb;
    result[4] = (double)geom.rows;
    result[5] = (double)(1 << geom.log_s);
    result[6] = (double)geom.bytes;
  }
#ifdef PERPHIL_NGS_PROFILE
  if (clocked) {
    for (int k = 0; k < kNgsPhases; ++k) atomicAdd(ngs_prof + k, (unsigned long long)clk[k]);
  }
#endif
  cluster.sync();  // no block leaves while another may still reach its shared memory
}

}  // namespace perphil

// b, x0, x: (2, ny, nx) f64 (b the lifted right-hand side, x0 the BC lift, x
// out); lists: (nb, width) uint16, per block its interior rows' offsets in
// its slab sorted by colour; cptr: (nb, ncolors + 1) int32, each block's
// colour bounds in its list; sends: (nb, ncolors, 2) int32, the values of
// each colour a block pushes to the block below and above; result:
// kNgsResultSlots f64 [iterations, fn, f0, blocks, rows, leaves a thread,
// dynamic bytes]; weights: 38 host doubles (NgsWeights). blocks (0: the
// launcher's rule), rows, nloc and width: the host's plan, which must be the
// launcher's.
extern "C" int perphil_fused_ngs(const double* b, const double* x0, double* x, const uint16_t* lists,
                                 const int* cptr, const int* sends, double* result,
                                 const double* weights, int ny, int nx, int ncolors, double rtol, double atol,
                                 int max_it, int blocks, int rows, int nloc, int width, void* stream) {
  using namespace perphil;
  NgsGeom geo;
  if (max_it < 0 || !ngs_geometry(ny, nx, ncolors, blocks, geo) || geo.rows != rows || geo.nloc != nloc ||
      geo.width != width) {
    return (int)cudaErrorInvalidValue;
  }
  NgsWeights w;
  for (int t = 0; t < 18; ++t) {
    w.w[0][t] = weights[t];
    w.w[1][t] = weights[18 + t];
  }
  w.diag[0] = weights[36];
  w.diag[1] = weights[37];
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, fused_ngs_kernel);
  if (err != cudaSuccess) return (int)err;
  // the plan's budget is the host's; a kernel that leaves less refuses
  if (kMaxSmemPerBlock - (long)fa.sharedSizeBytes < kNgsSmemBudget) return (int)cudaErrorLaunchOutOfResources;
  err = cudaFuncSetAttribute(fused_ngs_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fused_ngs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.bytes);
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
  err = cudaLaunchKernelEx(&cfg, fused_ngs_kernel, b, x0, x, lists, cptr, sends, result, w, nx, ny,
                           ncolors, rtol, atol, max_it, geo);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

#ifdef PERPHIL_NGS_PROFILE
// Copies the phase counters (NgsPhase, cycles summed over the launches since
// the last take) to `out` on the host, then zeroes them.
extern "C" int perphil_fused_ngs_profile_take(unsigned long long* out) {
  const unsigned long long zero[perphil::kNgsPhases] = {};
  cudaError_t err = cudaMemcpyFromSymbol(out, perphil::ngs_prof, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(perphil::ngs_prof, zero, sizeof(zero));
  return (int)err;
}
#endif
