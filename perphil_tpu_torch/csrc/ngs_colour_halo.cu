// ngs_colour_halo: the blocked Picard iteration of the pinned-colouring SNES
// ngs solve on the blocks of a 2D quad grid that one process holds
// (ops/fused_ngs.py::NgsSweep; the sharded Picard solve,
// parallel/sharding.py), with no round trip to the host inside an
// iteration.
//
// Replaces no Pallas kernel: in the JAX package the sharded Picard solve is
// the single-device XLA sweeper (ColoredNGSSweeper.sweep,
// perphil_tpu/ops/ilu.py:924) that XLA's partitioner runs on every device,
// with a halo exchange a sweep (perphil_tpu/parallel/sharding.py:222-240).
//
// The kernels:
//   ngs_colour_step_kernel  one colour step of every block the process
//     holds, in one launch: a thread a row of the colour, from one int32
//     list of the colour's rows over all blocks (part, field, j, i packed);
//   ngs_norm_rows_kernel, ngs_norm_tree_kernel  the norm, two dependent
//     launches: every row's residual squared into a scratch in natural
//     order, then each block's sum of squares in krylov.tree_sum's order,
//     the blocks' sums added in coordinate order (LoopbackBlocks.total), the
//     correctly rounded square root and the SNES stop test, all on the card;
//   ngs_finish_kernel  the root and stop test alone, after the blocks'
//     total was all-reduced over the ranks (a world with peers).
//
// What a step computes is colour_step_plain bit for bit, and so
// ColoredNGSSweeper.residual's rows: a row of field f at an interior node:
// b - (0.0 + w[f][f' * 9 + q] * x[f', node + offset q] over field 0's nine
// taps then field 1's), each product and sum rounded on its own (__dmul_rn /
// __dadd_rn: nvcc would contract them into FMAs), a neighbour on the grid's
// boundary reading 0.0; a boundary (or phantom) row: b - x; then
// x + r / d (__ddiv_rn; d the field's diagonal, 1 on a boundary row) in
// place. No row of a colour reads another row of that colour (the
// colouring is distance-1 on the monolithic pattern), so the rows a step
// reads are never written in the launch, in any block.
//
// The blocks' table (NgsPart, built once on the host, in device memory):
// each block's x and b, and for each of its eight neighbour directions the
// source of its ghost values: the neighbour block's own x where that block
// is in this process (no plane is built), or a fixed receive buffer where it
// is on another rank; and for such a neighbour a fixed send buffer, which
// the step that writes a block's edge rows writes too (corners included), so
// that the exchange sends it with no copy. A ghost at local (j, i) in
// direction d reads src[d].ptr + 8 * (g * fs + j * rs + i * cs). What every
// row reads of the table (x, b, offsets, the norm's CTAs) goes in as a
// kernel parameter (NgsBlocks, from the host's copy of the table), so that
// a row's loads wait only on its code.
//
// Each colour's list holds its interior rows first (every tap in the block,
// none on the boundary: straight loads at fixed offsets, no branch), then
// its edge rows (boundary rows, and rows with a tap outside the block or on
// the boundary: the general path), split once on the host.
//
// The stop test (the host's picard_loop): f0 = ||r0||, tol = rtol * f0 if
// that is > atol else atol, then while fn > tol and its < max_it an
// iteration. The state (kState* slots, f64) holds done, its, f0, fn, tol,
// the blocks' total, rtol, atol and max_it. Every launch reads done first
// and returns once it is set, so iterations queued past the stop change no
// bit and no count; the host reads (done, its, fn) back every k iterations.
//
// The norm's order: for a block of n values (both fields, flat), the
// halving tree of krylov.tree_sum over the squares zero-padded to L, a
// power of two at least n (more zero padding changes no sum of squares).
// The tree combines index bit log2(L) - 1 first and bit 0 last, so with L =
// K * 256 * G (ops/fused_ngs.py::norm_geometry): a tree thread's K leaves
// are the top bits, a CTA's 256 threads the next eight, the block's G CTAs
// the low bits, last. A leaf's row is no thread's choice, though: the rows
// stage computes row e on thread e of the block's rows in natural order, so
// that a warp reads 32 consecutive rows' x and b, and writes the square to
// the block's L squares (the padding past n is never read: the tree takes
// 0 there). The tree stage's thread t of CTA b then reads its leaves t * G
// + b + k * 256 G, one 8-byte load each, sums them (the top bits first),
// stores once to shared memory, and after the one barrier warp 0 runs the
// CTA's levels: t + 128, t + 64, t + 32 in registers, t + 16 ... t + 1 by
// shuffles. The tail: each CTA's thread 0 arrives on one counter
// (acquire-release); the last CTA's warps make the blocks' trees over
// their partials side by side, and one thread adds the blocks' sums in
// order and runs the stop test, its state loaded ahead. So the tail is one
// arrival and three barriers in the last CTA, whatever the blocks. The two
// stages are programmatic dependent launches: the tree's CTAs take their
// places while the rows run and wait on them (griddepcontrol), so the
// second launch costs little. What bounds it: the norm reads every row's
// neighbourhood (~800 KB at 2D N=128 on one block, L2-resident) and the
// squares once, so it is latency: a launch, a row's loads, the tree's one
// load a leaf, a barrier, the arrival and the tail's dependent adds. The
// design takes the host out of the iteration, so that k iterations run
// queued or from a CUDA graph.

#include <cuda_runtime.h>

namespace perphil {

constexpr int kColourThreads = 32;  // one warp a CTA: a colour's rows over as many SMs as it fills
constexpr int kNormThreads = 256;
// the most blocks one process's table holds (5 bits of a row's code)
constexpr int kNgsMaxParts = 32;
// the largest local extent (13 bits of a row's code)
constexpr int kNgsMaxExtent = 8191;
// the most leaves a norm thread sums (its stack holds log2 of it + 1)
constexpr int kNgsMaxLeaves = 128;
// state slots
constexpr int kStateDone = 0, kStateIts = 1, kStateF0 = 2, kStateFn = 3, kStateTol = 4, kStateTotal = 5,
              kStateRtol = 6, kStateAtol = 7, kStateMaxIt = 8;
constexpr int kNgsStateSlots = 16;

struct NgsSide {
  long long ptr, fs, rs, cs;  // address (0: none) and element strides of field, row, column
};

// one block of the table: every field a 64-bit integer, so that the host
// builds it as an int64 array (ops/fused_ngs.py::NgsSweep, PART_WORDS)
struct NgsPart {
  long long x, b;
  NgsSide src[9];  // ghost sources by direction (sy + 1) * 3 + (sx + 1); [4] unused
  NgsSide snd[9];  // send buffers, for a neighbour on another rank
  long long ly, lx, oy, ox;
  long long cta0, ctas, leaves;  // the norm's first CTA, CTAs and leaves a thread
  long long r;                   // the norm's residual output (0: none; for checks)
};

struct NgsWeights {
  double w[2][18];  // per row field: field 0's nine taps, then field 1's
  double diag[2];   // the interior rows' diagonals
};

// what every thread reads of the blocks, as a kernel parameter (the
// constant cache), so that a row's loads wait only on its code: the table's
// x, b, offsets, the norm's CTAs and residual outputs, and the extents
struct NgsBlocks {
  long long x[kNgsMaxParts], b[kNgsMaxParts], r[kNgsMaxParts];
  int oy[kNgsMaxParts], ox[kNgsMaxParts], cta0[kNgsMaxParts], ctas[kNgsMaxParts], leaves[kNgsMaxParts];
  int nparts, ly, lx, ny, nx;
};

__device__ __forceinline__ bool on_boundary(int gj, int gi, int ny, int nx) {
  return gj <= 0 || gj >= ny - 1 || gi <= 0 || gi >= nx - 1;
}

__device__ __forceinline__ double weight(const NgsWeights& cw, int f, int q) {
  return f ? cw.w[1][q] : cw.w[0][q];
}

// x of field g at local (j, i), j in [-1, ly], i in [-1, lx]: the block, or
// the source of its direction (the table's)
__device__ __forceinline__ double load(const NgsPart& p, const double* x, int g, int j, int i, int ly, int lx) {
  const int sy = j < 0 ? 0 : (j >= ly ? 2 : 1);
  const int sx = i < 0 ? 0 : (i >= lx ? 2 : 1);
  const int d = sy * 3 + sx;
  if (d == 4) return x[(g * ly + j) * lx + i];
  const NgsSide s = p.src[d];
  if (!s.ptr) return 0.0;  // no neighbour: only a boundary tap lies there, and it is never read
  return *reinterpret_cast<const double*>(s.ptr + 8LL * (g * s.fs + j * s.rs + i * s.cs));
}

// the sum of a row's 18 products, each tap in the block and off the
// boundary: straight loads at fixed offsets
__device__ __forceinline__ double straight_sum(const NgsWeights& cw, const double* x, int f, int j, int i, int lx,
                                               int n) {
  const double* c = x + j * lx + i;
  double u[18];
#pragma unroll
  for (int q = 0; q < 18; ++q) {
    const int g = q / 9, dy = (q % 9) / 3 - 1, dx = q % 3 - 1;
    u[q] = c[g * n + dy * lx + dx];
  }
  double acc = 0.0;
#pragma unroll
  for (int q = 0; q < 18; ++q) acc = __dadd_rn(acc, __dmul_rn(weight(cw, f, q), u[q]));
  return acc;
}

// the residual of row (f, j, i) of block pi; bdry: whether it is a boundary
// (or phantom) row
__device__ __forceinline__ double row_residual(const NgsPart* parts, const NgsBlocks& k, const NgsWeights& cw,
                                               int pi, int f, int j, int i, bool& bdry) {
  const int ly = k.ly, lx = k.lx, n = ly * lx, e = f * n + j * lx + i;
  const double* x = reinterpret_cast<const double*>(k.x[pi]);
  const double* b = reinterpret_cast<const double*>(k.b[pi]);
  const int gj = k.oy[pi] + j, gi = k.ox[pi] + i;
  bdry = on_boundary(gj, gi, k.ny, k.nx);
  if (bdry) return __dsub_rn(b[e], x[e]);
  double acc;
  if (j >= 1 && j <= ly - 2 && i >= 1 && i <= lx - 2 && gj >= 2 && gj <= k.ny - 3 && gi >= 2 && gi <= k.nx - 3) {
    acc = straight_sum(cw, x, f, j, i, lx, n);
  } else {
    // every tap loaded before the first sum, so that the loads are in
    // flight together (in order, a sum waiting on its load would hold up
    // the next tap's)
    const NgsPart& p = parts[pi];
    double u[18];
#pragma unroll
    for (int q = 0; q < 18; ++q) {
      const int g = q / 9, dy = (q % 9) / 3 - 1, dx = q % 3 - 1;
      u[q] = on_boundary(gj + dy, gi + dx, k.ny, k.nx) ? 0.0 : load(p, x, g, j + dy, i + dx, ly, lx);
    }
    acc = 0.0;
#pragma unroll
    for (int q = 0; q < 18; ++q) acc = __dadd_rn(acc, __dmul_rn(weight(cw, f, q), u[q]));
  }
  return __dsub_rn(b[e], acc);
}

// Measurement builds (tools/profile_kernels.py --only ngs-blocked; timed
// only, their results are wrong): PERPHIL_NGS_EMPTY_STEP returns at once,
// PERPHIL_NGS_NO_TAPS takes b - x for every row, PERPHIL_NGS_NO_DIVIDE
// multiplies for the divide, PERPHIL_NGS_BARE does both.
#ifdef PERPHIL_NGS_BARE
#define PERPHIL_NGS_NO_TAPS
#define PERPHIL_NGS_NO_DIVIDE
#endif

// rows [start, end) of the colour's list: [start, edge) interior, [edge,
// end) edge rows. Every load waits only on the row's code; done guards the
// stores.
__global__ void __launch_bounds__(kColourThreads)
    ngs_colour_step_kernel(const NgsPart* __restrict__ parts, NgsBlocks k, const unsigned* __restrict__ rows,
                           int start, int edge, int end, NgsWeights cw, const double* __restrict__ state) {
  const int t = start + blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= end) return;
#ifdef PERPHIL_NGS_EMPTY_STEP
  return;
#endif
  const unsigned code = rows[t];
  const double done = state[kStateDone];
  const int pi = code >> 27, f = (code >> 26) & 1, j = (code >> 13) & 8191, i = code & 8191;
  const int lx = k.lx, n = k.ly * lx, e = f * n + j * lx + i;
  double* x = reinterpret_cast<double*>(k.x[pi]);
  const double* b = reinterpret_cast<const double*>(k.b[pi]);
  const double xv = x[e];
  double r;
  bool bdry = false;
#ifdef PERPHIL_NGS_NO_TAPS
  r = __dsub_rn(b[e], xv);
#else
  if (t < edge) {
    r = __dsub_rn(b[e], straight_sum(cw, x, f, j, i, lx, n));
  } else {
    r = row_residual(parts, k, cw, pi, f, j, i, bdry);
  }
#endif
#ifdef PERPHIL_NGS_NO_DIVIDE
  const double xn = __dadd_rn(xv, __dmul_rn(r, bdry ? 1.0 : cw.diag[f]));
#else
  const double xn = __dadd_rn(xv, __ddiv_rn(r, bdry ? 1.0 : cw.diag[f]));
#endif
  if (done != 0.0) return;
  x[e] = xn;
  if (t < edge) return;
  // an edge row: into the send buffer of every remote neighbour it borders
  const NgsPart& p = parts[pi];
#pragma unroll
  for (int d = 0; d < 9; ++d) {
    if (d == 4) continue;
    const NgsSide s = p.snd[d];
    if (!s.ptr) continue;
    const int sy = d / 3 - 1, sx = d % 3 - 1;
    if ((sy < 0 && j != 0) || (sy > 0 && j != k.ly - 1) || (sx < 0 && i != 0) || (sx > 0 && i != lx - 1)) continue;
    *reinterpret_cast<double*>(s.ptr + 8LL * (f * s.fs + j * s.rs + i * s.cs)) = xn;
  }
}

// what the stop test reads of the state, loaded ahead of the total
struct NgsStop {
  double rtol, atol, tol, its, max_it;
};

__device__ __forceinline__ NgsStop stop_of(const double* state) {
  return NgsStop{state[kStateRtol], state[kStateAtol], state[kStateTol], state[kStateIts], state[kStateMaxIt]};
}

// the root and the stop test on the total ``total`` of the squares over
// every block (one thread; st: the state's stop values)
__device__ __forceinline__ void finish(double* state, double total, int init, const NgsStop& st) {
  const double fn = __dsqrt_rn(total);
  double its, tol;
  if (init) {
    const double rel = __dmul_rn(st.rtol, fn);
    tol = rel > st.atol ? rel : st.atol;  // Python's max(rtol * f0, atol)
    state[kStateF0] = fn;
    state[kStateTol] = tol;
    its = 0.0;
  } else {
    tol = st.tol;
    its = st.its + 1.0;
  }
  state[kStateFn] = fn;
  state[kStateIts] = its;
  state[kStateDone] = (fn > tol && its < st.max_it) ? 0.0 : 1.0;
}

__device__ __forceinline__ void finish(double* state, double total, int init) {
  finish(state, total, init, stop_of(state));
}

// Measurement builds of the norm (tools/profile_kernels.py --only
// ngs-blocked), parts skipped, timed only (their results are wrong):
// PERPHIL_NGS_NORM_EMPTY returns at once from both stages (the launches),
// PERPHIL_NGS_NORM_NO_ROWS from the rows stage, PERPHIL_NGS_NORM_NO_TAPS
// takes b - x for every row, PERPHIL_NGS_NORM_NO_TAIL stops each CTA once
// its partial is written.
#ifdef PERPHIL_NGS_NORM_EMPTY
#define PERPHIL_NGS_NORM_NO_ROWS
#endif

// programmatic dependent launch: wait for the grid this one depends on (its
// writes visible), and let the grid that depends on this one launch now
__device__ __forceinline__ void wait_on_prior_grid() { asm volatile("griddepcontrol.wait;" ::: "memory"); }
__device__ __forceinline__ void launch_dependent_grid() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// one arrival on a counter, its old value: release of this thread's writes
// before it, acquire of the others' released writes after it
__device__ __forceinline__ unsigned arrive(unsigned* counter) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;" : "=r"(old) : "l"(counter) : "memory");
  return old;
}

// rows [c * 256, c * 256 + 256) of block pi (chunk = pi * chunks + c) in
// natural order, field-major: a thread a row, so that a warp's loads of x
// and b are consecutive; the residual into the block's output (where set)
// and its square into the block's L squares at sq + pi * L. A row whose
// taps all lie in the block loads them together, a tap on the grid's
// boundary masked to 0.0: row_residual's straight and general paths, the
// same sums, with no read of the table; a boundary row and a row with a tap
// in a neighbour's block take row_residual. done guards the stores.
__device__ __forceinline__ void norm_rows(const NgsPart* parts, const NgsBlocks& k, const NgsWeights& cw, double done,
                                          double* sq, long long L, int chunk, int chunks) {
  const int pi = chunk / chunks, lx = k.lx, nf = k.ly * lx;
  const int e = (chunk - pi * chunks) * kNormThreads + threadIdx.x;
  if (e >= 2 * nf) return;
  const int f = e >= nf, rem = e - f * nf, j = rem / lx, i = rem - j * lx;
  double r;
  bool bdry;
#ifdef PERPHIL_NGS_NORM_NO_TAPS
  r = __dsub_rn(reinterpret_cast<const double*>(k.b[pi])[e], reinterpret_cast<const double*>(k.x[pi])[e]);
#else
  const int gj = k.oy[pi] + j, gi = k.ox[pi] + i;
  if (j >= 1 && j <= k.ly - 2 && i >= 1 && i <= lx - 2 && !on_boundary(gj, gi, k.ny, k.nx)) {
    const double* c = reinterpret_cast<const double*>(k.x[pi]) + j * lx + i;
    double u[18];
#pragma unroll
    for (int q = 0; q < 18; ++q) {
      const int g = q / 9, dy = (q % 9) / 3 - 1, dx = q % 3 - 1;
      const double v = c[g * nf + dy * lx + dx];
      u[q] = on_boundary(gj + dy, gi + dx, k.ny, k.nx) ? 0.0 : v;
    }
    double acc = 0.0;
#pragma unroll
    for (int q = 0; q < 18; ++q) acc = __dadd_rn(acc, __dmul_rn(weight(cw, f, q), u[q]));
    r = __dsub_rn(reinterpret_cast<const double*>(k.b[pi])[e], acc);
  } else {
    r = row_residual(parts, k, cw, pi, f, j, i, bdry);
  }
#endif
  if (done != 0.0) return;
  double* rout = reinterpret_cast<double*>(k.r[pi]);
  if (rout) rout[e] = r;
  sq[pi * L + e] = __dmul_rn(r, r);
}

// the halving tree over v[l + 32 m] (lane l's v[m], m < 8) of a warp's 32
// lanes: the three cross-warp levels (t with t + 128, t + 64, t + 32) in
// registers, then the five lane levels by shuffles (lane l adds lane l + w:
// s[t] + s[t + w] exactly); lane 0 ends with the sum
__device__ __forceinline__ double warp_tree(const double (&v)[8]) {
  const double a0 = __dadd_rn(v[0], v[4]), a1 = __dadd_rn(v[1], v[5]);
  const double a2 = __dadd_rn(v[2], v[6]), a3 = __dadd_rn(v[3], v[7]);
  double s = __dadd_rn(__dadd_rn(a0, a2), __dadd_rn(a1, a3));
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1) s = __dadd_rn(s, __shfl_down_sync(0xffffffffu, s, w));
  return s;
}

// block q's tree over its G partials (a power of two up to 256,
// zero-padded) by one warp, lane l reading partials l + 32 m; lane 0's sum
__device__ __forceinline__ double block_tree(const NgsBlocks& k, const double* partials, int q, int l) {
  const int g0 = k.cta0[q], G = k.ctas[q];
  double v[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) v[m] = l + 32 * m < G ? __ldcg(partials + g0 + l + 32 * m) : 0.0;
  return warp_tree(v);
}

// the stop test on the blocks' total, or the total left for the all-reduce
__device__ __forceinline__ void conclude(double* state, double total, int init, int local, const NgsStop& st) {
  if (local) {
    finish(state, total, init, st);
  } else {
    state[kStateTotal] = total;
  }
}

// CTA cta of the tree stage: block pi's CTA cb of G, thread t of 256 sums
// its K leaves t * G + cb + k * 256 G of the block's squares (e < n; the
// padding reads as 0) in the tree's order (k and k + K/2 first: a binary
// counter over k bit-reversed); one barrier, then warp 0 the CTA's tree
// (warp_tree) into partials[cta]. The tail: thread 0 arrives on the
// launch's counter (arrivals[0]); one more barrier tells the CTA's warps
// whether it was the last; the last CTA's warp w makes the trees of blocks
// w, w + 8, ... over their partials (block_tree), and after a third barrier
// thread 0 adds the blocks' sums in coordinate order, resets the counter
// and runs the stop test (local) or leaves the total for the all-reduce.
__device__ __forceinline__ void norm_tree(const NgsBlocks& k, double* state, const double* sq, double* partials,
                                          unsigned* arrivals, long long L, int cta, int init, int local) {
  __shared__ double s[kNormThreads];
  __shared__ double block_sums[kNgsMaxParts];
  __shared__ unsigned last;
  int pi = 0;
  while (pi + 1 < k.nparts && cta >= k.cta0[pi + 1]) ++pi;
  const int G = k.ctas[pi], K = k.leaves[pi], cb = cta - k.cta0[pi], t = threadIdx.x;
  const long long n = 2LL * k.ly * k.lx, stride = static_cast<long long>(G) * kNormThreads;
  const double* q = sq + pi * L;
  const NgsStop st = stop_of(state);  // in flight with the leaves: used by the last CTA's thread 0
  const int logK = 31 - __clz(K);
  double stack[8];
  int depth = 0;
  for (int m = 0; m < K; ++m) {
    const int kk = logK ? static_cast<int>(__brev(static_cast<unsigned>(m)) >> (32 - logK)) : 0;
    const long long e = static_cast<long long>(t) * G + cb + kk * stride;
    double v = e < n ? __ldcg(q + e) : 0.0;
    for (int z = m; z & 1; z >>= 1) v = __dadd_rn(stack[--depth], v);
    stack[depth++] = v;
  }
  s[t] = stack[0];
  __syncthreads();
  if (t < 32) {
    double v[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) v[m] = s[t + 32 * m];
    const double part = warp_tree(v);
#ifdef PERPHIL_NGS_NORM_NO_TAIL
    if (t == 0) partials[cta] = part;
#else
    if (t == 0) {
      partials[cta] = part;
      last = arrive(arrivals) == static_cast<unsigned>(k.cta0[k.nparts - 1] + k.ctas[k.nparts - 1] - 1);
    }
#endif
  }
#ifdef PERPHIL_NGS_NORM_NO_TAIL
  return;
#endif
  __syncthreads();
  if (!last) return;
  for (int p = t >> 5; p < k.nparts; p += kNormThreads / 32) {
    const double sum = block_tree(k, partials, p, t & 31);
    if ((t & 31) == 0) block_sums[p] = sum;
  }
  __syncthreads();
  if (t != 0) return;
  double total = block_sums[0];
  for (int p = 1; p < k.nparts; ++p) total = __dadd_rn(total, block_sums[p]);
  arrivals[0] = 0u;
  conclude(state, total, init, local, st);
}

__global__ void __launch_bounds__(kNormThreads)
    ngs_norm_rows_kernel(const NgsPart* __restrict__ parts, NgsBlocks k, NgsWeights cw, const double* state,
                         double* sq, long long L, int chunks) {
  launch_dependent_grid();  // the tree stage's CTAs may take their places and wait
  wait_on_prior_grid();     // the last colour step's x
#ifdef PERPHIL_NGS_NORM_NO_ROWS
  return;
#endif
  norm_rows(parts, k, cw, state[kStateDone], sq, L, blockIdx.x, chunks);
}

__global__ void __launch_bounds__(kNormThreads)
    ngs_norm_tree_kernel(NgsBlocks k, double* state, const double* sq, double* partials, unsigned* arrivals,
                         long long L, int init, int local) {
  wait_on_prior_grid();  // the rows stage's squares
#ifdef PERPHIL_NGS_NORM_EMPTY
  return;
#endif
  if (state[kStateDone] != 0.0) return;
  norm_tree(k, state, sq, partials, arrivals, L, blockIdx.x, init, local);
}

__global__ void ngs_finish_kernel(double* state, int init) {
  if (state[kStateDone] != 0.0) return;
  finish(state, state[kStateTotal], init);
}

static NgsWeights weights_of(const double* weights) {
  NgsWeights cw;
  for (int f = 0; f < 2; ++f) {
    for (int q = 0; q < 18; ++q) cw.w[f][q] = weights[f * 18 + q];
    cw.diag[f] = weights[36 + f];
  }
  return cw;
}

// the kernels' parameter from the host's copy of the table (``words``,
// nparts NgsPart of int64 words); false where it does not fit
static bool blocks_of(const long long* words, int nparts, int ny, int nx, NgsBlocks& k) {
  constexpr int kWords = sizeof(NgsPart) / sizeof(long long);
  if (!words || nparts < 1 || nparts > kNgsMaxParts || ny < 3 || nx < 3) return false;
  const NgsPart* p = reinterpret_cast<const NgsPart*>(words);
  static_assert(sizeof(NgsPart) == kWords * sizeof(long long), "NgsPart is int64 words");
  k.nparts = nparts;
  k.ly = static_cast<int>(p[0].ly);
  k.lx = static_cast<int>(p[0].lx);
  k.ny = ny;
  k.nx = nx;
  if (k.ly < 1 || k.lx < 1 || k.ly > kNgsMaxExtent || k.lx > kNgsMaxExtent) return false;
  for (int q = 0; q < nparts; ++q) {
    if (p[q].ly != k.ly || p[q].lx != k.lx || p[q].leaves < 1 || p[q].leaves > kNgsMaxLeaves) return false;
    k.x[q] = p[q].x;
    k.b[q] = p[q].b;
    k.r[q] = p[q].r;
    k.oy[q] = static_cast<int>(p[q].oy);
    k.ox[q] = static_cast<int>(p[q].ox);
    k.cta0[q] = static_cast<int>(p[q].cta0);
    k.ctas[q] = static_cast<int>(p[q].ctas);
    k.leaves[q] = static_cast<int>(p[q].leaves);
  }
  return true;
}

}  // namespace perphil

// parts (device, the table), words (host, its copy), nparts, rows (device,
// the colours' lists), start, edge, end (the colour's span), weights (host,
// 38 doubles: 2 x 18 taps, 2 diagonals), ny, nx (the physical grid), state
// (device), stream
extern "C" int perphil_ngs_colour_step(const void* parts, const long long* words, int nparts, const unsigned* rows,
                                       int start, int edge, int end, const double* weights, int ny, int nx,
                                       const double* state, void* stream) {
  using namespace perphil;
  NgsBlocks k;
  if (!parts || !rows || !state || start < 0 || edge < start || end < edge || !blocks_of(words, nparts, ny, nx, k)) {
    return (int)cudaErrorInvalidValue;
  }
  if (end == start) return (int)cudaSuccess;  // a colour with no row in any block
  const int grid = (end - start + kColourThreads - 1) / kColourThreads;
  ngs_colour_step_kernel<<<grid, kColourThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const NgsPart*>(parts), k, rows, start, edge, end, weights_of(weights), state);
  return (int)cudaGetLastError();
}

// parts, words, nparts, ctas (the tree's CTAs over every block: the table's
// cta0 runs over them in order, every block the same count and leaves),
// weights (host), ny, nx, state, work (nparts * L squares, L = ctas a block
// * 256 * leaves, then ctas partials), arrivals (one unsigned, 0 between
// launches), init (1: the first norm, f0 and tol), local (1: the root and
// stop test here; 0: the blocks' total left in the state for an all-reduce
// and ngs_finish_kernel), stream. Two
// launches, each a programmatic dependent launch: the rows (ceil(n / 256)
// CTAs a block), then the tree and the tail.
extern "C" int perphil_ngs_norm(const void* parts, const long long* words, int nparts, int ctas,
                                const double* weights, int ny, int nx, double* state, double* work,
                                unsigned* arrivals, int init, int local, void* stream) {
  using namespace perphil;
  NgsBlocks k;
  if (!parts || !state || !work || !arrivals || ctas < nparts || !blocks_of(words, nparts, ny, nx, k)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n = 2LL * k.ly * k.lx, L = static_cast<long long>(k.ctas[0]) * kNormThreads * k.leaves[0];
  int cta0 = 0;
  for (int q = 0; q < nparts; ++q) {
    if (k.ctas[q] != k.ctas[0] || k.leaves[q] != k.leaves[0] || k.cta0[q] != cta0 || k.ctas[q] > kNormThreads) {
      return (int)cudaErrorInvalidValue;
    }
    cta0 += k.ctas[q];
  }
  if (cta0 != ctas || L < n) return (int)cudaErrorInvalidValue;
  const int chunks = static_cast<int>((n + kNormThreads - 1) / kNormThreads), row_ctas = nparts * chunks;
  double* partials = work + nparts * L;
  const NgsWeights cw = weights_of(weights);
  const NgsPart* p = static_cast<const NgsPart*>(parts);
  cudaLaunchConfig_t cfg{};
  cfg.blockDim = dim3(kNormThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.gridDim = dim3(row_ctas);
  cudaError_t err = cudaLaunchKernelEx(&cfg, ngs_norm_rows_kernel, p, k, cw, static_cast<const double*>(state), work,
                                       L, chunks);
  if (err != cudaSuccess) return (int)err;
  cfg.gridDim = dim3(ctas);
  err = cudaLaunchKernelEx(&cfg, ngs_norm_tree_kernel, k, state, static_cast<const double*>(work), partials,
                           arrivals, L, init, local);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// state, init, stream
extern "C" int perphil_ngs_finish(double* state, int init, void* stream) {
  using namespace perphil;
  if (!state) return (int)cudaErrorInvalidValue;
  ngs_finish_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(state, init);
  return (int)cudaGetLastError();
}
