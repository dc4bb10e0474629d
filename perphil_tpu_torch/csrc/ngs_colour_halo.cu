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
// Two kernels and a small third:
//   ngs_colour_step_kernel  one colour step of every block the process
//     holds, in one launch: a thread a row of the colour, from one int32
//     list of the colour's rows over all blocks (part, field, j, i packed);
//   ngs_norm_kernel  every row's residual squared and summed, a block at a
//     time, in krylov.tree_sum's order, the blocks' sums added in
//     coordinate order (LoopbackBlocks.total), the correctly rounded square
//     root and the SNES stop test, all on the card;
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
// CTA b of the block's G, thread t of 256, owns the residue r = t * G + b
// and the K = L / (256 G) leaves r + k * 256 G: it sums them in the tree's
// order (the top bits of the index first), the CTA then over t by halving
// in shared memory, and the last CTA of the launch to arrive over b, block
// by block, and the blocks in order. What bounds it: a step reads the
// colour's rows' neighbourhoods and writes its rows (~256 KB at 2D N=128
// on one block, L2-resident), so it is latency: the launch, the row's code,
// its taps (all loaded before the first sum), the divide, the store. The
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

// the root and the stop test on the total ``total`` of the squares over
// every block (one thread)
__device__ __forceinline__ void finish(double* state, double total, int init) {
  const double fn = __dsqrt_rn(total);
  double its, tol;
  if (init) {
    const double rel = __dmul_rn(state[kStateRtol], fn);
    tol = rel > state[kStateAtol] ? rel : state[kStateAtol];  // Python's max(rtol * f0, atol)
    state[kStateF0] = fn;
    state[kStateTol] = tol;
    its = 0.0;
  } else {
    tol = state[kStateTol];
    its = state[kStateIts] + 1.0;
  }
  state[kStateFn] = fn;
  state[kStateIts] = its;
  state[kStateDone] = (fn > tol && its < state[kStateMaxIt]) ? 0.0 : 1.0;
}

__global__ void __launch_bounds__(kNormThreads)
    ngs_norm_kernel(const NgsPart* __restrict__ parts, NgsBlocks k, NgsWeights cw, double* state, double* partials,
                    unsigned* arrivals, int init, int local) {
  __shared__ double s[kNormThreads];
  __shared__ bool last;
  const double done = state[kStateDone];
  int pi = 0;
  while (pi + 1 < k.nparts && static_cast<int>(blockIdx.x) >= k.cta0[pi + 1]) ++pi;
  const int lx = k.lx, n = k.ly * lx;
  const int G = k.ctas[pi], K = k.leaves[pi], cb = blockIdx.x - k.cta0[pi], t = threadIdx.x;
  double* rout = reinterpret_cast<double*>(k.r[pi]);
  const long long stride = static_cast<long long>(G) * kNormThreads;
  const int logK = 31 - __clz(K);
  // the thread's leaves in bit-reversed order, summed by a binary counter:
  // the halving tree over k (k and k + K/2 first)
  double stack[8];
  int depth = 0;
  for (int q = 0; q < K; ++q) {
    const int kk = logK ? static_cast<int>(__brev(static_cast<unsigned>(q)) >> (32 - logK)) : 0;
    const long long e = static_cast<long long>(t) * G + cb + kk * stride;
    double v = 0.0;
    if (e < 2LL * n) {
      const int f = e >= n, rem = static_cast<int>(e) - f * n, j = rem / lx, i = rem - j * lx;
      bool bdry;
      const double r = row_residual(parts, k, cw, pi, f, j, i, bdry);
      if (rout && done == 0.0) rout[e] = r;
      v = __dmul_rn(r, r);
    }
    for (int m = q; m & 1; m >>= 1) v = __dadd_rn(stack[--depth], v);
    stack[depth++] = v;
  }
  if (done != 0.0) return;
  s[t] = stack[0];
  __syncthreads();
  for (int w = kNormThreads / 2; w >= 1; w >>= 1) {
    if (t < w) s[t] = __dadd_rn(s[t], s[t + w]);
    __syncthreads();
  }
  if (t == 0) {
    partials[blockIdx.x] = s[0];
    __threadfence();
    last = atomicAdd(arrivals, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last CTA: each block's tree over its CTAs, the blocks in order
  double total = 0.0;
  for (int q = 0; q < k.nparts; ++q) {
    const int g0 = k.cta0[q], gq = k.ctas[q];
    __syncthreads();
    s[t] = t < gq ? __ldcg(partials + g0 + t) : 0.0;
    __syncthreads();
    for (int w = kNormThreads / 2; w >= 1; w >>= 1) {
      if (t < w && t + w < gq) s[t] = __dadd_rn(s[t], s[t + w]);
      __syncthreads();
    }
    if (t == 0) total = q == 0 ? s[0] : __dadd_rn(total, s[0]);
  }
  if (t == 0) {
    *arrivals = 0u;
    if (local) {
      finish(state, total, init);
    } else {
      state[kStateTotal] = total;
    }
  }
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

// parts, words, nparts, ctas (the norm's CTAs over every block), weights
// (host), ny, nx, state, partials (ctas doubles), arrivals (one unsigned,
// 0 between launches), init (1: the first norm, f0 and tol), local (1: the
// root and stop test here; 0: the blocks' total left in the state for an
// all-reduce and ngs_finish_kernel), stream
extern "C" int perphil_ngs_norm(const void* parts, const long long* words, int nparts, int ctas,
                                const double* weights, int ny, int nx, double* state, double* partials,
                                unsigned* arrivals, int init, int local, void* stream) {
  using namespace perphil;
  NgsBlocks k;
  if (!parts || !state || !partials || !arrivals || ctas < nparts || !blocks_of(words, nparts, ny, nx, k)) {
    return (int)cudaErrorInvalidValue;
  }
  ngs_norm_kernel<<<ctas, kNormThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const NgsPart*>(parts), k, weights_of(weights), state, partials, arrivals, init, local);
  return (int)cudaGetLastError();
}

// state, init, stream
extern "C" int perphil_ngs_finish(double* state, int init, void* stream) {
  using namespace perphil;
  if (!state) return (int)cudaErrorInvalidValue;
  ngs_finish_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(state, init);
  return (int)cudaGetLastError();
}
