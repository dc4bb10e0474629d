// ngs_colour_norm_first: the first norm kernel of the blocked Picard
// iteration (as it stood before its redesign in csrc/ngs_colour_halo.cu),
// kept as a probe for tools/profile_kernels.py --only ngs-blocked and
// chip_smoke.py phase 14, which hold it to the package's norm bit for bit
// and time the two in turns (ops/fused_ngs.py::norm_probe_library,
// FirstNormSweep). Built alone (one nvcc, PERPHIL_NGS_NORM_PROBE); the
// package's launcher never builds it, and its launches are counted nowhere.
// It includes csrc/ngs_colour_halo.cu for the blocks' table, the rows'
// residual and the stop test, which the redesign did not change.
//
// What it computes is the package's norm: for a block of n values (both
// fields, flat), the halving tree of krylov.tree_sum over the squares
// zero-padded to L, a power of two at least n; the blocks' sums added in
// coordinate order; the correctly rounded root and the stop test. Its
// layout: CTA b of the block's G, thread t of 256, computes the residuals of
// rows r + k * 256 G, r = t * G + b (a warp's lanes read rows G apart), and
// sums their squares in the tree's order (the top bits of the index first);
// the CTA then over t by halving in shared memory (a barrier a level), and
// the last CTA of the launch to arrive over b, block by block (a barrier a
// level a block), and the blocks in order.

#include "ngs_colour_halo.cu"

namespace perphil {

__global__ void __launch_bounds__(kNormThreads)
    ngs_norm_first_kernel(const NgsPart* __restrict__ parts, NgsBlocks k, NgsWeights cw, double* state,
                          double* partials, unsigned* arrivals, int init, int local) {
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

}  // namespace perphil

// parts, words, nparts, ctas (the norm's CTAs over every block), weights
// (host), ny, nx, state, partials (ctas doubles), arrivals (one unsigned,
// 0 between launches), init (1: the first norm, f0 and tol), local (1: the
// root and stop test here; 0: the blocks' total left in the state), stream
extern "C" int perphil_ngs_norm_first(const void* parts, const long long* words, int nparts, int ctas,
                                      const double* weights, int ny, int nx, double* state, double* partials,
                                      unsigned* arrivals, int init, int local, void* stream) {
  using namespace perphil;
  NgsBlocks k;
  if (!parts || !state || !partials || !arrivals || ctas < nparts || !blocks_of(words, nparts, ny, nx, k)) {
    return (int)cudaErrorInvalidValue;
  }
  ngs_norm_first_kernel<<<ctas, kNormThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const NgsPart*>(parts), k, weights_of(weights), state, partials, arrivals, init, local);
  return (int)cudaGetLastError();
}
