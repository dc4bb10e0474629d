// Shared device code of the DPP kernels (K1 dpp_apply.cu, K2 fused_direct.cu,
// K3 fused_pcg.cu): the two-field 3^d stencil with the box boundary folded in,
// block-wide reductions, and the per-axis dense transforms of the
// fast-diagonalization solves.
//
// Conventions (as in perphil_tpu/ops/stencil.py): grids are slowest axis
// first, u[k][j][i] with x fastest; a 2D grid has nz == 1. Stencil weights are
// flattened from [dz+1][dy+1][dx+1] (2D: [dy+1][dx+1], the first 9 entries).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace perphil {

// Combined two-field DPP stencils (ops/assembly.py::dpp_stencils):
//   y1 = S1*z1 + C*z2,   y2 = C*z1 + S2*z2.
// Passed to kernels by value (3 x 27 weights: 648 bytes in f64).
template <typename T>
struct DppWeights {
  T s1[27];
  T s2[27];
  T c[27];
};

// Host: weights from 81 doubles laid out [S1 | S2 | C], 27 each.
template <typename T>
inline DppWeights<T> weights_from_host(const double* w) {
  DppWeights<T> out;
  for (int o = 0; o < 27; ++o) {
    out.s1[o] = static_cast<T>(w[o]);
    out.s2[o] = static_cast<T>(w[27 + o]);
    out.c[o] = static_cast<T>(w[54 + o]);
  }
  return out;
}

struct Grid {
  int nz, ny, nx;
  __host__ __device__ long nodes() const { return (long)nz * ny * nx; }
};

enum ApplyMode { kMatvec = 0, kLift = 1 };

template <int D>
__device__ __forceinline__ bool on_boundary(const Grid& g, int k, int j, int i) {
  bool b = j == 0 || j == g.ny - 1 || i == 0 || i == g.nx - 1;
  if (D == 3) b = b || k == 0 || k == g.nz - 1;
  return b;
}

template <int D>
__device__ __forceinline__ void node_coords(const Grid& g, long idx, int& k, int& j, int& i) {
  i = (int)(idx % g.nx);
  const long t = idx / g.nx;
  j = (int)(t % g.ny);
  k = D == 3 ? (int)(t / g.ny) : 0;
}

// One row of the BC-eliminated two-field operator at node (k, j, i).
// Boundary rows pass the input through: identity rows (kMatvec) or the
// Dirichlet value g (kLift). Interior rows sum the stencil over neighbours of
// one kind only, so no mask array is read:
//   kMatvec: interior neighbours -> y = A z              (assembly.py:192-212)
//   kLift:   boundary neighbours -> y = -A[int, bd] g    (assembly.py:220-238)
template <typename T, int D>
__device__ __forceinline__ void dpp_apply_node(const T* z1, const T* z2,
                                               const DppWeights<T>& w, const Grid& g, int mode,
                                               int k, int j, int i, T& y1, T& y2) {
  const long idx = ((long)k * g.ny + j) * g.nx + i;
  if (on_boundary<D>(g, k, j, i)) {
    y1 = z1[idx];
    y2 = z2[idx];
    return;
  }
  const bool want_boundary = mode == kLift;
  T a1 = T(0), a2 = T(0);
#pragma unroll
  for (int dz = (D == 3 ? -1 : 0); dz <= (D == 3 ? 1 : 0); ++dz) {
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        if (on_boundary<D>(g, k + dz, j + dy, i + dx) != want_boundary) continue;
        const int o = (D == 3 ? (dz + 1) * 9 : 0) + (dy + 1) * 3 + (dx + 1);
        const long nb = idx + ((long)dz * g.ny + dy) * g.nx + dx;
        const T u = z1[nb], v = z2[nb];
        a1 += w.s1[o] * u + w.c[o] * v;
        a2 += w.c[o] * u + w.s2[o] * v;
      }
    }
  }
  y1 = mode == kLift ? -a1 : a1;
  y2 = mode == kLift ? -a2 : a2;
}

// Block-wide sum (kMax = false) or max of one double per thread; every thread
// receives the result. blockDim.x is a multiple of 32; `red` is 33 doubles of
// shared memory. Contains two __syncthreads(), so global writes made before
// the call are visible to the whole block after it.
__device__ __forceinline__ double warp_reduce(double v, bool is_max) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const double other = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmax(v, other) : v + other;
  }
  return v;
}

template <bool kMax>
__device__ double block_reduce(double v, double* red) {
  v = warp_reduce(v, kMax);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) red[wid] = v;
  __syncthreads();
  if (wid == 0) {
    double t = lane < (int)(blockDim.x >> 5) ? red[lane] : (kMax ? -INFINITY : 0.0);
    t = warp_reduce(t, kMax);
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  return red[32];
}

// Interior grid (iz, iy, ix) = node grid minus its boundary layer; in 2D
// iz == 1. Interior index q -> node index.
template <int D>
__device__ __forceinline__ long interior_to_node(const Grid& g, int q) {
  const int ix = g.nx - 2, iy = g.ny - 2;
  const int c = q % ix;
  const int t = q / ix;
  const int b = t % iy;
  const int a = t / iy;
  return ((long)(a + (D == 3 ? 1 : 0)) * g.ny + (b + 1)) * g.nx + (c + 1);
}

// Node (k, j, i), known interior -> interior index q.
template <int D>
__device__ __forceinline__ int node_to_interior(const Grid& g, int k, int j, int i) {
  return ((D == 3 ? k - 1 : 0) * (g.ny - 2) + (j - 1)) * (g.nx - 2) + (i - 1);
}

// One axis of the separable eigen-transform on the interior grids of
// `nfields` fields (nfields * nint values, field-major; both by default). S
// is n x n, row-major, eigenvectors
// in its columns (scipy's eigh). kForward applies S^T (analysis), otherwise
// S (synthesis). `stride` is the axis stride inside one interior grid. Each
// thread writes distinct outputs; the caller synchronises after.
// No __restrict__ on pointers into buffers the calling kernel also writes:
// it would allow non-coherent (read-only cache) loads of data that changes
// between phases.
template <typename T, bool kForward>
__device__ void transform_axis(const T* in, T* out, const T* S, int n, int stride, int nint,
                               int nfields = 2) {
  for (int e = threadIdx.x; e < nfields * nint; e += blockDim.x) {
    const int c = ((e % nint) / stride) % n;
    const T* line = in + (e - c * stride);
    T acc = T(0);
    for (int p = 0; p < n; ++p) {
      acc += (kForward ? S[p * n + c] : S[c * n + p]) * line[p * stride];
    }
    out[e] = acc;
  }
}

// Forward (or inverse) transform over all axes: x, y, then z in 3D. Returns
// the buffer that holds the result (w0 or w1).
template <typename T, int D, bool kForward>
__device__ T* transform_all(T* w0, T* w1, const T* Sx, const T* Sy, const T* Sz,
                            const Grid& g, int nint, int nfields = 2) {
  const int ix = g.nx - 2, iy = g.ny - 2, iz = D == 3 ? g.nz - 2 : 1;
  T* cur = w0;
  T* nxt = w1;
  const T* mats[3] = {Sx, Sy, Sz};
  const int ns[3] = {ix, iy, iz};
  const int strides[3] = {1, ix, ix * iy};
  for (int a = 0; a < D; ++a) {
    transform_axis<T, kForward>(cur, nxt, mats[a], ns[a], strides[a], nint, nfields);
    __syncthreads();
    T* t = cur;
    cur = nxt;
    nxt = t;
  }
  return cur;
}

}  // namespace perphil
