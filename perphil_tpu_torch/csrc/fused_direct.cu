// K2: the whole direct solve on small quad/hex meshes, one thread block.
//
// Replaces perphil_tpu/ops/pallas_direct.py::fused_direct_solve (:228;
// _build_direct :79, pallas_call :209): an f32 tensor fast-diagonalization
// solve (per-axis eigen-transforms, closed-form 2x2 solves per mode, inverse
// transforms) followed by 5 fixed refinement steps with the stencil matvec,
// on a packed double-float (Rp <= 512, 128) VMEM layout.
//
// Bound on the H100: launch and synchronisation latency. Inside the envelope
// (fused_direct_supported) the work is at most a few MFLOP per transform, so a
// chain of small library calls would be dominated by their launches; here the
// whole solve is one launch. All scratch fits in L2 at these sizes.
//
// Design: one block of kDirectThreads (512) threads walks the phases, separated by
// __syncthreads(); scratch lives in device memory (L2-resident). The inputs are
// natural (2, nodes) f64 grids, not the TPU's packed layout. The transforms
// loop over the small dense S of each axis (read through L1/L2). Native f64
// replaces the TPU's double-float: the refinement residual is f64 through the
// K1 device function, the correction solve is f32, x accumulates in f64.
// Boundary rows take b exactly and every correction passes the residual
// through on the boundary (pallas_direct.py:184-193). Each f32 solve is scaled
// by the max of its right-hand side, as ops/mixed.py:233-237 does.

#include "dpp_stencil.cuh"

namespace perphil {

constexpr int kDirectThreads = 512;

// x += s * fastdiag32(src / s) on the interior; x += src on the boundary.
template <int D>
__device__ void add_correction(const double* src, double s, double* x, float* w0, float* w1,
                               const float* Sx, const float* Sy, const float* Sz,
                               const float* a11, const float* a22, const float* det, float a12,
                               const Grid& g, int nint) {
  const long n = g.nodes();
  for (int e = threadIdx.x; e < 2 * nint; e += blockDim.x) {
    const int f = e / nint;
    w0[e] = (float)(src[f * n + interior_to_node<D>(g, e - f * nint)] / s);
  }
  for (long e = threadIdx.x; e < 2 * n; e += blockDim.x) {
    int k, j, i;
    node_coords<D>(g, e % n, k, j, i);
    if (on_boundary<D>(g, k, j, i)) x[e] += src[e];
  }
  __syncthreads();
  float* cur = transform_all<float, D, true>(w0, w1, Sx, Sy, Sz, g, nint);
  for (int q = threadIdx.x; q < nint; q += blockDim.x) {
    const float f1 = cur[q], f2 = cur[nint + q];
    cur[q] = (a22[q] * f1 - a12 * f2) / det[q];
    cur[nint + q] = (a11[q] * f2 - a12 * f1) / det[q];
  }
  __syncthreads();
  float* other = cur == w0 ? w1 : w0;
  cur = transform_all<float, D, false>(cur, other, Sx, Sy, Sz, g, nint);
  for (int e = threadIdx.x; e < 2 * nint; e += blockDim.x) {
    const int f = e / nint;
    x[f * n + interior_to_node<D>(g, e - f * nint)] += (double)cur[e] * s;
  }
  __syncthreads();
}

template <int D>
__global__ void __launch_bounds__(kDirectThreads)
fused_direct_kernel(const double* __restrict__ b, double* x, double* r,
                    float* work, const float* Sx, const float* Sy, const float* Sz,
                    const float* a11, const float* a22, const float* det, float a12,
                    DppWeights<double> w, Grid g, int refinements) {
  __shared__ double red[33];
  const long n = g.nodes();
  const int nint = (g.nx - 2) * (g.ny - 2) * (D == 3 ? g.nz - 2 : 1);
  float* w0 = work;
  float* w1 = work + 2 * nint;

  double m = 0.0;
  for (long e = threadIdx.x; e < 2 * n; e += blockDim.x) {
    x[e] = 0.0;
    m = fmax(m, fabs(b[e]));
  }
  double s = fmax(block_reduce<true>(m, red), 1e-30);
  add_correction<D>(b, s, x, w0, w1, Sx, Sy, Sz, a11, a22, det, a12, g, nint);

  for (int it = 0; it < refinements; ++it) {
    m = 0.0;
    for (long idx = threadIdx.x; idx < n; idx += blockDim.x) {
      int k, j, i;
      node_coords<D>(g, idx, k, j, i);
      double y1, y2;
      dpp_apply_node<double, D>(x, x + n, w, g, kMatvec, k, j, i, y1, y2);
      const double r1 = b[idx] - y1, r2 = b[n + idx] - y2;
      r[idx] = r1;
      r[n + idx] = r2;
      m = fmax(m, fmax(fabs(r1), fabs(r2)));
    }
    s = fmax(block_reduce<true>(m, red), 1e-30);
    add_correction<D>(r, s, x, w0, w1, Sx, Sy, Sz, a11, a22, det, a12, g, nint);
  }
}

}  // namespace perphil

// b, x, r: (2, nz*ny*nx) f64; work: 4 * nint f32; Sx/Sy/Sz: f32 (n, n)
// eigenvector matrices per axis (Sz unused in 2D); a11/a22/det: (nint,) f32.
extern "C" int perphil_fused_direct(const double* b, double* x, double* r, float* work,
                                    const float* Sx, const float* Sy, const float* Sz,
                                    const float* a11, const float* a22, const float* det,
                                    float a12, const double* weights, int nz, int ny, int nx,
                                    int dim, int refinements, void* stream) {
  using namespace perphil;
  if ((dim != 2 && dim != 3) || nx < 3 || ny < 3 || (dim == 3 && nz < 3)) {
    return (int)cudaErrorInvalidValue;
  }
  const Grid g{nz, ny, nx};
  const DppWeights<double> w = weights_from_host<double>(weights);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dim == 3) {
    fused_direct_kernel<3><<<1, kDirectThreads, 0, st>>>(b, x, r, work, Sx, Sy, Sz, a11, a22,
                                                         det, a12, w, g, refinements);
  } else {
    fused_direct_kernel<2><<<1, kDirectThreads, 0, st>>>(b, x, r, work, Sx, Sy, Sz, a11, a22,
                                                         det, a12, w, g, refinements);
  }
  return (int)cudaGetLastError();
}
