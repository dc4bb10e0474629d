// K3: the whole simplicial direct-role solve, PCG to machine tolerance, in one
// thread block.
//
// Replaces perphil_tpu/ops/pallas_direct.py::fused_simplicial_direct_solve
// (:491; _build_simplicial_pcg :286, pallas_call :469): double-float PCG to
// rtol 1e-13 (at most 2000 iterations), preconditioned per field by the
// lumped-tensor fast-diagonalization on the interior with identity boundary
// rows (pallas_direct.py:338-357), stopping on convergence or a non-finite
// residual.
//
// Bound on the H100: latency. Each iteration is a stencil matvec, a
// preconditioner of 2*d small dense transforms and three dot products over a
// few thousand nodes, so a host-driven loop would spend its time in launches
// and in reading the stopping test back. Here the loop runs inside the kernel.
//
// Design: one block of kPcgThreads (512) threads, native f64 throughout (the port's
// precision rule replaces double-float with f64). Phases are separated by
// __syncthreads(); vectors and preconditioner scratch live in device memory
// (L2-resident at envelope sizes). The matvec is the K1 device function; dot
// products are f64 block reductions (warp shuffles, then shared memory), so
// every thread sees the same scalars and takes the same branch.

#include "dpp_stencil.cuh"

namespace perphil {

constexpr int kPcgThreads = 512;

// z = P r (lumped fast-diag on each field's interior, identity on the
// boundary); returns this thread's part of <r, z>.
template <int D>
__device__ double apply_pc(const double* r, double* z, double* w0, double* w1,
                           const double* Sx, const double* Sy, const double* Sz,
                           const double* sc, const Grid& g, int nint) {
  const long n = g.nodes();
  for (int e = threadIdx.x; e < 2 * nint; e += blockDim.x) {
    const int f = e / nint;
    w0[e] = r[f * n + interior_to_node<D>(g, e - f * nint)];
  }
  __syncthreads();
  double* cur = transform_all<double, D, true>(w0, w1, Sx, Sy, Sz, g, nint);
  for (int e = threadIdx.x; e < 2 * nint; e += blockDim.x) cur[e] /= sc[e];
  __syncthreads();
  double* other = cur == w0 ? w1 : w0;
  cur = transform_all<double, D, false>(cur, other, Sx, Sy, Sz, g, nint);
  double rz = 0.0;
  for (long e = threadIdx.x; e < 2 * n; e += blockDim.x) {
    const long f = e / n;
    int k, j, i;
    node_coords<D>(g, e - f * n, k, j, i);
    const double v = on_boundary<D>(g, k, j, i)
                         ? r[e]
                         : cur[f * nint + node_to_interior<D>(g, k, j, i)];
    z[e] = v;
    rz += r[e] * v;
  }
  return rz;
}

template <int D>
__global__ void __launch_bounds__(kPcgThreads)
fused_pcg_kernel(const double* __restrict__ b, double* x, int* its_out,
                 double* work, const double* Sx, const double* Sy, const double* Sz,
                 const double* sc, DppWeights<double> w, Grid g, double rtol, int max_it) {
  __shared__ double red[33];
  const long n = g.nodes();
  const int nint = (g.nx - 2) * (g.ny - 2) * (D == 3 ? g.nz - 2 : 1);
  double* r = work;
  double* z = r + 2 * n;
  double* p = z + 2 * n;
  double* Ap = p + 2 * n;
  double* w0 = Ap + 2 * n;
  double* w1 = w0 + 2 * nint;

  double rr = 0.0;
  for (long e = threadIdx.x; e < 2 * n; e += blockDim.x) {
    x[e] = 0.0;
    r[e] = b[e];
    rr += b[e] * b[e];
  }
  rr = block_reduce<false>(rr, red);
  double rz = block_reduce<false>(apply_pc<D>(r, z, w0, w1, Sx, Sy, Sz, sc, g, nint), red);
  for (long e = threadIdx.x; e < 2 * n; e += blockDim.x) p[e] = z[e];
  double rnorm = sqrt(rr);
  const double tol = rtol * rnorm;
  int its = 0;
  while (rnorm > tol && its < max_it) {
    __syncthreads();
    double pap = 0.0;
    for (long idx = threadIdx.x; idx < n; idx += blockDim.x) {
      int k, j, i;
      node_coords<D>(g, idx, k, j, i);
      double y1, y2;
      dpp_apply_node<double, D>(p, p + n, w, g, kMatvec, k, j, i, y1, y2);
      Ap[idx] = y1;
      Ap[n + idx] = y2;
      pap += p[idx] * y1 + p[n + idx] * y2;
    }
    const double alpha = rz / block_reduce<false>(pap, red);
    rr = 0.0;
    for (long e = threadIdx.x; e < 2 * n; e += blockDim.x) {
      x[e] += alpha * p[e];
      r[e] -= alpha * Ap[e];
      rr += r[e] * r[e];
    }
    rr = block_reduce<false>(rr, red);
    const double rz_new = block_reduce<false>(apply_pc<D>(r, z, w0, w1, Sx, Sy, Sz, sc, g, nint), red);
    const double beta = rz_new / rz;
    for (long e = threadIdx.x; e < 2 * n; e += blockDim.x) p[e] = z[e] + beta * p[e];
    rz = rz_new;
    ++its;
    rnorm = sqrt(rr);
    if (!isfinite(rnorm)) break;
  }
  if (threadIdx.x == 0) *its_out = its;
}

}  // namespace perphil

// b, x: (2, nz*ny*nx) f64; its: one int32; work: 8 * nodes + 4 * nint f64;
// Sx/Sy/Sz: f64 (n, n) lumped eigenvector matrices per axis (Sz unused in 2D);
// sc: (2, nint) f64 lumped mode scales per field.
extern "C" int perphil_fused_pcg(const double* b, double* x, int* its, double* work,
                                 const double* Sx, const double* Sy, const double* Sz,
                                 const double* sc, const double* weights, int nz, int ny, int nx,
                                 int dim, double rtol, int max_it, void* stream) {
  using namespace perphil;
  if ((dim != 2 && dim != 3) || nx < 3 || ny < 3 || (dim == 3 && nz < 3)) {
    return (int)cudaErrorInvalidValue;
  }
  const Grid g{nz, ny, nx};
  const DppWeights<double> w = weights_from_host<double>(weights);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dim == 3) {
    fused_pcg_kernel<3><<<1, kPcgThreads, 0, st>>>(b, x, its, work, Sx, Sy, Sz, sc, w, g, rtol,
                                                   max_it);
  } else {
    fused_pcg_kernel<2><<<1, kPcgThreads, 0, st>>>(b, x, its, work, Sx, Sy, Sz, sc, w, g, rtol,
                                                   max_it);
  }
  return (int)cudaGetLastError();
}
