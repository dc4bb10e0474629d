// K1: the fused two-field DPP stencil apply.
//
// Replaces perphil_tpu/ops/pallas_kernels.py::fused_dpp_apply (pallas_call at
// :139, body _make_kernel at :42), which computes y1 = S1*z1 + C*z2 and
// y2 = C*z1 + S2*z2 over halo'd VMEM tiles, f32 only, with the boundary
// masking left to XLA outside the kernel.
//
// Bound on the H100: memory. Per node it reads 2 values (plus neighbours that
// hit L1/L2) and writes 2, for 4 * 3^d multiply-adds: at 64^3 hex in f64 about
// 4.4 MB in and 4.4 MB out per apply, far below the card's f64 rate.
//
// Design: one thread per node, x fastest, so each warp's loads and stores are
// contiguous; neighbour reads are re-reads of lines the warp's neighbours just
// loaded. The box boundary is folded in (i == 0 || i == n-1 per axis), so no
// mask array is read, in two modes: kMatvec (interior-masked input, identity
// boundary rows) and kLift (boundary-only input, -A[int,bd] g on the interior,
// g on the boundary). The 3 x 27 weights travel by value in the launch
// parameters. Templated on float/double and on dimension 2/3.

#include "dpp_stencil.cuh"

namespace perphil {

template <typename T, int D>
__global__ void dpp_apply_kernel(const T* __restrict__ z1, const T* __restrict__ z2,
                                 T* __restrict__ y1, T* __restrict__ y2,
                                 DppWeights<T> w, Grid g, int mode) {
  const long n = g.nodes();
  for (long idx = blockIdx.x * (long)blockDim.x + threadIdx.x; idx < n;
       idx += (long)gridDim.x * blockDim.x) {
    int k, j, i;
    node_coords<D>(g, idx, k, j, i);
    T a, b;
    dpp_apply_node<T, D>(z1, z2, w, g, mode, k, j, i, a, b);
    y1[idx] = a;
    y2[idx] = b;
  }
}

template <typename T>
int launch_dpp_apply(const T* z1, const T* z2, T* y1, T* y2, const double* weights,
                     int nz, int ny, int nx, int dim, int mode, void* stream) {
  const Grid g{nz, ny, nx};
  const long n = g.nodes();
  if (n == 0) return (int)cudaSuccess;
  if ((dim != 2 && dim != 3) || (mode != kMatvec && mode != kLift)) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  const DppWeights<T> w = weights_from_host<T>(weights);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dim == 3) {
    dpp_apply_kernel<T, 3><<<blocks, threads, 0, st>>>(z1, z2, y1, y2, w, g, mode);
  } else {
    dpp_apply_kernel<T, 2><<<blocks, threads, 0, st>>>(z1, z2, y1, y2, w, g, mode);
  }
  return (int)cudaGetLastError();
}

}  // namespace perphil

extern "C" int perphil_dpp_apply_f32(const float* z1, const float* z2, float* y1, float* y2,
                                     const double* weights, int nz, int ny, int nx, int dim,
                                     int mode, void* stream) {
  return perphil::launch_dpp_apply<float>(z1, z2, y1, y2, weights, nz, ny, nx, dim, mode, stream);
}

extern "C" int perphil_dpp_apply_f64(const double* z1, const double* z2, double* y1, double* y2,
                                     const double* weights, int nz, int ny, int nx, int dim,
                                     int mode, void* stream) {
  return perphil::launch_dpp_apply<double>(z1, z2, y1, y2, weights, nz, ny, nx, dim, mode, stream);
}

extern "C" const char* perphil_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
