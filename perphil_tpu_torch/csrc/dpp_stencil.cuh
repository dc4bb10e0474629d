// What every DPP kernel shares (K1 dpp_apply.cu; K2 fused_direct.cu and K3
// fused_pcg.cu through direct_smem.cuh; K4-K8 fused_gmres*.cu*): the
// two-field stencil weights, the grid, the box boundary test, a warp's
// reduction and the interior-to-node index.
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

// A warp's sum (is_max false) or max of one double a lane; every lane
// receives the result.
__device__ __forceinline__ double warp_reduce(double v, bool is_max) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const double other = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmax(v, other) : v + other;
  }
  return v;
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

}  // namespace perphil
