// ngs_colour_halo_first: the first colour-step kernel of the sharded Picard
// solve (as it stood before its redesign in csrc/ngs_colour_halo.cu), kept as
// a probe for tools/profile_kernels.py --only ngs-blocked and chip_smoke.py
// phase 14, which time the loop it served (ops/fused_ngs.py::
// blocked_ngs_probe: per colour a plane exchange and one launch a block, the
// norm as torch ops read back every iteration) in turns with the package's.
// Built alone (one nvcc, PERPHIL_NGS_PROBE); the package's launcher never
// builds it, and its launches are counted nowhere.
//
// What it is: one colour step of the pinned-colouring SNES ngs sweep on
// one block of a 2D quad grid that is split over ranks (ops/fused_ngs.py,
// colour_step; the sharded Picard solve, parallel/sharding.py).
//
// Replaces no Pallas kernel: in the JAX package the sharded Picard solve is
// the single-device XLA sweeper (ColoredNGSSweeper.sweep,
// perphil_tpu/ops/ilu.py:924) that XLA's partitioner runs on every device,
// with a halo exchange a sweep (perphil_tpu/parallel/sharding.py:228-233).
// Here the exchange is parallel/halo.py's, once before each colour, and
// this kernel is the step that follows it. What it computes is
// colour_step_plain bit for bit, and so ColoredNGSSweeper.residual's rows:
//   a row of field f at an interior node: b - (0.0 + w[f][f' * 9 + q] *
//   x[f', node + offset q] over field 0's nine taps then field 1's), each
//   product and sum rounded on its own (__dmul_rn / __dadd_rn: nvcc would
//   contract them into FMAs), a neighbour on the grid's boundary reading
//   0.0; a boundary (or phantom) row: b - x.
// A step (rows != null) takes the ``count`` rows of the colour and writes
// x + r / d in place (d the field's diagonal, 1 on a boundary row): no row
// of a colour reads another row of that colour (the colouring is distance-1
// on the monolithic pattern), so the rows it reads are never written in the
// launch. The residual mode (rows == null, r != null) writes every row's
// residual to r, for the norm.
//
// The block is (2, ly, lx), field-major; the received planes are read where
// they arrived (halo.exchange_planes): along y (2, 1, lx) below and above,
// along x (2, ly + 2, 1) left and right, the x planes holding the corners
// (the y planes' end rows the neighbour had received). A missing plane (an
// edge rank, or an axis not split) is never read by an interior row. A
// node's place in the global grid is its block offset (oy, ox) plus its
// local index; rows at or beyond ny - 1 / nx - 1 are boundary or phantom
// rows.
//
// One thread a row. A step reads the colour's rows (both fields of their
// 3 x 3 neighbourhoods) and writes them: at 2D N=128 a colour holds ~2,400
// of the 33,282 rows, so a step is a small launch, bound by its latency.

#include <cuda_runtime.h>

namespace perphil {

constexpr int kColourThreads = 256;

struct ColourWeights {
  double w[2][18];  // per row field: field 0's nine taps, then field 1's
  double diag[2];   // the interior rows' diagonals
};

struct ColourBlock {
  double* x;
  const double* b;
  const double* plane[4];  // y below, y above, x left, x right (null: none)
  int ly, lx, oy, ox, ny, nx;
};

__device__ __forceinline__ bool on_boundary(const ColourBlock& k, int gj, int gi) {
  return gj <= 0 || gj >= k.ny - 1 || gi <= 0 || gi >= k.nx - 1;
}

// x of field f at local (j, i), j in [-1, ly], i in [-1, lx]: the block, or
// the plane of the last axis on which the node is a ghost
__device__ __forceinline__ double load(const ColourBlock& k, int f, int j, int i) {
  const double* p;
  if (i < 0 || i >= k.lx) {
    p = k.plane[i < 0 ? 2 : 3];
    return p ? p[f * (k.ly + 2) + j + 1] : 0.0;
  }
  if (j < 0 || j >= k.ly) {
    p = k.plane[j < 0 ? 0 : 1];
    return p ? p[f * k.lx + i] : 0.0;
  }
  return k.x[(f * k.ly + j) * k.lx + i];
}

__global__ void __launch_bounds__(kColourThreads)
    ngs_colour_halo_kernel(ColourBlock k, ColourWeights cw, const int* rows, int count, double* r_out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= count) return;
  const int e = rows ? rows[t] : t;
  const int n = k.ly * k.lx;
  const int f = e / n;
  const int j = (e - f * n) / k.lx;
  const int i = e - f * n - j * k.lx;
  const int gj = k.oy + j, gi = k.ox + i;
  const double xv = k.x[e];
  const double bv = k.b[e];
  const bool bdry = on_boundary(k, gj, gi);
  double r;
  if (bdry) {
    r = __dsub_rn(bv, xv);
  } else {
    double acc = 0.0;
#pragma unroll
    for (int q = 0; q < 18; ++q) {
      const int dy = (q % 9) / 3 - 1, dx = q % 3 - 1;
      const double u = on_boundary(k, gj + dy, gi + dx) ? 0.0 : load(k, q / 9, j + dy, i + dx);
      acc = __dadd_rn(acc, __dmul_rn(cw.w[f][q], u));
    }
    r = __dsub_rn(bv, acc);
  }
  if (rows) {
    k.x[e] = __dadd_rn(xv, __ddiv_rn(r, bdry ? 1.0 : cw.diag[f]));
  } else {
    r_out[e] = r;
  }
}

}  // namespace perphil

// x (in/out), b, planes y_lo, y_hi, x_lo, x_hi (null: none), rows (null:
// the residual mode), count, r (the residual mode's output), weights (host,
// 38 doubles: 2 x 18 taps, 2 diagonals), ly, lx, oy, ox, ny, nx, stream
extern "C" int perphil_ngs_colour_halo_first(double* x, const double* b, const double* ylo, const double* yhi,
                                       const double* xlo, const double* xhi, const int* rows, int count,
                                       double* r, const double* weights, int ly, int lx, int oy, int ox, int ny,
                                       int nx, void* stream) {
  using namespace perphil;
  if (ly < 1 || lx < 1 || count < 0 || count > 2 * ly * lx || ny < 3 || nx < 3) {
    return (int)cudaErrorInvalidValue;
  }
  if (count == 0) return (int)cudaSuccess;  // a colour with no row in the block (its list is empty)
  if (!rows && !r) return (int)cudaErrorInvalidValue;
  ColourBlock k{x, b, {ylo, yhi, xlo, xhi}, ly, lx, oy, ox, ny, nx};
  ColourWeights cw;
  for (int f = 0; f < 2; ++f) {
    for (int q = 0; q < 18; ++q) cw.w[f][q] = weights[f * 18 + q];
    cw.diag[f] = weights[36 + f];
  }
  const int grid = (count + kColourThreads - 1) / kColourThreads;
  ngs_colour_halo_kernel<<<grid, kColourThreads, 0, static_cast<cudaStream_t>(stream)>>>(k, cw, rows, count, r);
  return (int)cudaGetLastError();
}
