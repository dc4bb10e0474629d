// dpp_apply_halo_box: the first port's halo form of K1 (as it stood before
// its redesign), kept as a probe for tools/profile_kernels.py --only halo and
// chip_smoke.py phase 14, which time it in turns with the package's
// dpp_apply_halo_kernel. Built alone (one nvcc, this file with
// csrc/dpp_apply.cu included for K1's staging and term order); the
// package's launcher never builds it, and its launches are counted nowhere.
//
// It reads one contiguous extended box (the owned block with its ghost
// planes copied around it) and tiles the owned block, 16 x 16 columns and
// 4 z planes a block: 9 x 9 x 33 blocks on a 129^3 box where K1 launches
// 8 x 8 x 32.
//
#include "dpp_apply.cu"

namespace perphil {

// The input is a box of nodes (nz, ny, nx) that may carry one ghost plane on
// either side of each axis (a neighbour's values, read as stencil
// neighbours and never written), and the output is the owned block, the box
// without its ghosts. Which node is a boundary (identity) row is decided by
// its global index, not by its place in the box: a node whose global index
// is 0 or at least n_phys - 1 on some axis is a boundary row (on a padded
// grid the phantom nodes beyond n_phys - 1 are boundary rows with zero
// data). In box coordinates the interior is [m0, m1) per axis; an owned
// node inside it is a stencil row, every other owned node writes its raw
// input. The staging folds the mode's mask in as the whole-grid kernel
// does (matvec: interior nodes kept; lift: the others), and a node outside
// the box is the zero fill. A stencil row's 27 terms are staged, ordered
// and summed as in dpp_apply_kernel, so at equal values it gives the
// whole-grid kernel's bits.
struct HaloBoxGeom {
  int n[3];      // the box, (z, y, x)
  int o0[3];     // the first owned node in the box (the low ghost width)
  int nout[3];   // the owned block
  int m0[3];     // the global interior in box coordinates, [m0, m1)
  int m1[3];
};

template <typename T, int D, int kMode>
__global__ void __launch_bounds__(kApplyThreads, kMinBlocks)
dpp_apply_halo_box_kernel(const T* __restrict__ z1, const T* __restrict__ z2, T* __restrict__ y1,
                      T* __restrict__ y2, DppWeights<T> w, HaloBoxGeom h) {
  __shared__ __align__(16) T stage[kStages][2][kPlaneValues];
  const int tx = threadIdx.x % kTileX, ty = threadIdx.x / kTileX;
  const int x0 = h.o0[2] + blockIdx.x * kTileX, y0 = h.o0[1] + blockIdx.y * kTileY;
  const long plane = (long)h.n[1] * h.n[2];
  const long oplane = (long)h.nout[1] * h.nout[2];
  // the owned planes this block computes, [kb, ke) in box coordinates, and
  // the planes it stages, kb - 1 .. ke (2D: the one plane)
  const int kb = D == 3 ? h.o0[0] + blockIdx.z * kChunk : 0;
  const int ke = D == 3 ? min(kb + kChunk, h.o0[0] + h.nout[0]) : 1;
  const int steps = D == 3 ? ke - kb + 2 : 1;
  const int pb = D == 3 ? kb - 1 : 0;

  int src[kStageLoads];
  bool in_box[kStageLoads], inner_xy[kStageLoads];
#pragma unroll
  for (int s = 0; s < kStageLoads; ++s) {
    const int e = threadIdx.x + s * kApplyThreads;
    const int r = e % kPlaneValues;
    const int gx = x0 + r % kHaloX - 1, gy = y0 + r / kHaloX - 1;
    in_box[s] = e < 2 * kPlaneValues && gx >= 0 && gx < h.n[2] && gy >= 0 && gy < h.n[1];
    inner_xy[s] = gx >= h.m0[2] && gx < h.m1[2] && gy >= h.m0[1] && gy < h.m1[1];
    src[s] = in_box[s] ? gy * h.n[2] + gx : 0;
  }
  auto stage_plane = [&](int p) {
    T* buf = &stage[(p - pb) % kStages][0][0];
    const bool inner_z = D == 2 || (p >= h.m0[0] && p < h.m1[0]);
    const bool z_in = D == 2 || (p >= 0 && p < h.n[0]);
#pragma unroll
    for (int s = 0; s < kStageLoads; ++s) {
      const int e = threadIdx.x + s * kApplyThreads;
      if (e < 2 * kPlaneValues) {
        const bool in = inner_xy[s] && inner_z;
        const bool keep = in_box[s] && z_in && (kMode == kMatvec ? in : !in);
        const T* base = e < kPlaneValues ? z1 : z2;
        copy_or_zero(buf + e, base + (keep ? p * plane + src[s] : 0), keep);
      }
    }
  };

  const int i = x0 + tx, j = y0 + ty;
  const bool write = i < h.o0[2] + h.nout[2] && j < h.o0[1] + h.nout[1];
  const bool stencil_xy = i >= h.m0[2] && i < h.m1[2] && j >= h.m0[1] && j < h.m1[1];
  const long col = (long)j * h.n[2] + i;
  const long ocol = (long)(j - h.o0[1]) * h.nout[2] + (i - h.o0[2]);
  const T* st0 = &stage[0][0][(ty + 1) * kHaloX + tx + 1];
  auto put = [&](int p, const T (&acc)[2]) {
    if (write) {
      const long o = (D == 3 ? (p - h.o0[0]) * oplane : 0) + ocol;
      if (stencil_xy && (D == 2 || (p >= h.m0[0] && p < h.m1[0]))) {
        y1[o] = kMode == kLift ? -acc[0] : acc[0];
        y2[o] = kMode == kLift ? -acc[1] : acc[1];
      } else {
        y1[o] = __ldg(z1 + p * plane + col);
        y2[o] = __ldg(z2 + p * plane + col);
      }
    }
  };

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < steps) stage_plane(pb + t);
    copies_commit();
  }
  T a[2] = {}, b[2] = {};
  for (int s = 0; s < steps; ++s) {
    const int p = pb + s;
    copies_wait<kStages - 2>();
    __syncthreads();
    const T* st = st0 + (s % kStages) * 2 * kPlaneValues;
    T c[2] = {};
    if constexpr (D == 2) {
      plane_terms<T, D, false, true, false>(a, b, c, st, w);
      put(p, b);
    } else {
      const bool ua = s >= 2, ub = s >= 1 && p < ke, uc = p + 1 < ke;
      if (ua && ub && uc) {
        plane_terms<T, D, true, true, true>(a, b, c, st, w);
      } else if (uc) {
        if (ub) {
          plane_terms<T, D, false, true, true>(a, b, c, st, w);
        } else {
          plane_terms<T, D, false, false, true>(a, b, c, st, w);
        }
      } else if (ua && ub) {
        plane_terms<T, D, true, true, false>(a, b, c, st, w);
      } else if (ua) {
        plane_terms<T, D, true, false, false>(a, b, c, st, w);
      } else {
        plane_terms<T, D, false, true, false>(a, b, c, st, w);
      }
      if (ua) put(p - 1, a);
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        a[f] = b[f];
        b[f] = c[f];
      }
      if (s + kStages - 1 < steps) stage_plane(p + kStages - 1);
      copies_commit();
    }
  }
}

template <typename T, int D>
cudaError_t launch_halo_box_dim(const T* z1, const T* z2, T* y1, T* y2, const DppWeights<T>& w,
                            const HaloBoxGeom& h, int mode, cudaStream_t st) {
  auto tiles = [](int n, int t) { return (n + t - 1) / t; };
  const dim3 grid(tiles(h.nout[2], kTileX), tiles(h.nout[1], kTileY), D == 3 ? tiles(h.nout[0], kChunk) : 1);
  if (mode == kMatvec) {
    dpp_apply_halo_box_kernel<T, D, kMatvec><<<grid, kApplyThreads, 0, st>>>(z1, z2, y1, y2, w, h);
  } else {
    dpp_apply_halo_box_kernel<T, D, kLift><<<grid, kApplyThreads, 0, st>>>(z1, z2, y1, y2, w, h);
  }
  return cudaGetLastError();
}

// geom: 12 host ints, (z, y, x) each: the low ghost widths, the high ghost
// widths, the global index of the first owned node and the physical node
// extents (2D: z is 0, 0, 0, 1).
template <typename T>
int launch_dpp_apply_halo_box(const T* z1, const T* z2, T* y1, T* y2, const double* weights, int nz,
                          int ny, int nx, int dim, int mode, const int* geom, void* stream) {
  if ((dim != 2 && dim != 3) || (dim == 2 && nz != 1) || (mode != kMatvec && mode != kLift) ||
      (long)ny * nx > (1L << 31) / 2) {
    return (int)cudaErrorInvalidValue;
  }
  HaloBoxGeom h;
  const int n[3] = {nz, ny, nx};
  for (int a = 0; a < 3; ++a) {
    const int lo = geom[a], hi = geom[3 + a], off = geom[6 + a], nphys = geom[9 + a];
    if (lo < 0 || lo > 1 || hi < 0 || hi > 1 || lo + hi > n[a] || off < 0 || nphys < 1) {
      return (int)cudaErrorInvalidValue;
    }
    h.n[a] = n[a];
    h.o0[a] = lo;
    h.nout[a] = n[a] - lo - hi;
    h.m0[a] = 1 - off + lo;
    h.m1[a] = nphys - 1 - off + lo;
    // a stencil row needs both neighbours in the box
    const int s0 = max(h.m0[a], h.o0[a]), s1 = min(h.m1[a], h.o0[a] + h.nout[a]);
    if (dim == 3 || a > 0) {
      if (s1 > s0 && (s0 < 1 || s1 > n[a] - 1)) return (int)cudaErrorInvalidValue;
    }
  }
  if (dim == 2) {
    h.m0[0] = 0;
    h.m1[0] = 1;
  }
  if ((long)h.nout[0] * h.nout[1] * h.nout[2] == 0) return (int)cudaSuccess;
  const DppWeights<T> w = weights_from_host<T>(weights);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dim == 3 ? launch_halo_box_dim<T, 3>(z1, z2, y1, y2, w, h, mode, st)
                        : launch_halo_box_dim<T, 2>(z1, z2, y1, y2, w, h, mode, st));
}

}  // namespace perphil

extern "C" int perphil_dpp_apply_halo_box_f32(const float* z1, const float* z2, float* y1, float* y2,
                                              const double* weights, int nz, int ny, int nx, int dim,
                                              int mode, const int* geom, void* stream) {
  return perphil::launch_dpp_apply_halo_box<float>(z1, z2, y1, y2, weights, nz, ny, nx, dim, mode, geom,
                                                   stream);
}

extern "C" int perphil_dpp_apply_halo_box_f64(const double* z1, const double* z2, double* y1, double* y2,
                                              const double* weights, int nz, int ny, int nx, int dim,
                                              int mode, const int* geom, void* stream) {
  return perphil::launch_dpp_apply_halo_box<double>(z1, z2, y1, y2, weights, nz, ny, nx, dim, mode, geom,
                                                    stream);
}
