// K1: the fused two-field DPP stencil apply.
//
// Replaces perphil_tpu/ops/pallas_kernels.py::fused_dpp_apply (pallas_call at
// :139, body _make_kernel at :42), which computes y1 = S1*z1 + C*z2 and
// y2 = C*z1 + S2*z2 over halo'd VMEM tiles, f32 only, with the boundary
// masking left to XLA outside the kernel.
//
// The box boundary is folded in (i == 0 || i == n-1 per axis), so no mask
// array is read, in two modes: kMatvec (interior-masked input, identity
// boundary rows) and kLift (boundary-only input, -A[int,bd] g on the
// interior, g on the boundary). The 3 x 27 weights travel by value in the
// launch parameters. Templated on float/double and on dimension 2/3.
//
// Bound on the H100: memory, with the arithmetic close behind in f64. A node
// reads 2 values and writes 2: at 128^3 hex (129^3 nodes) in f64, 68.7 MB,
// 20.5 us at 3.35 TB/s. Its 27 terms for each of its two outputs are 162
// f64 instructions (the first design's DMUL, DFMA, DADD a term, kept for
// its bits): ~20 us at the card's f64 rate. A thread per node that read its 54 neighbours through L1
// (the first design) took 0.067 ms there, launches queued, on an NVIDIA H100
// 80GB HBM3 at 700 W; this one 0.043 ms (tools/profile_kernels.py --only k1;
// PERF.md says what bounds it).
//
// Design (a 2.5-D tiled stencil):
//   - A block of 256 threads owns a 16 x 16 tile of the interior's (y, x)
//     columns (a 129-node axis is 8 tiles) and a chunk of its z planes;
//     coordinates come from the launch grid, not from a division per node.
//     The box's sides and faces are written by the blocks next to them.
//   - It walks its chunk along z. Each step stages one plane of both fields
//     with its 1-node halo (2 x 18 x 18 values) in shared memory by
//     cp.async, a ring of kStages buffers, so the next planes' copies
//     overlap this plane's sums.
//   - The boundary is folded in at staging: the copy of a node the mode
//     leaves out (matvec: a boundary node; lift: an interior one) is the
//     cp.async zero fill, so the 27-point sum runs without a branch. Adding
//     an exact zero changes no sum: a term s*0 + c*0 is +-0, and a partial
//     sum that starts at +0 never becomes -0. Boundary rows write their raw
//     input.
//   - A thread keeps its column's partial sums for the three output planes
//     the staged plane touches (its dz = +1, 0, -1 terms): each staged value
//     is read from shared memory once per column (18 loads a node) and feeds
//     all three.
//   - Every output keeps the first design's order and expression: offsets
//     dz, dy, dx ascending, each term a += s*u + c*v (term below), so
//     K1's bits are that design's (the host routes' counts rest on them).
//   - 2D is the same kernel with one plane.

#include "dpp_stencil.cuh"

namespace perphil {

// Tuning, each measured on 128^3 f64 matvecs on an NVIDIA H100 80GB HBM3 at
// 700 W (tools/profile_kernels.py --only k1 builds the kernel alone with
// other values):
//   - kTileX: 16-wide tiles (32 x 8: 0.0437 ms against 0.0431);
//   - kMinBlocks: the blocks an SM must be able to hold, which bounds a
//     thread's registers (left free, nvcc took 134 and an SM held one block:
//     0.081 ms, against 0.043 at 4 blocks and 64 registers; 5, 6 and 8 blocks
//     spill); two rows a thread, built and measured, spilled at 64 registers
//     (0.051-0.057 ms);
//   - kStages: the planes a block stages, all but one in flight while it
//     sums (4: 0.0431 ms, 3: 0.0438);
//   - kChunk: the z planes a block walks (4 best of 1-32 at 64^3 and 128^3).
constexpr int kApplyThreads = 256;
constexpr int kTileX = 16;
constexpr int kMinBlocks = 4;
constexpr int kStages = 4;
constexpr int kChunk = 4;
constexpr int kTileY = kApplyThreads / kTileX;  // a block's outputs in a plane
constexpr int kHaloX = kTileX + 2, kHaloY = kTileY + 2;
constexpr int kPlaneValues = kHaloX * kHaloY;  // one field's staged plane
constexpr int kStageLoads = (2 * kPlaneValues + kApplyThreads - 1) / kApplyThreads;

// Copy one value to shared memory, or write a zero there (the zero fill:
// no byte is read when keep is false).
template <typename T>
__device__ __forceinline__ void copy_or_zero(T* dst, const T* src, bool keep) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = keep ? (int)sizeof(T) : 0;
  if constexpr (sizeof(T) == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n));
  }
}

__device__ __forceinline__ void copies_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// One term of an output's sum: a += s*u + c*v, as the compiler contracts it.
template <typename T>
__device__ __forceinline__ void term(T& a1, T& a2, const DppWeights<T>& w, int o, T u, T v) {
  a1 += w.s1[o] * u + w.c[o] * v;
  a2 += w.c[o] * u + w.s2[o] * v;
}

// The terms a staged plane adds to the three outputs it touches, each
// staged value loaded once: a (the plane above it, weights 18..26), b (its
// own, 9..17; 2D: 0..8) and c (the plane below, 0..8), each chain's offsets
// ascending. kA, kB, kC: which outputs this step computes.
template <typename T, int D, bool kA, bool kB, bool kC>
__device__ __forceinline__ void plane_terms(T (&a)[2], T (&b)[2], T (&c)[2], const T* st,
                                            const DppWeights<T>& w) {
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    const int off = (q / 3 - 1) * kHaloX + (q % 3 - 1);
    const T u = st[off], v = st[kPlaneValues + off];
    if constexpr (kA) term(a[0], a[1], w, 18 + q, u, v);
    if constexpr (kB) term(b[0], b[1], w, (D == 3 ? 9 : 0) + q, u, v);
    if constexpr (kC) term(c[0], c[1], w, q, u, v);
  }
}

template <typename T, int D, int kMode>
__global__ void __launch_bounds__(kApplyThreads, kMinBlocks)
dpp_apply_kernel(const T* __restrict__ z1, const T* __restrict__ z2, T* __restrict__ y1,
                 T* __restrict__ y2, DppWeights<T> w, Grid g) {
  __shared__ __align__(16) T stage[kStages][2][kPlaneValues];
  // the tile: interior columns x0.., y0.. (a 129-node axis is 8 tiles of 16)
  const int tx = threadIdx.x % kTileX, ty = threadIdx.x / kTileX;
  const int x0 = 1 + blockIdx.x * kTileX, y0 = 1 + blockIdx.y * kTileY;
  const long plane = (long)g.ny * g.nx;
  // the interior planes this block computes, [kb, ke), and the planes it
  // stages, kb - 1 .. ke (2D: the one plane)
  const int kb = D == 3 ? 1 + blockIdx.z * kChunk : 0;
  const int ke = D == 3 ? min(kb + kChunk, g.nz - 1) : 1;
  const bool inner = g.nx > 2 && g.ny > 2 && ke > kb;
  const int steps = inner ? (D == 3 ? ke - kb + 2 : 1) : 0;
  const int pb = D == 3 ? kb - 1 : 0;
  // what the block writes: its tile, and on the box's sides and faces the
  // next column, row or plane out, where it lies on the grid
  const bool first_x = blockIdx.x == 0, last_x = blockIdx.x == gridDim.x - 1;
  const bool first_y = blockIdx.y == 0, last_y = blockIdx.y == gridDim.y - 1;
  const int zo0 = D == 3 && blockIdx.z == 0 ? 0 : kb;
  const int zo1 = D == 2 ? 1 : (blockIdx.z == gridDim.z - 1 ? g.nz : ke);

  // the thread's share of a staged plane: per value, its place in a plane
  // of the grid, whether it lies in the grid and whether in its interior
  int src[kStageLoads];
  bool in_grid[kStageLoads], inner_xy[kStageLoads];
#pragma unroll
  for (int s = 0; s < kStageLoads; ++s) {
    const int e = threadIdx.x + s * kApplyThreads;
    const int r = e % kPlaneValues;
    const int gx = x0 + r % kHaloX - 1, gy = y0 + r / kHaloX - 1;
    in_grid[s] = e < 2 * kPlaneValues && gx < g.nx && gy < g.ny;
    inner_xy[s] = gx >= 1 && gx <= g.nx - 2 && gy >= 1 && gy <= g.ny - 2;
    src[s] = in_grid[s] ? gy * g.nx + gx : 0;
  }
  auto stage_plane = [&](int p) {
    T* buf = &stage[(p - pb) % kStages][0][0];
    const bool inner_z = D == 2 || (p >= 1 && p <= g.nz - 2);
#pragma unroll
    for (int s = 0; s < kStageLoads; ++s) {
      const int e = threadIdx.x + s * kApplyThreads;
      if (e < 2 * kPlaneValues) {
        const bool in = inner_xy[s] && inner_z;
        const bool keep = in_grid[s] && (kMode == kMatvec ? in : !in);
        const T* base = e < kPlaneValues ? z1 : z2;
        copy_or_zero(buf + e, base + (keep ? p * plane + src[s] : 0), keep);
      }
    }
  };
  auto raw = [&](int z, int x, int y) {
    const long idx = z * plane + (long)y * g.nx + x;
    y1[idx] = __ldg(z1 + idx);
    y2[idx] = __ldg(z2 + idx);
  };

  // boundary rows, the raw input: the tile's own on the faces (and on the
  // far sides, where the last tile reaches them), then the sides' columns
  // around the tile that this block owns
  const int i = x0 + tx, j = y0 + ty;
  const bool column = i < g.nx && j < g.ny;
  const bool side = i == g.nx - 1 || j == g.ny - 1;
  if (column) {
    for (int z = zo0; z < zo1; ++z) {
      if (side || (D == 3 && (z == 0 || z == g.nz - 1))) raw(z, i, j);
    }
  }
  if (threadIdx.x < 2 * kHaloX + 2 * kTileY) {
    const int t = threadIdx.x;
    const int lx = t < 2 * kHaloX ? t % kHaloX - 1 : (t < 2 * kHaloX + kTileY ? -1 : kTileX);
    const int ly = t < 2 * kHaloX ? (t < kHaloX ? -1 : kTileY) : (t - 2 * kHaloX) % kTileY;
    const int x = x0 + lx, y = y0 + ly;
    const bool own_x = (lx >= 0 && lx < kTileX) || (lx < 0 && first_x) || (lx == kTileX && last_x);
    const bool own_y = (ly >= 0 && ly < kTileY) || (ly < 0 && first_y) || (ly == kTileY && last_y);
    if (own_x && own_y && x < g.nx && y < g.ny) {
      for (int z = zo0; z < zo1; ++z) raw(z, x, y);
    }
  }
  const bool write = column && !side;
  const long col = (long)j * g.nx + i;
  const T* st0 = &stage[0][0][(ty + 1) * kHaloX + tx + 1];
  auto put = [&](int p, const T (&acc)[2]) {
    if (write) {
      y1[p * plane + col] = kMode == kLift ? -acc[0] : acc[0];
      y2[p * plane + col] = kMode == kLift ? -acc[1] : acc[1];
    }
  };

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < steps) stage_plane(pb + t);
    copies_commit();
  }
  // a: the output plane p - 1 (its dz = -1, 0 terms so far); b: plane p
  // (dz = -1); c: plane p + 1
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
      // the outputs this plane touches that the block computes
      const bool ua = s >= 2, ub = s >= 1 && p < ke, uc = p + 1 < ke;
      if (ua && ub && uc) {
        plane_terms<T, D, true, true, true>(a, b, c, st, w);
      } else if (uc) {  // the first planes: b only from the second
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
      // the buffer of the plane kStages - 1 ahead held plane p - 1, which
      // every thread read before this step's barrier
      if (s + kStages - 1 < steps) stage_plane(p + kStages - 1);
      copies_commit();
    }
  }
}

template <typename T, int D>
cudaError_t launch_dim(const T* z1, const T* z2, T* y1, T* y2, const DppWeights<T>& w, const Grid& g,
                       int mode, cudaStream_t st) {
  // tiles over the interior (at least one, which then writes the sides)
  auto tiles = [](int n, int t) { return n > 2 ? (n - 2 + t - 1) / t : 1; };
  const dim3 grid(tiles(g.nx, kTileX), tiles(g.ny, kTileY), D == 3 ? tiles(g.nz, kChunk) : 1);
  if (mode == kMatvec) {
    dpp_apply_kernel<T, D, kMatvec><<<grid, kApplyThreads, 0, st>>>(z1, z2, y1, y2, w, g);
  } else {
    dpp_apply_kernel<T, D, kLift><<<grid, kApplyThreads, 0, st>>>(z1, z2, y1, y2, w, g);
  }
  return cudaGetLastError();
}

template <typename T>
int launch_dpp_apply(const T* z1, const T* z2, T* y1, T* y2, const double* weights, int nz, int ny,
                     int nx, int dim, int mode, void* stream) {
  const Grid g{nz, ny, nx};
  if (g.nodes() == 0) return (int)cudaSuccess;
  if ((dim != 2 && dim != 3) || (dim == 2 && nz != 1) || (mode != kMatvec && mode != kLift) ||
      (long)g.ny * g.nx > (1L << 31) / 2) {
    return (int)cudaErrorInvalidValue;
  }
  const DppWeights<T> w = weights_from_host<T>(weights);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dim == 3 ? launch_dim<T, 3>(z1, z2, y1, y2, w, g, mode, st)
                        : launch_dim<T, 2>(z1, z2, y1, y2, w, g, mode, st));
}

}  // namespace perphil

extern "C" int perphil_dpp_apply_f32(const float* z1, const float* z2, float* y1, float* y2,
                                     const double* weights, int nz, int ny, int nx, int dim, int mode,
                                     void* stream) {
  return perphil::launch_dpp_apply<float>(z1, z2, y1, y2, weights, nz, ny, nx, dim, mode, stream);
}

extern "C" int perphil_dpp_apply_f64(const double* z1, const double* z2, double* y1, double* y2,
                                     const double* weights, int nz, int ny, int nx, int dim, int mode,
                                     void* stream) {
  return perphil::launch_dpp_apply<double>(z1, z2, y1, y2, weights, nz, ny, nx, dim, mode, stream);
}

extern "C" const char* perphil_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
