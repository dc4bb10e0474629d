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
//
// The halo form (dpp_apply_halo_kernel, below) is the same tiled stencil on
// one block of a decomposed or padded grid: the owned block read with its
// neighbours' ghost planes where they arrived, the owned block written, the
// boundary decided by global index (parallel/halo.py, the sharded solves and
// the padded operators launch it).

#include <cstdint>

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

// K1's halo form: one block of a decomposed or padded grid.
//
// The box is the owned block with one ghost plane on either side of each
// split axis (a neighbour's values: read as stencil neighbours, never
// written); the output is the owned block. A node is a boundary (identity)
// row when its global index is 0 or at least n_phys - 1 on some axis (on a
// padded grid the phantom nodes beyond n_phys - 1 are boundary rows with
// zero data). In box coordinates the global interior is [m0, m1) per axis,
// and the owned stencil rows are [c0, c1): the interior within the owned
// range. Every other owned node writes its raw input.
//
// Bound on the H100: memory, as K1. An apply reads the owned block and the
// ghost planes once and writes the owned block: a 17-plane slab of the
// padded 136 x 129 x 129 grid (128^3 over 8 ranks) moves 9.6 MB in f64,
// 2.9 us at 3.35 TB/s.
//
// Design (the redesign of the first halo form, which is kept as the probe
// csrc/profile/dpp_apply_halo_box.cu):
//   - Tiled as K1: the 16 x 16 tiles and the z chunks cover the stencil rows
//     [c0, c1) only, and the first and last tile of each axis also write the
//     raw rows between it and the owned block's ends, as K1's edge tiles
//     write the box's sides: a plane of a 129^3 box is K1's 8 x 8 tiles
//     (the first form's 9 x 9 carried a ninth of one column). Phantom planes
//     past the face the last z chunk writes go to z blocks of their own, a
//     chunk of planes each, so that no stencil block carries them. The host
//     computes the plan (ops/fused_apply.py::halo_plan: tile origin c0, the
//     tile counts, the z chunk and its rule, fill_chunk, against the card's
//     wave, halo_wave below).
//   - The ghost planes are read from the buffers they arrive in: the input
//     is seven regions, the owned block and, per axis and side, the received
//     plane. The exchange goes dimension by dimension, so the plane of axis
//     a spans the ghost layers of the axes before it: a box node lies in the
//     region of the last axis on which it is a ghost, else in the owned
//     block. Each region has its own two field pointers and strides; a null
//     region (a grid edge) is the zero fill. A tile whose staged window
//     touches no x or y ghost (every tile of a z-slab) stages as K1 does: a
//     32-bit offset a value in the owned block's plane, one base a field
//     and plane (on a z ghost plane, the ghost's buffer: a plane with the
//     owned block's strides). A tile that touches one works out each staged
//     value's region and address once, and each plane adds its z stride.
//     The two are separate instantiations, so that the first carries none
//     of the second's registers (one path for both spilled, and ran 20%
//     slower on the whole box).
//   - The staging (cp.async ring, the mask folded into the zero fill), the
//     27 terms and their order are K1's, so a stencil row is K1's bits.
//
// Times (f64 matvecs, launches queued, in turns with the first form;
// NVIDIA H100 80GB HBM3, 700 W; tools/profile_kernels.py --only halo; the
// first form's in parentheses): the whole 129^3 box 0.0429-0.0431 ms
// (0.0549-0.0550; K1 0.0444), the padded 136 x 129 x 129 box 0.0430-0.0432
// (0.0589-0.0590), one 17-plane slab 0.0099-0.0100 (0.0120), 8 slabs
// 0.0857-0.0858 (0.1033), 2D N=1023 in 8 slabs 0.0406-0.0410 (0.0328-0.0329:
// one plane a block, so a block's fixed cost and the ghost rows' general
// tiles show).

// One region of the box, for both fields: node (z, y, x) of the box (box
// coordinates) is f[field][off + z * sz + y * sy + x].
template <typename T>
struct HaloRegion {
  const T* f[2];
  long off, sz, sy;
};

enum HaloRegionId { kOwn, kZLo, kZHi, kYLo, kYHi, kXLo, kXHi, kHaloRegions };

template <typename T>
struct HaloSources {
  HaloRegion<T> r[kHaloRegions];
  long zskip[2][2];  // [side][field]: a z ghost plane's address less the owned block's addressing there
};

struct HaloGeom {
  int n[3];     // the box, (z, y, x)
  int o0[3];    // the first owned node in the box (the low ghost width)
  int nout[3];  // the owned block
  int m0[3];    // the global interior in box coordinates, [m0, m1)
  int m1[3];
  int c0[3];    // the owned stencil rows, [c0, c1) (c1 == c0: none); the tiles start at c0
  int c1[3];
  int chunk;    // the z planes of a block's stencil rows, or of its raw planes
  int zc;       // the z blocks that walk stencil chunks; those after them write phantom planes
};

template <typename T>
__device__ __forceinline__ const T* region_at(const HaloRegion<T>& r, int f, int y, int x) {
  const T* base = f ? r.f[1] : r.f[0];
  return base == nullptr ? nullptr : base + (r.off + (long)y * r.sy + x);
}

// An index into [e0, e1) less [c0, c1) (e0 <= c0 <= c1 <= e1): the raw rows
// below the core, then above it.
__device__ __forceinline__ int outside(int r, int e0, int c0, int c1) {
  return r < c0 - e0 ? e0 + r : c1 + r - (c0 - e0);
}

// One block of the halo form. kGeneral: the tile's staged window touches an
// x or y ghost, so each staged value finds its region (the general
// staging); else every staged value lies in the owned block or a z ghost
// plane, or outside the box, and the staging is K1's (a 32-bit offset a
// value, one base a field and plane).
template <typename T, int D, int kMode, bool kGeneral>
__device__ __forceinline__ void halo_block(const HaloSources<T>& src, T* __restrict__ y1, T* __restrict__ y2,
                                           const DppWeights<T>& w, const HaloGeom& h,
                                           T (&stage)[kStages][2][kPlaneValues]) {
  const HaloRegion<T>& own = src.r[kOwn];
  // the block's stencil rows (its core): columns [x0, xe) x [y0, ye) and z
  // planes [kb, ke), empty on an axis with none; the planes it stages,
  // kb - 1 .. ke (2D: the one plane). The z blocks from zc on write
  // phantom planes only.
  const int tx = threadIdx.x % kTileX, ty = threadIdx.x / kTileX;
  const int x0 = h.c0[2] + blockIdx.x * kTileX, y0 = h.c0[1] + blockIdx.y * kTileY;
  const int xe = max(x0, min(x0 + kTileX, h.c1[2])), ye = max(y0, min(y0 + kTileY, h.c1[1]));
  const bool raw_planes = D == 3 && (int)blockIdx.z >= h.zc;
  const int zend = h.o0[0] + h.nout[0];
  // the raw planes' first: past the face the last stencil chunk writes
  const int zr0 = (h.zc > 0 ? h.c1[0] + 1 : h.o0[0]) + ((int)blockIdx.z - h.zc) * h.chunk;
  const int kb = D == 3 ? (raw_planes ? zr0 : h.c0[0] + blockIdx.z * h.chunk) : 0;
  const int ke = D == 3 ? (raw_planes ? kb : min(kb + h.chunk, h.c1[0])) : 1;
  const int steps = xe > x0 && ye > y0 && ke > kb ? (D == 3 ? ke - kb + 2 : 1) : 0;
  const int pb = D == 3 ? kb - 1 : 0;

  // the thread's share of a staged plane, per value: whether it is
  // interior in x/y and where it lies. General: its region's group (0: none,
  // the zero fill; 1: the owned block or a z ghost; 2: a y ghost; 3: an x
  // ghost) and its address on the box's plane 0. K1's: whether it lies in
  // the box, and its offset in an owned plane.
  const T* q[kStageLoads];
  int group[kStageLoads], off[kStageLoads];
  bool inner_xy[kStageLoads], in_box[kStageLoads];
#pragma unroll
  for (int s = 0; s < kStageLoads; ++s) {
    const int e = threadIdx.x + s * kApplyThreads;
    const int r = e % kPlaneValues, f = e < kPlaneValues ? 0 : 1;
    const int gx = x0 + r % kHaloX - 1, gy = y0 + r / kHaloX - 1;
    in_box[s] = e < 2 * kPlaneValues && gx >= 0 && gx < h.n[2] && gy >= 0 && gy < h.n[1];
    inner_xy[s] = gx >= h.m0[2] && gx < h.m1[2] && gy >= h.m0[1] && gy < h.m1[1];
    if constexpr (kGeneral) {
      const T* at = nullptr;
      int g = 0;
      if (in_box[s]) {
        if (gx < h.o0[2]) {
          at = region_at(src.r[kXLo], f, gy, gx), g = 3;
        } else if (gx >= h.o0[2] + h.nout[2]) {
          at = region_at(src.r[kXHi], f, gy, gx), g = 3;
        } else if (gy < h.o0[1]) {
          at = region_at(src.r[kYLo], f, gy, gx), g = 2;
        } else if (gy >= h.o0[1] + h.nout[1]) {
          at = region_at(src.r[kYHi], f, gy, gx), g = 2;
        } else {
          at = region_at(own, f, gy, gx), g = 1;
        }
      }
      q[s] = at;
      group[s] = at == nullptr ? 0 : g;
    } else {
      off[s] = in_box[s] ? gy * (int)own.sy + gx : 0;
    }
  }
  auto stage_plane = [&](int p) {
    T* buf = &stage[(p - pb) % kStages][0][0];
    const bool inner_z = D == 2 || (p >= h.m0[0] && p < h.m1[0]);
    // the owned group's z part: owned planes by the stride, a z ghost plane
    // from its buffer (none: the zero fill)
    const bool zlo = D == 3 && p < h.o0[0], zhi = D == 3 && p >= h.o0[0] + h.nout[0];
    const bool own_z = zlo ? src.r[kZLo].f[0] != nullptr : (zhi ? src.r[kZHi].f[0] != nullptr : true);
    const long zs0 = zlo ? src.zskip[0][0] : (zhi ? src.zskip[1][0] : 0);
    const long zs1 = zlo ? src.zskip[0][1] : (zhi ? src.zskip[1][1] : 0);
    // K1's: each field's base on this plane
    const T* base0 = own.f[0] + (own.off + p * own.sz + zs0);
    const T* base1 = own.f[1] + (own.off + p * own.sz + zs1);
#pragma unroll
    for (int s = 0; s < kStageLoads; ++s) {
      const int e = threadIdx.x + s * kApplyThreads;
      if (e < 2 * kPlaneValues) {
        const bool in = inner_xy[s] && inner_z;
        if constexpr (kGeneral) {
          const long step = group[s] == 3 ? p * src.r[kXLo].sz
                            : group[s] == 2 ? p * src.r[kYLo].sz
                                            : p * own.sz + (e < kPlaneValues ? zs0 : zs1);
          const bool keep = (group[s] > 1 || (group[s] == 1 && own_z)) && (kMode == kMatvec ? in : !in);
          copy_or_zero(buf + e, keep ? q[s] + step : own.f[0], keep);
        } else {
          const bool keep = in_box[s] && own_z && (kMode == kMatvec ? in : !in);
          copy_or_zero(buf + e, keep ? (e < kPlaneValues ? base0 : base1) + off[s] : own.f[0], keep);
        }
      }
    }
  };

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < steps) stage_plane(pb + t);
    copies_commit();
  }

  // the raw rows, while the first planes arrive. The block's share of the
  // owned block in x and y is its tile, extended to the owned block's ends
  // on the first and last tile of an axis. In z a stencil block's share is
  // its chunk, on the first chunk with the planes below it and on the last
  // with the next plane above it (the box's faces, as K1's); the z blocks
  // after the stencil chunks write the planes past that (phantoms), a chunk
  // of them each, so that they are spread over blocks of their own. The
  // share less the core, in three boxes: the planes outside the core; the
  // core's planes, rows outside it; the core's rows, columns outside it.
  {
    const int ex0 = blockIdx.x == 0 ? h.o0[2] : x0, ex1 = blockIdx.x == gridDim.x - 1 ? h.o0[2] + h.nout[2] : xe;
    const int ey0 = blockIdx.y == 0 ? h.o0[1] : y0, ey1 = blockIdx.y == gridDim.y - 1 ? h.o0[1] + h.nout[1] : ye;
    const int ez0 = D == 3 && !raw_planes && blockIdx.z == 0 ? h.o0[0] : kb;
    const int ez1 = D == 3 ? (raw_planes ? min(kb + h.chunk, zend) : ((int)blockIdx.z == h.zc - 1 ? min(ke + 1, zend)
                                                                                                     : ke))
                           : 1;
    const int exn = ex1 - ex0, eyn = ey1 - ey0, cyn = ye - y0, czn = ke - kb;
    const int rz = (kb - ez0) + (ez1 - ke), ry = (y0 - ey0) + (ey1 - ye), rx = (x0 - ex0) + (ex1 - xe);
    const int n1 = rz * eyn * exn, n2 = n1 + czn * ry * exn, n3 = n2 + czn * cyn * rx;
    for (int t = threadIdx.x; t < n3; t += kApplyThreads) {
      int z, y, x;
      if (t < n1) {
        x = ex0 + t % exn, y = ey0 + t / exn % eyn, z = outside(t / exn / eyn, ez0, kb, ke);
      } else if (t < n2) {
        const int u = t - n1;
        x = ex0 + u % exn, y = outside(u / exn % ry, ey0, y0, ye), z = kb + u / exn / ry;
      } else {
        const int u = t - n2;
        x = outside(u % rx, ex0, x0, xe), y = y0 + u / rx % cyn, z = kb + u / rx / cyn;
      }
      const long i = own.off + (long)z * own.sz + (long)y * own.sy + x;
      const long o = ((long)(z - h.o0[0]) * h.nout[1] + (y - h.o0[1])) * h.nout[2] + (x - h.o0[2]);
      y1[o] = __ldg(own.f[0] + i);
      y2[o] = __ldg(own.f[1] + i);
    }
  }

  const int i = x0 + tx, j = y0 + ty;
  const bool write = i < xe && j < ye;
  const long oplane = (long)h.nout[1] * h.nout[2];
  const long ocol = (long)(j - h.o0[1]) * h.nout[2] + (i - h.o0[2]);
  const T* st0 = &stage[0][0][(ty + 1) * kHaloX + tx + 1];
  auto put = [&](int p, const T (&acc)[2]) {
    if (write) {
      const long o = (D == 3 ? (p - h.o0[0]) * oplane : 0) + ocol;
      y1[o] = kMode == kLift ? -acc[0] : acc[0];
      y2[o] = kMode == kLift ? -acc[1] : acc[1];
    }
  };

  // K1's walk (dpp_apply_kernel), its terms in its order
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

template <typename T, int D, int kMode>
__global__ void __launch_bounds__(kApplyThreads, kMinBlocks)
dpp_apply_halo_kernel(const HaloSources<T> src, T* __restrict__ y1, T* __restrict__ y2, DppWeights<T> w,
                      HaloGeom h) {
  __shared__ __align__(16) T stage[kStages][2][kPlaneValues];
  // whether the tile's staged window (its columns and rows and one around
  // them) touches a ghost in x or y (block-uniform)
  const int x0 = h.c0[2] + blockIdx.x * kTileX, y0 = h.c0[1] + blockIdx.y * kTileY;
  const int xh = h.o0[2] + h.nout[2], yh = h.o0[1] + h.nout[1];
  const bool general = (h.o0[2] > 0 && x0 - 1 < h.o0[2]) || (h.n[2] > xh && x0 + kTileX >= xh) ||
                       (h.o0[1] > 0 && y0 - 1 < h.o0[1]) || (h.n[1] > yh && y0 + kTileY >= yh);
  if (general) {
    halo_block<T, D, kMode, true>(src, y1, y2, w, h, stage);
  } else {
    halo_block<T, D, kMode, false>(src, y1, y2, w, h, stage);
  }
}

template <typename T, int D>
cudaError_t launch_halo_dim(const HaloSources<T>& src, T* y1, T* y2, const DppWeights<T>& w, const HaloGeom& h,
                            const dim3& grid, int mode, cudaStream_t st) {
  if (mode == kMatvec) {
    dpp_apply_halo_kernel<T, D, kMatvec><<<grid, kApplyThreads, 0, st>>>(src, y1, y2, w, h);
  } else {
    dpp_apply_halo_kernel<T, D, kLift><<<grid, kApplyThreads, 0, st>>>(src, y1, y2, w, h);
  }
  return cudaGetLastError();
}

// regions: 7 x 5 host int64s, one row a region (kOwn, kZLo, kZHi, kYLo,
// kYHi, kXLo, kXHi): the two fields' addresses (0: none, the zero fill),
// off, sz, sy. plan: 26 host ints, (z, y, x) each: the box, the low ghost
// widths, the owned block, [m0, m1), [c0, c1); then the z chunk, the z
// blocks that walk stencil chunks and the blocks along (z, y, x). 2D: z is
// the unit axis.
template <typename T>
int launch_dpp_apply_halo(const long long* regions, T* y1, T* y2, const double* weights, int dim, int mode,
                          const int* plan, void* stream) {
  if ((dim != 2 && dim != 3) || (mode != kMatvec && mode != kLift) || regions[0] == 0 || regions[1] == 0) {
    return (int)cudaErrorInvalidValue;
  }
  HaloGeom h;
  for (int a = 0; a < 3; ++a) {
    h.n[a] = plan[a];
    h.o0[a] = plan[3 + a];
    h.nout[a] = plan[6 + a];
    h.m0[a] = plan[9 + a];
    h.m1[a] = plan[12 + a];
    h.c0[a] = plan[15 + a];
    h.c1[a] = plan[18 + a];
    if (h.o0[a] < 0 || h.o0[a] > 1 || h.nout[a] < 1 || h.o0[a] + h.nout[a] > h.n[a] || h.n[a] - h.o0[a] - h.nout[a] > 1 ||
        h.c1[a] < h.c0[a] || h.c0[a] < h.o0[a] || h.c1[a] > h.o0[a] + h.nout[a] ||
        (h.c1[a] > h.c0[a] && (dim == 3 || a > 0) && (h.c0[a] < 1 || h.c1[a] > h.n[a] - 1 || h.c0[a] < h.m0[a] || h.c1[a] > h.m1[a]))) {
      return (int)cudaErrorInvalidValue;
    }
  }
  h.chunk = plan[21];
  h.zc = plan[22];
  const dim3 grid(plan[25], plan[24], plan[23]);
  if ((dim == 2 && (h.n[0] != 1 || h.o0[0] != 0 || h.c0[0] != 0 || h.c1[0] != 1)) || h.chunk < 1 ||
      h.zc < 0 || h.zc > (int)grid.z ||
      (long)h.n[1] * h.n[2] > (1L << 31) / 2 || grid.x < 1 || grid.y < 1 || grid.z < 1 || grid.y > 65535 ||
      grid.z > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  HaloSources<T> src;
  for (int r = 0; r < kHaloRegions; ++r) {
    const long long* row = regions + 5 * r;
    src.r[r] = {{reinterpret_cast<const T*>(row[0]), reinterpret_cast<const T*>(row[1])}, (long)row[2],
                (long)row[3], (long)row[4]};
    if ((row[0] == 0) != (row[1] == 0)) return (int)cudaErrorInvalidValue;
  }
  // the two sides of an axis share their strides; a z ghost plane has the
  // owned block's
  for (int r = kZLo; r < kHaloRegions; r += 2) {
    if (src.r[r].sz != src.r[r + 1].sz || src.r[r].sy != src.r[r + 1].sy) return (int)cudaErrorInvalidValue;
  }
  const HaloRegion<T>& own = src.r[kOwn];
  for (int side = 0; side < 2; ++side) {
    const HaloRegion<T>& zg = src.r[kZLo + side];
    if (zg.f[0] != nullptr && (zg.sz != own.sz || zg.sy != own.sy)) return (int)cudaErrorInvalidValue;
    for (int f = 0; f < 2; ++f) {
      const long long bytes = zg.f[0] == nullptr ? 0 : (long long)((intptr_t)zg.f[f] - (intptr_t)own.f[f]);
      if (bytes % (long long)sizeof(T)) return (int)cudaErrorInvalidValue;
      src.zskip[side][f] = (long)(bytes / (long long)sizeof(T)) + zg.off - own.off;
    }
  }
  const DppWeights<T> w = weights_from_host<T>(weights);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dim == 3 ? launch_halo_dim<T, 3>(src, y1, y2, w, h, grid, mode, st)
                        : launch_halo_dim<T, 2>(src, y1, y2, w, h, grid, mode, st));
}

// The blocks of the halo form that the card holds at once: blocks an SM
// holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor) times its SMs.
template <typename T, int D>
int halo_wave() {
  int dev = 0, per_sm = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dpp_apply_halo_kernel<T, D, kMatvec>,
                                                        kApplyThreads, 0);
  }
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return err == cudaSuccess ? per_sm * sms : -(int)err;
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

extern "C" int perphil_dpp_apply_halo_f32(const long long* regions, float* y1, float* y2, const double* weights,
                                          int dim, int mode, const int* plan, void* stream) {
  return perphil::launch_dpp_apply_halo<float>(regions, y1, y2, weights, dim, mode, plan, stream);
}

extern "C" int perphil_dpp_apply_halo_f64(const long long* regions, double* y1, double* y2, const double* weights,
                                          int dim, int mode, const int* plan, void* stream) {
  return perphil::launch_dpp_apply_halo<double>(regions, y1, y2, weights, dim, mode, plan, stream);
}

// The halo form's wave on the current device (f64: 1 for double, 0 for
// float); a negative CUDA error on failure.
extern "C" int perphil_dpp_apply_halo_wave(int dim, int f64) {
  if (dim != 2 && dim != 3) return -(int)cudaErrorInvalidValue;
  if (f64) return dim == 3 ? perphil::halo_wave<double, 3>() : perphil::halo_wave<double, 2>();
  return dim == 3 ? perphil::halo_wave<float, 3>() : perphil::halo_wave<float, 2>();
}
