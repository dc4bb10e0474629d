// structured_ilu_apply: one structured ILU(0) application z = U^{-1} L^{-1} r
// in one thread block, for StructuredILU0.apply_flat on the card beyond the
// fused GMRES envelope (the monolithic ILU of GMRES+ILU at 2D N=128/256, the
// per-field ILU of the inner GMRES blocks of SS-GMRES+ILU there).
//
// Replaces no Pallas kernel: in the JAX package this apply is XLA
// (perphil_tpu/ops/ilu.py:716-728, StructuredILU0.apply_flat, a lax.scan over
// padded level batches, or the parallel-prefix trisolves). A torch-op
// wavefront would cost ~15 launches per level, ~12,000 per apply at 2D
// N=128; here it is one launch.
//
// Bound on the H100: latency. Two sweeps of nlev levels each (2D N=128:
// 389), one barrier per level, and a level holds at most a few hundred rows,
// so one SM works and the bytes (the factor, 27 offsets x 33,282 rows x 8 B =
// 7.2 MB at N=128, once per apply) are far from what limits it, as long as
// they come in runs: the factor is read packed by level. What the
// design does about it (ilu_sweep.cuh): nothing but z[col] is loaded after a
// level's barrier. Producer warps run ahead and bring each level's row
// indices, factor entries, right-hand side and diagonal into a ring of
// shared-memory stages with cp.async, signalled through mbarriers; only as
// many consumer warps as the widest level needs meet at the per-level
// barrier; a row's z loads go out together, ahead of its chain of
// differences; and z lives in the block's dynamic shared memory where nrows
// doubles fit beside the ring (a 129^2 field system: 133 KB), else in device
// memory (2D N=128 monolithic: 266 KB), read back through L2 once a level.
//
// structured_ilu_apply[gs], the same sweep in its Gauss-Seidel mode: one
// forward lexicographic Gauss-Seidel sweep of the BC-eliminated monolithic
// system, for GaussSeidelSweeper.sweep (the SNES ngs Picard solve on
// tri/hex/tet meshes). Replaces no Pallas kernel either: in the JAX package
// this sweep is XLA (perphil_tpu/ops/ilu.py:840-854,
// GaussSeidelSweeper.sweep, the wavefront scan _leveled_clip_sweep with
// scale_diag, or the parallel-prefix PartriGS). The levels, the ring and z
// are the ILU sweep's; a stage holds every off-centre entry of a row (26 in
// 2D, 80 in 3D) and its diagonal, and z starts at the iterate.

#include "ilu_sweep.cuh"

namespace perphil {

constexpr int kIluThreads = 512;

__global__ void __launch_bounds__(kIluThreads)
ilu_apply_kernel(const double* r, double* z, double* y, const double* PL, const double* PU,
                 const int* level_ptr,
                 const int* level_rows, IluMeta meta, IluPlan plan, int nrows, int nlev) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ IluMeta m;
  if (threadIdx.x == 0) m = meta;
  const IluStage st = ilu_stage(plan, dyn, level_ptr, nrows, nlev);  // ends with a barrier
  ilu_apply(PL, PU, nrows, m, st, level_rows, nlev, r, y, z);
}

__global__ void __launch_bounds__(kIluThreads)
gs_sweep_kernel(const double* x, const double* b, double* z, const double* P, const int* level_ptr,
                const int* level_rows, IluMeta meta, IluPlan plan, int nrows, int nlev) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ IluMeta m;
  if (threadIdx.x == 0) m = meta;
  const IluStage st = ilu_stage(plan, dyn, level_ptr, nrows, nlev);  // ends with a barrier
  ilu_sweep<false, -1, true>(P, nrows, m, st, level_rows, nlev, b, z, x);
}

// Shared by both launchers: the plan within what the kernel's static shared
// memory leaves, its attribute set, and the geometry reported.
template <class Kernel>
cudaError_t plan_launch(Kernel kern, const IluMeta& m, int nrows, int nlev, int max_rows, bool gs,
                        IluPlan& plan, int* geometry) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kern);
  if (err != cudaSuccess) return err;
  const long budget = kMaxSmemPerBlock - (long)fa.sharedSizeBytes;
  plan = ilu_plan(m, nrows, nlev, max_rows, budget, gs);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.bytes);
  if (err != cudaSuccess) return err;
  if (geometry != nullptr) {
    geometry[0] = plan.stages;
    geometry[1] = plan.z_smem;
    geometry[2] = plan.bytes;
    geometry[3] = (int)budget;
  }
  return cudaSuccess;
}

}  // namespace perphil

// r, z, y: (nrows,) f64 (y is scratch); PL, PU: the f64 factor's lower and
// upper sides packed by level (ops/ilu.py StructuredILU0.packed_lower/upper);
// level_ptr: (nlev + 1,) int32, level_rows: (nrows,) int32; meta: the host
// int32 offset table (ops/ilu.py StructuredILU0.meta); max_rows: the rows of
// the widest level. geometry, when not null, receives on the host
// [ring stages (0: the direct loop), z in shared memory, dynamic bytes, the
// dynamic shared memory the launch could have had].
extern "C" int perphil_structured_ilu_apply(const double* r, double* z, double* y, const double* PL,
                                            const double* PU, const int* level_ptr, const int* level_rows,
                                            const int* meta, int noffs, int nrows, int nlev,
                                            int max_rows, int* geometry, void* stream) {
  using namespace perphil;
  IluMeta m;
  if (nrows < 1 || nlev < 1 || max_rows < 1 || !ilu_meta_from_host(meta, noffs, m)) {
    return (int)cudaErrorInvalidValue;
  }
  IluPlan plan;
  const cudaError_t err = plan_launch(ilu_apply_kernel, m, nrows, nlev, max_rows, false, plan, geometry);
  if (err != cudaSuccess) return (int)err;
  ilu_apply_kernel<<<1, kIluThreads, plan.bytes, static_cast<cudaStream_t>(stream)>>>(
      r, z, y, PL, PU, level_ptr, level_rows, m, plan, nrows, nlev);
  return (int)cudaGetLastError();
}

// x, b, z: (nrows,) f64 (z = the iterate after one forward sweep from x);
// P: the monolithic matrix packed by level (ops/ilu.py
// GaussSeidelSweeper.packed: per level [q][r], q the off-centre offsets in
// stored order, then the diagonal); level_ptr, level_rows, meta, max_rows,
// geometry: as for perphil_structured_ilu_apply.
extern "C" int perphil_gs_sweep(const double* x, const double* b, double* z, const double* P,
                                const int* level_ptr, const int* level_rows, const int* meta, int noffs,
                                int nrows, int nlev, int max_rows, int* geometry, void* stream) {
  using namespace perphil;
  IluMeta m;
  if (nrows < 1 || nlev < 1 || max_rows < 1 || !ilu_meta_from_host(meta, noffs, m) ||
      m.nlow + m.nup != noffs - 1) {
    return (int)cudaErrorInvalidValue;
  }
  IluPlan plan;
  const cudaError_t err = plan_launch(gs_sweep_kernel, m, nrows, nlev, max_rows, true, plan, geometry);
  if (err != cudaSuccess) return (int)err;
  gs_sweep_kernel<<<1, kIluThreads, plan.bytes, static_cast<cudaStream_t>(stream)>>>(
      x, b, z, P, level_ptr, level_rows, m, plan, nrows, nlev);
  return (int)cudaGetLastError();
}
