// fused_gmres_k8_ring: K8 (the fused GMRES kernel with pc fieldsplit_ilu,
// fused_gmres.cuh) as it stood before its field sweeps became a line
// pipeline (field_sweep.cuh): every field's ILU(0) sweep pair on the ring of
// ilu_sweep.cuh on block 0, behind block 0's copy of the right-hand side,
// with the ring's shared-memory plan. Kept as a probe: tools/profile_kernels.py
// --only fieldsplit and chip_smoke.py's k8_turns time it in turns with the
// package's K8 (ops/fused_gmres.py::k8_probe_library). Built alone (one
// nvcc, -DPERPHIL_K8_PROBE); the package's launcher never builds it, and its
// launches are counted nowhere. Built with -DPERPHIL_K8_LINE_SLOTS=k instead,
// it is the line pipeline with k lines a lane (the probe of that choice);
// with -DPERPHIL_K8_EXTRA_STEPS=e, the package's pipeline with e empty steps
// more at the end of every warp's sweep (the probe of an empty step's cost).
// Its launcher is perphil_fused_gmres's, for pc fieldsplit_ilu only.

#if !defined(PERPHIL_K8_LINE_SLOTS) && !defined(PERPHIL_K8_EXTRA_STEPS)
#define PERPHIL_K8_RING 1
#endif
#define PERPHIL_FUSED_GMRES_SYMBOL perphil_fused_gmres_k8_probe
#define PERPHIL_FUSED_GMRES_SMEM_SYMBOL perphil_fused_gmres_k8_probe_static_smem
#define PERPHIL_FUSED_GMRES_ONLY kPcFieldsplitIlu
#include "../fused_gmres_kernel.cuh"

namespace perphil {

template cudaError_t launch_fused_gmres<kPcFieldsplitIlu>(const GmresArgs&, cudaStream_t);
template int fused_gmres_static_smem<kPcFieldsplitIlu>(int);

}  // namespace perphil

#include "../fused_gmres.cu"
