// The fused GMRES kernel with its phase clocks compiled in: built only by
// tools/profile_kernels.py, never into the package's library. This unit holds
// the launcher (perphil_fused_gmres_profile: perphil_fused_gmres's arguments;
// result then holds kResultSlots + kProfPhases f64, the last the cycles block
// 0's thread 0 spent in each ProfPhase) and pc none / jacobi; the other
// preconditioners are instantiated in the units beside it, one nvcc each.

#define PERPHIL_GMRES_PROFILE 1
#define PERPHIL_FUSED_GMRES_SYMBOL perphil_fused_gmres_profile
#define PERPHIL_FUSED_GMRES_SMEM_SYMBOL perphil_fused_gmres_profile_static_smem
#include "../fused_gmres_kernel.cuh"

namespace perphil {  // built by the units beside this one, not here

extern template cudaError_t launch_fused_gmres<kPcFieldsplitLu>(const GmresArgs&, cudaStream_t);
extern template int fused_gmres_static_smem<kPcFieldsplitLu>(int);
extern template cudaError_t launch_fused_gmres<kPcIlu>(const GmresArgs&, cudaStream_t);
extern template int fused_gmres_static_smem<kPcIlu>(int);
extern template cudaError_t launch_fused_gmres<kPcFieldsplitIlu>(const GmresArgs&, cudaStream_t);
extern template int fused_gmres_static_smem<kPcFieldsplitIlu>(int);

}  // namespace perphil

#include "../fused_gmres.cu"

namespace perphil {

template cudaError_t launch_fused_gmres<kPcNone>(const GmresArgs&, cudaStream_t);
template int fused_gmres_static_smem<kPcNone>(int);
template cudaError_t launch_fused_gmres<kPcJacobi>(const GmresArgs&, cudaStream_t);
template int fused_gmres_static_smem<kPcJacobi>(int);

}  // namespace perphil
