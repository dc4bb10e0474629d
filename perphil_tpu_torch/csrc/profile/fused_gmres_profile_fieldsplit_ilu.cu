// The fused GMRES kernel for pc fieldsplit_ilu with its phase clocks compiled in
// (fused_gmres_profile.cu holds the launcher).

#define PERPHIL_GMRES_PROFILE 1
#include "../fused_gmres_kernel.cuh"

namespace perphil {

template cudaError_t launch_fused_gmres<kPcFieldsplitIlu>(const GmresArgs&, cudaStream_t);
template int fused_gmres_static_smem<kPcFieldsplitIlu>(int);

}  // namespace perphil
