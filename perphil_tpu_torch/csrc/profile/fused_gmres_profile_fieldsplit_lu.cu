// The fused GMRES kernel for pc fieldsplit_lu with its phase clocks compiled in
// (fused_gmres_profile.cu holds the launcher).

#define PERPHIL_GMRES_PROFILE 1
#include "../fused_gmres_kernel.cuh"

namespace perphil {

template cudaError_t launch_fused_gmres<kPcFieldsplitLu>(const GmresArgs&, cudaStream_t);
template int fused_gmres_static_smem<kPcFieldsplitLu>(int);

}  // namespace perphil
