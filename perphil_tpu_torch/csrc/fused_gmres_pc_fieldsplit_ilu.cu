// The fused GMRES kernel for K8: pc fieldsplit_ilu (fused_gmres.cuh).

#include "fused_gmres_kernel.cuh"

namespace perphil {

template cudaError_t launch_fused_gmres<kPcFieldsplitIlu>(const GmresArgs&, cudaStream_t);
template int fused_gmres_static_smem<kPcFieldsplitIlu>(int);

}  // namespace perphil
