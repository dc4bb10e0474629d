// The fused GMRES kernel for K6: pc fieldsplit_lu (fused_gmres.cuh).

#include "fused_gmres_kernel.cuh"

namespace perphil {

template cudaError_t launch_fused_gmres<kPcFieldsplitLu>(const GmresArgs&, cudaStream_t);
template int fused_gmres_static_smem<kPcFieldsplitLu>(int);

}  // namespace perphil
