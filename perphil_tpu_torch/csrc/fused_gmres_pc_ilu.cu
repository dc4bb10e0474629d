// The fused GMRES kernel for K7: pc ilu (fused_gmres.cuh).

#include "fused_gmres_kernel.cuh"

namespace perphil {

template cudaError_t launch_fused_gmres<kPcIlu>(const GmresArgs&, cudaStream_t);
template int fused_gmres_static_smem<kPcIlu>(int);

}  // namespace perphil
