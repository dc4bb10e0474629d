// The fused GMRES kernel for K4/K5: pc none and jacobi (fused_gmres.cuh).

#include "fused_gmres_kernel.cuh"

namespace perphil {

template cudaError_t launch_fused_gmres<kPcNone>(const GmresArgs&, cudaStream_t);
template int fused_gmres_static_smem<kPcNone>(int);
template cudaError_t launch_fused_gmres<kPcJacobi>(const GmresArgs&, cudaStream_t);
template int fused_gmres_static_smem<kPcJacobi>(int);

}  // namespace perphil
