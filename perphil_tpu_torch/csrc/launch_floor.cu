// An empty kernel behind the launchers' own interface: the floor of a
// launch through ctypes (tools/profile_kernels.py --only direct, chip_smoke.py
// time it beside K2 and K3).

#include <cuda_runtime.h>

namespace perphil {

__global__ void empty_kernel() {}

}  // namespace perphil

extern "C" int perphil_empty_launch(void* stream) {
  perphil::empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
