// Pushed halos between the blocks of a thread block cluster: the helpers
// that fused_ngs.cu and fused_gs.cu share. A block writes a value straight
// into a neighbour's shared memory with st.async, which completes its 8
// bytes on an mbarrier there; one thread then arrives on that mbarrier with
// the bytes it sent (expect_tx), and the neighbour waits on the phase's
// parity. Only CTA-scope ordering is used: the pushed bytes become visible
// through the mbarrier's transaction count.

#pragma once

#include <cstdint>

namespace perphil {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// p's address (shared::cta) in block `rank`'s shared memory (shared::cluster)
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}

// v into block `rank`'s copy of *slot, completing 8 bytes on its copy of *bar
__device__ __forceinline__ void push(double* slot, double v, int rank, uint64_t* bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];"
               :
               : "r"(cluster_addr(slot, rank)), "l"(__double_as_longlong(v)), "r"(cluster_addr(bar, rank))
               : "memory");
}

// one arrival on block `rank`'s copy of *bar, announcing `bytes` pushed
__device__ __forceinline__ void arrive_remote(uint64_t* bar, int rank, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cluster.b64 _, [%0], %1;"
               :
               : "r"(cluster_addr(bar, rank)), "r"(bytes)
               : "memory");
}

// A wait that outlasts kHaloWaitCycles (seconds, where a phase takes
// microseconds) means a protocol fault: the kernel traps, and the launch's
// error reaches the caller, rather than hang the card.
constexpr long long kHaloWaitCycles = 1LL << 35;

__device__ __forceinline__ void wait_parity(uint64_t* bar, int parity) {
  const long long start = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - start > kHaloWaitCycles) __trap();
  } while (!done);
}

// Both mbarriers of a block's halo (phases alternate between them), each
// taking `arrivals` arrivals a phase; made visible to the cluster.
__device__ __forceinline__ void init_halo_bars(uint64_t* bar, int arrivals) {
  for (int k = 0; k < 2; ++k) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" : : "r"(smem_u32(bar + k)), "r"(arrivals) : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;" : : : "memory");
}

}  // namespace perphil
