// The norm's tree on a thread block cluster, shared by fused_ngs.cu and
// fused_gs.cu: the halving tree (krylov.tree_sum) over the squares of L
// values that the cluster's blocks hold in slices of the fused GMRES frame's
// layout (fused_gmres.cuh, "Ownership": slot i of block b's slice is value
// o.elem(i)), in cluster_tree_rows's order (fused_gmres_kernel.cuh), the
// blocks' partials exchanged through shared memory (xpart, four a block) in
// place of device memory.

#pragma once

#include "fused_gmres_kernel.cuh"

namespace perphil {

// Every block's slice complete before the call (a cluster barrier); on
// return every thread of every block reads the sum at *sum: each block
// finishes the tree itself, so a stop test on it needs no broadcast. One
// block takes no cluster barrier, more take one.
__device__ __forceinline__ void cluster_square_tree(cg::cluster_group& cluster, const Own& o, const double* slice,
                                                    int L, double (*part)[64], double* xpart, double* sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto leaf = [&](int, int s) {
    const int i = o.slot(s);
    if (o.elem(i) >= L) return 0.0;
    const double v = slice[i];
    return __dmul_rn(v, v);
  };
  switch (o.log_s) {
    case 0: warp_tree_rows<0>(part, 1, leaf); break;
    case 1: warp_tree_rows<1>(part, 1, leaf); break;
    case 2: warp_tree_rows<2>(part, 1, leaf); break;
    default: {
      TreeAcc<kMaxLogS> acc;
      for (int t = 0; t < (1 << o.log_s); ++t) acc.push(leaf(0, bit_reverse(t, o.log_s)));
      const double v = add_down(add_down(add_down(acc.result(o.log_s), 16), 8), 4);
      if (lane < 4) part[0][warp * 4 + lane] = v;
    }
  }
  __syncthreads();
  if (warp == 0) {
    // the four bits of h that are the warp, then (one block) lo
    double v = add_down(add_down(add_down(__dadd_rn(part[0][lane], part[0][lane + 32]), 16), 8), 4);
    if (o.nb == 1) {
      v = add_down(add_down(v, 2), 1);
      if (lane == 0) *sum = v;
    } else if (lane < 4) {
      xpart[lane] = v;
    }
  }
  if (o.nb > 1) {
    cluster.sync();  // every block's four partials in place
    if (warp == 0) {
      // the blocks' bits, then lo, over value (b, lo) at 4 b + lo
      const int width = 4 * o.nb;
      auto partial = [&](int at) { return *cluster.map_shared_rank(xpart + (at & 3), at >> 2); };
      double v = lane < width ? partial(lane) : 0.0;
      if (width == 64) v = __dadd_rn(v, partial(lane + 32));
      for (int s = (width < 32 ? width : 32) / 2; s > 0; s >>= 1) v = add_down(v, s);
      if (lane == 0) *sum = v;
    }
  }
  __syncthreads();
}

}  // namespace perphil
