// The arrival counter of the kernels that split one result across blocks or
// warps (csrc/w4_tile.cuh, csrc/flash_decode_q8.cu): each work item writes
// its partial to a workspace, then arrives; the item that arrives last
// merges the partials in a fixed order, so the result does not depend on
// which item finished first.
#pragma once

#include <cuda_runtime.h>

namespace split {

// Called by every thread of a block after it wrote its partial: true in the
// block that arrives last of `arrivals` at *counter, whose threads then see
// every other arrival's writes. One thread's acquire-release add after the
// barrier publishes the block's writes and, in the last block, acquires the
// others'. The last arrival resets the counter to 0 for the next launch.
__device__ __forceinline__ bool arrive(int* counter, int arrivals) {
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    int prev;
    asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                 : "=r"(prev)
                 : "l"(counter)
                 : "memory");
    last = prev == arrivals - 1;
    if (last) *counter = 0;
  }
  __syncthreads();
  return last;
}

// The same for a work item of one warp, called by all its lanes after each
// wrote its part of the partial; the barrier is the warp's.
__device__ __forceinline__ bool arrive_warp(int* counter, int arrivals) {
  __syncwarp();
  int last = 0;
  if ((threadIdx.x & 31) == 0) {
    int prev;
    asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                 : "=r"(prev)
                 : "l"(counter)
                 : "memory");
    last = prev == arrivals - 1;
    if (last) *counter = 0;
  }
  return __shfl_sync(0xffffffffu, last, 0);
}

}  // namespace split
