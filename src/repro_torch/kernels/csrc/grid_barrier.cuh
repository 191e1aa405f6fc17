// A grid barrier for cooperative launches, shared by the kernels that walk
// dependent segments across the whole grid (sptrsv_fused.cu, trsm_block.cu).
//
// One arrival counter in global scratch, which the wrapper zeroes for every
// launch.  At the launch's b-th barrier every block's thread 0 fences
// (`__threadfence()`, publishing the block's writes), adds 1, and spins
// until the count reaches (b + 1) x gridDim.x (its generation is
// count / blocks).  Nothing is reset, so a barrier costs one atomic and the
// loads that see the last arrival; the host checks that barriers x blocks
// stays inside the counter's range.
//
// Only a cooperative launch (cudaLaunchCooperativeKernel) guarantees that
// every block is resident; a plain launch that spins here can deadlock.
// Data written before the barrier by another block must be read through L2
// (`__ldcg`): L1 is not coherent across SMs.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ unsigned grid_ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every block of the grid waits here until all have arrived (the arrival
// count reaches `target`); the writes before it are visible (through L2)
// to every block after it.
__device__ __forceinline__ void grid_barrier(unsigned* count, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    while (grid_ld_acquire(count) < target) {
    }
  }
  __syncthreads();
}
