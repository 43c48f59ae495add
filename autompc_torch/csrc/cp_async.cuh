// Asynchronous 4- and 16-byte copies from device memory into shared memory
// (cp.async, sm_80 and later), shared by the backward kernels that stream
// their inputs through a ring of time steps in shared memory
// (riccati_quad.cu, riccati_general.cu, riccati_quad_bm.cu). A 16-byte
// copy needs both addresses 16-byte aligned. A thread starts its copies for a
// step, commits them as one group, and before it reads that step waits
// until at most N younger groups are still in flight. The copies are
// visible to the thread that started them after the wait; other threads
// of the warp see them after a __syncwarp() that follows the wait.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ void ampc_cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

// Bypasses L1 (.cg): the rows are read once from shared memory.
__device__ __forceinline__ void ampc_cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void ampc_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void ampc_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
