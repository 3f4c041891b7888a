// Asynchronous copies from global to shared memory (cp.async, sm_80 and
// later), shared by the kernels that stage their inputs in rings or double
// buffers (interaction.cu, cin.cu, lookup.cu).
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace nvt {

// The shared-memory address of a generic pointer into shared memory.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One float (4-byte aligned), through L1.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

// Four floats (both ends 16-byte aligned), past L1.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

// The thread's copies issued since the last commit become one group.
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

// Waits until at most N of the thread's groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

}  // namespace nvt
