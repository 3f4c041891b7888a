// Launch helpers shared by the kernels' entry points.
//
// Launches over chunks: a kernel that takes its columns' tables by value in a
// __grid_constant__ argument (or a bounded share of a row in shared memory),
// or whose flat index must stay within int32, launches once for each chunk
// of at most `most` columns or rows, and the entry point reports how many
// launches it made, so that the wrapper counts launches, not calls
// (embedding.cu, embedding_bag.cu, permute.cu, sharded_embedding.cu,
// hash.cu, hash_pair.cu).
//
// Persistent grids: as many blocks as the card holds at once
// (interaction.cu, fm.cu, sharded_embedding.cu).
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace nvt {

// The size of the chunk at c0 of [0, total), chunks of at most `most`.
template <class T>
inline T chunk_size(T total, T c0, T most) { return total - c0 < most ? total - c0 : most; }

// launch(c0, n) for each chunk [c0, c0 + n) of [0, total), in order; stops
// at the first error, which it returns.
template <class T, class Launch>
int for_each_chunk(T total, T most, Launch launch) {
  for (T c0 = 0; c0 < total; c0 += most)
    if (int rc = launch(c0, chunk_size(total, c0, most))) return rc;
  return 0;
}

// The error of the launch just made, which adds one to *launches where
// there is none.
inline int launched(int* launches) {
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launches;
  return static_cast<int>(err);
}

// The persistent grid of `kernel` in blocks of `threads` threads with `smem`
// bytes of dynamic shared memory each (the kernel's limit is set to it): as
// many blocks as the card holds at once, at most `items`.
template <class Kernel>
int resident_blocks(Kernel kernel, int threads, int smem, int64_t items, unsigned* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  *blocks = static_cast<unsigned>(items < resident ? items : resident);
  return 0;
}

}  // namespace nvt
