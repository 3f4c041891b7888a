// Launches over chunks: a kernel that takes its columns' tables by value in a
// __grid_constant__ argument (or a bounded share of a row in shared memory)
// launches once for each chunk of at most `most`, and the entry point
// reports how many launches it made, so that the wrapper counts launches,
// not calls (embedding.cu, sharded_embedding.cu, hash.cu, hash_pair.cu).
#pragma once

#include <cuda_runtime.h>

namespace nvt {

// The size of the chunk at c0 of [0, total), chunks of at most `most`.
inline int chunk_size(int total, int c0, int most) { return total - c0 < most ? total - c0 : most; }

// launch(c0, n) for each chunk [c0, c0 + n) of [0, total), in order; stops
// at the first error, which it returns.
template <class Launch>
int for_each_chunk(int total, int most, Launch launch) {
  for (int c0 = 0; c0 < total; c0 += most)
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

}  // namespace nvt
