// Row permutation for Hopper (sm_90a): kernel K14.
//
// Replaces the one jitted program of the JAX package's training feed,
//   nvtabular_tpu/loader/device_loader.py:21-31 (_permute_tree):
//   {k: jnp.take(v, perm, axis=0) for k, v in arrays.items()}
// which gathers every array of a chunk (26 int32 code columns, the [n, 13]
// float32 dense block, the float32 label) by one permutation of its rows.
//
// One launch covers every array: the arrays' pointers and row widths travel
// by value in a __grid_constant__ struct (no device array to fill first),
// blockIdx.y picks the array, and a grid-stride loop over its 4-byte words
// copies word `t` of the output from word `t % w` of source row
// perm[t / w]. Writes are coalesced; reads are one random row per
// permuted index, contiguous within the row.
//
// Bound: bytes. Each array is read once and written once, and the
// permutation (4 or 8 bytes a row) is read once: for the Criteo chunk,
// 160 B a row read + 160 B written + 8 B of int64 permutation.
//
// A permutation entry outside [0, n) writes zeros instead of reading out
// of bounds (the plain version v[perm] raises for it).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxArrays = 64;
constexpr int kMaxBlocksX = 1024;  // per array; the loop strides over the rest

struct Arrays {
  const uint32_t* src[kMaxArrays];
  uint32_t* dst[kMaxArrays];
  int words[kMaxArrays];  // row width in 4-byte words
};

template <typename Idx>
__global__ void __launch_bounds__(kThreads)
permute_rows_kernel(const __grid_constant__ Arrays a, const Idx* __restrict__ perm, int n) {
  const int k = blockIdx.y;
  const int w = a.words[k];
  const uint32_t* __restrict__ src = a.src[k];
  uint32_t* __restrict__ dst = a.dst[k];
  const int total = n * w;  // the wrapper keeps n * w below 2^31
  for (int t = blockIdx.x * kThreads + threadIdx.x; t < total; t += gridDim.x * kThreads) {
    const int row = t / w;
    const int word = t - row * w;
    const int64_t p = static_cast<int64_t>(perm[row]);
    dst[t] = (p >= 0 && p < n) ? src[p * w + word] : 0u;
  }
}

}  // namespace

extern "C" int nvt_permute_rows(const void* const* src, void* const* dst, const int* row_bytes,
                                int num_arrays, const void* perm, int perm_is_int64, int64_t n,
                                void* stream) {
  if (num_arrays < 0 || num_arrays > kMaxArrays || n < 0 || n > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_arrays == 0 || n == 0) return 0;
  Arrays a;
  int max_words = 0;
  for (int k = 0; k < num_arrays; ++k) {
    if (row_bytes[k] <= 0 || row_bytes[k] % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
    a.src[k] = static_cast<const uint32_t*>(src[k]);
    a.dst[k] = static_cast<uint32_t*>(dst[k]);
    a.words[k] = row_bytes[k] / 4;
    if (a.words[k] > max_words) max_words = a.words[k];
  }
  if (n * max_words > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n * max_words + kThreads - 1) / kThreads;
  dim3 grid(static_cast<unsigned int>(blocks < kMaxBlocksX ? blocks : kMaxBlocksX), num_arrays);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (perm_is_int64) {
    permute_rows_kernel<int64_t><<<grid, kThreads, 0, s>>>(
        a, static_cast<const int64_t*>(perm), static_cast<int>(n));
  } else {
    permute_rows_kernel<int32_t><<<grid, kThreads, 0, s>>>(
        a, static_cast<const int32_t*>(perm), static_cast<int>(n));
  }
  return static_cast<int>(cudaGetLastError());
}
