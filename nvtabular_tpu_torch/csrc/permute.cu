// Row permutation for Hopper (sm_90a): kernel K14.
//
// Replaces the one jitted program of the JAX package's training feed,
//   nvtabular_tpu/loader/device_loader.py:21-31 (_permute_tree):
//   {k: jnp.take(v, perm, axis=0) for k, v in arrays.items()}
// which gathers every array of a chunk (26 int32 code columns, the [n, 13]
// float32 dense block, the float32 label; int8 or int16 codes after
// ReduceDtypeSize) by one permutation of its rows.
//
// A launch covers up to kMaxArrays arrays: their pointers and row widths
// travel by value in a __grid_constant__ struct (no device array to fill
// first), blockIdx.y picks the array, and a grid-stride loop over its
// elements copies element `t` of the output from element `t % w` of source
// row perm[t / w]. An array's element is the widest of 4, 2 or 1 bytes that
// divides its row and both its addresses (the wrapper's choice), so a
// 4-byte-wide row copies words and an int8 or int16 column its own width,
// with no widening on the host. Writes are coalesced; reads are one random
// row per permuted index, contiguous within the row.
//
// A call of more arrays launches once for each chunk of kMaxArrays, and a
// call whose flat index (rows times the widest row's elements) would pass
// int32 launches once for each chunk of rows (chunks.cuh), the permutation
// and the outputs moved to the chunk's first row; every launch is counted.
//
// Bound: bytes. Each array is read once and written once, and the
// permutation (4 or 8 bytes a row) is read once: for the Criteo chunk,
// 160 B a row read + 160 B written + 8 B of int64 permutation.
//
// A permutation entry outside [0, n) writes zeros instead of reading out
// of bounds (the plain version v[perm] raises for it).

#include <cuda_runtime.h>
#include <cstdint>

#include "chunks.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxArrays = 64;
constexpr int kMaxBlocksX = 1024;  // per array; the loop strides over the rest

struct Arrays {
  const void* src[kMaxArrays];
  void* dst[kMaxArrays];
  int width[kMaxArrays];          // row width in elements
  unsigned char shift[kMaxArrays];  // log2 of the element's bytes: 2, 1 or 0
};

// The index is unsigned: a launch's elements stay within int32, and the
// grid-stride step past the last one within uint32.
template <typename T, typename Idx>
__device__ __forceinline__ void copy_rows(const T* __restrict__ src, T* __restrict__ dst, unsigned w,
                                          const Idx* __restrict__ perm, unsigned rows, int64_t n) {
  const unsigned total = rows * w;
  for (unsigned t = blockIdx.x * kThreads + threadIdx.x; t < total; t += gridDim.x * kThreads) {
    const unsigned row = t / w;
    const unsigned e = t - row * w;
    const int64_t p = static_cast<int64_t>(perm[row]);
    dst[t] = (p >= 0 && p < n) ? src[p * w + e] : T(0);
  }
}

template <typename Idx>
__global__ void __launch_bounds__(kThreads)
permute_rows_kernel(const __grid_constant__ Arrays a, const Idx* __restrict__ perm, unsigned rows, int64_t n) {
  const int k = blockIdx.y;
  const unsigned w = a.width[k];
  switch (a.shift[k]) {  // uniform across the block
    case 2:
      copy_rows(static_cast<const uint32_t*>(a.src[k]), static_cast<uint32_t*>(a.dst[k]), w, perm, rows, n);
      break;
    case 1:
      copy_rows(static_cast<const uint16_t*>(a.src[k]), static_cast<uint16_t*>(a.dst[k]), w, perm, rows, n);
      break;
    default:
      copy_rows(static_cast<const uint8_t*>(a.src[k]), static_cast<uint8_t*>(a.dst[k]), w, perm, rows, n);
  }
}

}  // namespace

// src, dst: num_arrays pointers; row_bytes: each array's row width in bytes
// (> 0); elem_bytes: the element each copies, 4, 2 or 1, dividing its row
// and both its addresses; rows_per_launch: the rows of a launch, whose
// widest row's elements times rows stay within int32. *launches: the kernel
// launches made, one for each chunk of kMaxArrays arrays and of rows.
extern "C" int nvt_permute_rows(const void* const* src, void* const* dst, const int64_t* row_bytes,
                                const int* elem_bytes, int num_arrays, const void* perm, int perm_is_int64,
                                int64_t n, int64_t rows_per_launch, int* launches, void* stream) {
  if (num_arrays < 0 || n < 0 || rows_per_launch < 1) return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < num_arrays; ++k) {
    const int e = elem_bytes[k];
    if (row_bytes[k] <= 0 || !(e == 4 || e == 2 || e == 1) || row_bytes[k] % e != 0 ||
        reinterpret_cast<uintptr_t>(src[k]) % e != 0 || reinterpret_cast<uintptr_t>(dst[k]) % e != 0 ||
        row_bytes[k] / e > INT32_MAX / rows_per_launch)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_arrays == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return nvt::for_each_chunk(num_arrays, kMaxArrays, [&](int k0, int m) {
    Arrays a;
    int64_t widest = 0;
    for (int k = 0; k < m; ++k) {
      const int e = elem_bytes[k0 + k];
      a.width[k] = static_cast<int>(row_bytes[k0 + k] / e);
      a.shift[k] = static_cast<unsigned char>(e == 4 ? 2 : e == 2 ? 1 : 0);
      a.src[k] = src[k0 + k];
      if (a.width[k] > widest) widest = a.width[k];
    }
    return nvt::for_each_chunk(n, rows_per_launch, [&](int64_t r0, int64_t rows) {
      for (int k = 0; k < m; ++k) a.dst[k] = static_cast<char*>(dst[k0 + k]) + r0 * row_bytes[k0 + k];
      const int64_t blocks = (rows * widest + kThreads - 1) / kThreads;
      const dim3 grid(static_cast<unsigned int>(blocks < kMaxBlocksX ? blocks : kMaxBlocksX), m);
      if (perm_is_int64)
        permute_rows_kernel<int64_t><<<grid, kThreads, 0, s>>>(a, static_cast<const int64_t*>(perm) + r0,
                                                                static_cast<unsigned>(rows), n);
      else
        permute_rows_kernel<int32_t><<<grid, kThreads, 0, s>>>(a, static_cast<const int32_t*>(perm) + r0,
                                                                static_cast<unsigned>(rows), n);
      return nvt::launched(launches);
    });
  });
}
