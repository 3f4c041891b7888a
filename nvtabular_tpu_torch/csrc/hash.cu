// Column hashes for Hopper (sm_90a): kernel K7.
//
// Replaces the jitted uint32 hash chains of the JAX package:
//   nvtabular_tpu/dispatch.py:51-85 (hash_array, the device branch) as used by
//   nvtabular_tpu/ops/hashed_cross.py:38-52 (HashedCross.transform):
//     h = hash(col_0); h = h * 31 ^ hash(col_i) ...; code = h % num_buckets
//   nvtabular_tpu/ops/target_encoding.py:39-50 (_fold_ids_dev): the fold of
//     each row, hash_lanes(lo, hi, fold_seed) % kfold of its global index.
//
// Lanes of a value (what hash_lanes hashes):
//   int32   lo = its bits, hi = its sign extension (0 or 0xFFFFFFFF): the
//           reference's device lanes, v32 >> 31;
//   int64   lo, hi = its low and high words: for values inside int32 the same
//           lanes as int32, outside it the reference's host lanes;
//   float32 lo = its bits, hi = 0: the reference's device lanes.
//
// Bound: bytes. Each column is read once and the int32 codes written once;
// the hash is ~20 integer operations a column, far below the card's integer
// rate. One thread per row walks the C columns, so the combine needs no
// second pass and no intermediate array. Column pointers and kinds travel by
// value in a __grid_constant__ struct (nothing to copy to the card first).

#include <cuda_runtime.h>
#include <cstdint>

#include "hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 16;
constexpr int kMaxBlocks = 4096;  // the grid-stride loop covers the rest
enum Kind : int { kInt32 = 0, kInt64 = 1, kFloat32 = 2 };

struct Cols {
  const void* ptr[kMaxCols];
  int kind[kMaxCols];
};

__device__ __forceinline__ uint32_t hash_value(const Cols& c, int k, int64_t r, uint32_t seed) {
  uint32_t lo, hi;
  if (c.kind[k] == kInt64) {
    const uint64_t v = static_cast<uint64_t>(static_cast<const int64_t*>(c.ptr[k])[r]);
    lo = static_cast<uint32_t>(v);
    hi = static_cast<uint32_t>(v >> 32);
  } else if (c.kind[k] == kInt32) {
    const int32_t v = static_cast<const int32_t*>(c.ptr[k])[r];
    lo = static_cast<uint32_t>(v);
    hi = static_cast<uint32_t>(v >> 31);
  } else {
    lo = __float_as_uint(static_cast<const float*>(c.ptr[k])[r]);
    hi = 0u;
  }
  return nvt::hash_lanes(lo, hi, seed);
}

// num_buckets == 0: no modulo, the uint32 hash is written as int32 bits
__global__ void __launch_bounds__(kThreads)
hash_columns_kernel(const __grid_constant__ Cols cols, int num_cols, int64_t n, uint32_t seed,
                    uint32_t num_buckets, int32_t* __restrict__ out) {
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; r < n;
       r += static_cast<int64_t>(gridDim.x) * kThreads) {
    uint32_t h = hash_value(cols, 0, r, seed);
    for (int k = 1; k < num_cols; ++k) h = h * 31u ^ hash_value(cols, k, r, seed);
    out[r] = static_cast<int32_t>(num_buckets ? h % num_buckets : h);
  }
}

__global__ void __launch_bounds__(kThreads)
fold_ids_kernel(uint64_t row_offset, int64_t n, uint32_t seed, uint32_t kfold,
                int32_t* __restrict__ out) {
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; r < n;
       r += static_cast<int64_t>(gridDim.x) * kThreads) {
    out[r] = nvt::fold_id(row_offset + static_cast<uint64_t>(r), seed, kfold);
  }
}

inline unsigned int blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

extern "C" int nvt_hash_columns(const void* const* ptrs, const int* kinds, int num_cols, int64_t n,
                                uint32_t seed, uint32_t num_buckets, int32_t* out, void* stream) {
  if (num_cols < 1 || num_cols > kMaxCols || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Cols cols;
  for (int k = 0; k < num_cols; ++k) {
    if (kinds[k] < kInt32 || kinds[k] > kFloat32) return static_cast<int>(cudaErrorInvalidValue);
    cols.ptr[k] = ptrs[k];
    cols.kind[k] = kinds[k];
  }
  hash_columns_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      cols, num_cols, n, seed, num_buckets, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nvt_fold_ids(uint64_t row_offset, int64_t n, uint32_t seed, uint32_t kfold,
                            int32_t* out, void* stream) {
  if (n < 0 || kfold == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  fold_ids_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      row_offset, n, seed, kfold, out);
  return static_cast<int>(cudaGetLastError());
}
