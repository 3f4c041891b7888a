// Column hashes for Hopper (sm_90a): kernel K7.
//
// Replaces the jitted uint32 hash chains of the JAX package:
//   nvtabular_tpu/dispatch.py:51-85 (hash_array, the device branch) as used by
//   nvtabular_tpu/ops/hashed_cross.py:38-52 (HashedCross.transform):
//     h = hash(col_0); h = h * 31 ^ hash(col_i) ...; code = h % num_buckets
//   and by nvtabular_tpu/ops/hash_bucket.py:47-54 (HashBucket.transform, one
//   column: hash(col) % num_buckets);
//   nvtabular_tpu/ops/target_encoding.py:39-50 (_fold_ids_dev): the fold of
//     each row, hash_lanes(lo, hi, fold_seed) % kfold of its global index.
//
// The lanes of each value kind are hash.cuh's (value_lanes).
//
// Bound: bytes. Each column is read once and the int32 codes written once;
// the hash is ~20 integer operations a column, far below the card's integer
// rate. One thread per row walks the C columns, so the combine needs no
// second pass and no intermediate array.

#include <cuda_runtime.h>
#include <cstdint>

#include "hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;  // the grid-stride loop covers the rest

// num_buckets == 0: no modulo, the uint32 hash is written as int32 bits.
// carry: the chain's running hash of the columns before this launch's is
// out[r] (a chunk's launch after the first).
__global__ void __launch_bounds__(kThreads)
hash_columns_kernel(const __grid_constant__ nvt::Cols cols, int num_cols, int carry, int64_t n, uint32_t seed,
                    uint32_t num_buckets, int32_t* __restrict__ out) {
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; r < n;
       r += static_cast<int64_t>(gridDim.x) * kThreads) {
    uint32_t h = carry ? static_cast<uint32_t>(out[r]) * 31u ^ nvt::hash_value(cols, 0, r, seed)
                       : nvt::hash_value(cols, 0, r, seed);
    for (int k = 1; k < num_cols; ++k) h = h * 31u ^ nvt::hash_value(cols, k, r, seed);
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

// *launches: the kernel launches made, one for each chunk of kMaxCols columns.
extern "C" int nvt_hash_columns(const void* const* ptrs, const int* kinds, int num_cols, int64_t n,
                                uint32_t seed, uint32_t num_buckets, int32_t* out, int* launches, void* stream) {
  if (n < 0 || !nvt::valid_kinds(kinds, num_cols)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  return nvt::for_each_chunk(num_cols, nvt::kMaxCols, [&](int c0, int k) {
    nvt::Cols cols;
    nvt::fill_cols(cols, ptrs, kinds, c0, k);
    const uint32_t buckets = c0 + k == num_cols ? num_buckets : 0u;  // the modulo after the chain's last column
    hash_columns_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        cols, k, c0 > 0, n, seed, buckets, out);
    return nvt::launched(launches);
  });
}

extern "C" int nvt_fold_ids(uint64_t row_offset, int64_t n, uint32_t seed, uint32_t kfold,
                            int32_t* out, void* stream) {
  if (n < 0 || kfold == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  fold_ids_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      row_offset, n, seed, kfold, out);
  return static_cast<int>(cudaGetLastError());
}
