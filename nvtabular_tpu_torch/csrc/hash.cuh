// The port's one definition of the murmur3 hashes (kernel K7), shared by
// every CUDA source that hashes: lookup.cu (cuckoo buckets), hash.cu
// (HashedCross, HashBucket, fold ids), groupby.cu (fold ids inside the TE
// epilogue) and hash_pair.cu (the verified hash pairs, K9 and K10b).
//
// Bit-identical to nvtabular_tpu/dispatch.py:32-85 (_fmix32, hash_lanes, the
// device branch of hash_array), which runs the same uint32 arithmetic under
// numpy and jax.numpy. The plain PyTorch versions are in kernels/hash.py
// (int64 lanes masked to 32 bits).

#pragma once

#include <cstdint>

#include "chunks.cuh"

namespace nvt {

constexpr uint32_t kHashC1 = 0xCC9E2D51u;
constexpr uint32_t kHashC2 = 0x1B873593u;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// dispatch.py:41-48: hash two uint32 lanes to a uint32
__device__ __forceinline__ uint32_t hash_lanes(uint32_t lo, uint32_t hi, uint32_t seed) {
  const uint32_t h = fmix32(lo * kHashC1 + seed);
  return fmix32(h ^ (hi * kHashC2));
}

// target_encoding.py:32-50: the fold of global row `row`, hashed from its
// (lo, hi) words. 64-bit addition of the row offset is the reference's
// 32-bit add with carry.
__device__ __forceinline__ int32_t fold_id(uint64_t row, uint32_t seed, uint32_t kfold) {
  const uint32_t lo = static_cast<uint32_t>(row);
  const uint32_t hi = static_cast<uint32_t>(row >> 32);
  return static_cast<int32_t>(hash_lanes(lo, hi, seed) % kfold);
}

// Up to kMaxCols columns of a launch, by value in a __grid_constant__
// argument (nothing to copy to the card first). A chain of more columns
// launches once for each chunk of kMaxCols (chunks.cuh), each launch
// carrying the running hash from the last through the output (hash.cu,
// hash_pair.cu).
constexpr int kMaxCols = 16;
enum ColKind : int { kInt32 = 0, kInt64 = 1, kFloat32 = 2 };

struct Cols {
  const void* ptr[kMaxCols];
  int kind[kMaxCols];
};

// The kinds travel from the host as ints: refuse what is not a column kind.
inline bool valid_kinds(const int* kinds, int num_cols) {
  if (num_cols < 1) return false;
  for (int k = 0; k < num_cols; ++k)
    if (kinds[k] < kInt32 || kinds[k] > kFloat32) return false;
  return true;
}

// Columns [c0, c0 + n) of a chain, n <= kMaxCols.
inline void fill_cols(Cols& cols, const void* const* ptrs, const int* kinds, int c0, int n) {
  for (int k = 0; k < n; ++k) {
    cols.ptr[k] = ptrs[c0 + k];
    cols.kind[k] = kinds[c0 + k];
  }
}

// The lanes hash_array hashes (dispatch.py:51-85):
//   int32   lo = its bits, hi = its sign extension (0 or 0xFFFFFFFF): the
//           reference's device lanes, v32 >> 31;
//   int64   lo, hi = its low and high words: for values inside int32 the same
//           lanes as int32, outside it the reference's host lanes;
//   float32 lo = its bits, hi = 0: the reference's device lanes.
__device__ __forceinline__ void value_lanes(const Cols& c, int k, int64_t r, uint32_t& lo, uint32_t& hi) {
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
}

// hash_array of column k's value at row r
__device__ __forceinline__ uint32_t hash_value(const Cols& c, int k, int64_t r, uint32_t seed) {
  uint32_t lo, hi;
  value_lanes(c, k, r, lo, hi);
  return hash_lanes(lo, hi, seed);
}

}  // namespace nvt
