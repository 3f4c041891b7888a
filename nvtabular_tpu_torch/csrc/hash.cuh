// The port's one definition of the murmur3 hashes (kernel K7), shared by
// every CUDA source that hashes: lookup.cu (cuckoo buckets), hash.cu
// (HashedCross, fold ids) and groupby.cu (fold ids inside the TE epilogue).
//
// Bit-identical to nvtabular_tpu/dispatch.py:32-48 (_fmix32, hash_lanes),
// which runs the same uint32 arithmetic under numpy and jax.numpy. The plain
// PyTorch versions are in kernels/hash.py (int64 lanes masked to 32 bits).

#pragma once

#include <cstdint>

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

}  // namespace nvt
