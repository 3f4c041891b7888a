// Verified hash pairs for Hopper (sm_90a): kernels K10b and K9.
//
// Replaces the jitted multi-key lookups of the JAX package:
//   nvtabular_tpu/ops/groupby_stats.py:53-62 (hash_multi_key) with the
//     multi-key branch of device_group_index (:611-627): the group index of
//     TargetEncoding and JoinGroupby groups of several key columns (K10b);
//   nvtabular_tpu/ops/categorify.py:1381-1410 (_encode_combo_device): the
//     crossed column of Categorify(encode_type="combo") (K9);
//   nvtabular_tpu/dispatch.py:41-48 (hash_lanes) on device arrays.
//
// The fitted key tuples of a group are keyed by h1 = hash_multi_key(keys,
// 0xA1), free of collisions over the fitted tuples (the host checks this when
// it builds the table), in a K1 or K3 table (lookup.cu) whose miss code is a
// launch argument. A hit is verified with a second, independent hash h2 =
// hash_multi_key(keys, 0xB7) against the fitted tuple's, so a false join
// needs both 32-bit hashes to collide. A group takes three launches:
// nvt_hash_pair (both hashes), the K1/K3 probe of h1, and
// nvt_hash_pair_verify (the h2 check and the code epilogue).
//
// hash_multi_key chains hash_array over the columns (hash.cuh's lanes):
//   h = hash(a_0, seed); h = hash_lanes(h, hash(a_i, seed + 31 i), seed + 17)
// h1 is written as int32 bits: the reference wraps uint32 to int32 before its
// probe (groupby_stats.py:580, categorify.py:1361-1363); h2 is compared as
// the same 32 bits.
//
// Bound: bytes. hash_pair reads each key column once (both hashes from one
// load) and writes 8 bytes a row; verify reads the probe's index, the row's
// h2 and the validity masks, gathers the hit group's h2 from a table of at
// most a few hundred KB that stays in L2, and writes 4 bytes a row. The
// hashes are ~40 integer operations a column, far below the card's integer
// rate. One thread per row.

#include <cuda_runtime.h>
#include <cstdint>

#include "hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;  // the grid-stride loop covers the rest

struct Masks {
  const uint8_t* ptr[nvt::kMaxCols];  // bool [n] each, or null: all valid
};

// Columns [c0, c0 + num_cols) of the key tuple; c0 > 0: the running hashes
// of the columns before are h1_out[r] and h2_out[r] (a chunk's launch after
// the first).
__global__ void __launch_bounds__(kThreads)
hash_pair_kernel(const __grid_constant__ nvt::Cols cols, int num_cols, int c0, int64_t n, uint32_t seed1,
                 uint32_t seed2, int32_t* __restrict__ h1_out, int32_t* __restrict__ h2_out) {
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; r < n;
       r += static_cast<int64_t>(gridDim.x) * kThreads) {
    uint32_t lo, hi, h1, h2;
    int k = 0;
    if (c0 == 0) {
      nvt::value_lanes(cols, 0, r, lo, hi);
      h1 = nvt::hash_lanes(lo, hi, seed1);
      h2 = nvt::hash_lanes(lo, hi, seed2);
      k = 1;
    } else {
      h1 = static_cast<uint32_t>(h1_out[r]);
      h2 = static_cast<uint32_t>(h2_out[r]);
    }
    for (; k < num_cols; ++k) {
      const uint32_t col = static_cast<uint32_t>(c0 + k);
      nvt::value_lanes(cols, k, r, lo, hi);
      h1 = nvt::hash_lanes(h1, nvt::hash_lanes(lo, hi, seed1 + 31u * col), seed1 + 17u);
      h2 = nvt::hash_lanes(h2, nvt::hash_lanes(lo, hi, seed2 + 31u * col), seed2 + 17u);
    }
    h1_out[r] = static_cast<int32_t>(h1);
    h2_out[r] = static_cast<int32_t>(h2);
  }
}

// idx: the probe's result, a fitted row in [0, miss) or miss. A hit whose h2
// equals the fitted tuple's gives idx + hit_offset; a miss or a mismatch gives
// oov; a row with any null member gives null_code. masks_only: a launch for
// the masks past the first kMaxCols, over the codes already in out.
__global__ void __launch_bounds__(kThreads)
hash_pair_verify_kernel(const int32_t* __restrict__ idx, const int32_t* __restrict__ h2,
                        const int32_t* __restrict__ h2_by_group, const __grid_constant__ Masks masks,
                        int num_masks, int masks_only, int64_t n, int32_t miss, int32_t hit_offset, int32_t oov,
                        int32_t null_code, int32_t* __restrict__ out) {
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; r < n;
       r += static_cast<int64_t>(gridDim.x) * kThreads) {
    int32_t code = oov;
    if (masks_only) {
      code = out[r];
    } else {
      const int32_t v = idx[r];
      if (v != miss && __ldg(h2_by_group + v) == h2[r]) code = v + hit_offset;
    }
    for (int k = 0; k < num_masks; ++k) {
      if (masks.ptr[k] != nullptr && !masks.ptr[k][r]) code = null_code;
    }
    out[r] = code;
  }
}

// dispatch.hash_lanes: uint32 lanes held in int64, the hash likewise
__global__ void __launch_bounds__(kThreads)
hash_lanes_kernel(const int64_t* __restrict__ lo, const int64_t* __restrict__ hi, int64_t n, uint32_t seed,
                  int64_t* __restrict__ out) {
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; r < n;
       r += static_cast<int64_t>(gridDim.x) * kThreads) {
    out[r] = static_cast<int64_t>(
        nvt::hash_lanes(static_cast<uint32_t>(lo[r]), static_cast<uint32_t>(hi[r]), seed));
  }
}

inline unsigned int blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

// *launches: the kernel launches made, one for each chunk of kMaxCols columns.
extern "C" int nvt_hash_pair(const void* const* ptrs, const int* kinds, int num_cols, int64_t n, uint32_t seed1,
                             uint32_t seed2, int32_t* h1, int32_t* h2, int* launches, void* stream) {
  if (n < 0 || !nvt::valid_kinds(kinds, num_cols)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  return nvt::for_each_chunk(num_cols, nvt::kMaxCols, [&](int c0, int k) {
    nvt::Cols cols;
    nvt::fill_cols(cols, ptrs, kinds, c0, k);
    hash_pair_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(cols, k, c0, n, seed1,
                                                                                          seed2, h1, h2);
    return nvt::launched(launches);
  });
}

// The codes and the first kMaxCols masks in one launch, then a launch for
// each further chunk of masks; *launches counts them.
extern "C" int nvt_hash_pair_verify(const int32_t* idx, const int32_t* h2, const int32_t* h2_by_group,
                                    const void* const* masks, int num_masks, int64_t n, int32_t miss,
                                    int32_t hit_offset, int32_t oov, int32_t null_code, int32_t* out,
                                    int* launches, void* stream) {
  if (n < 0 || num_masks < 0 || miss < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const auto verify = [&](int c0, int k) {
    Masks m;
    for (int j = 0; j < nvt::kMaxCols; ++j) m.ptr[j] = j < k ? static_cast<const uint8_t*>(masks[c0 + j]) : nullptr;
    hash_pair_verify_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        idx, h2, h2_by_group, m, k, c0 > 0, n, miss, hit_offset, oov, null_code, out);
    return nvt::launched(launches);
  };
  return num_masks == 0 ? verify(0, 0) : nvt::for_each_chunk(num_masks, nvt::kMaxCols, verify);
}

extern "C" int nvt_hash_lanes(const int64_t* lo, const int64_t* hi, int64_t n, uint32_t seed, int64_t* out,
                              void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  hash_lanes_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(lo, hi, n, seed, out);
  return static_cast<int>(cudaGetLastError());
}
