// Partition-aware lag and lead differences for Hopper (sm_90a): kernel K12a.
//
// Replaces DifferenceLag's jitted shifts in the JAX package:
//   nvtabular_tpu/ops/difference_lag.py:79-96 (_shift) and :99-115
//   (_shift_equal), as DifferenceLag.transform (:44-66) combines them:
//     same_s[i] = 0 <= i - s < n && key_p[i] == key_p[i - s] for every p
//     out[s][c][i] = same_s[i] ? float(x_c[i]) - float(x_c[i - s]) : NaN
// for every shift s and value column c, in ONE launch a batch. Keys compare
// their raw values (validity is not read; a NaN key equals nothing), as both
// of the reference's paths compare them. Rows whose i - s falls outside the
// batch are NaN, as on the reference's host path; its device path pads a
// batch with zero rows and there compares the last rows of a lead against
// them (see ROADMAP.md §3).
//
// The difference is one float32 subtraction rounded to nearest (__fsub_rn),
// the plain PyTorch version's operation, so the two agree bit for bit (any
// NaN for NaN).
//
// Bound: bytes. The keys and values of each row are read once from memory
// (the neighbour row i - s is another thread's row, served by L1/L2) and
// each output written once; one thread per row walks the shifts, keys and
// columns, so the keys are read once for all shifts.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;  // the grid-stride loop covers the rest
constexpr int kMaxKeys = 8;
constexpr int kMaxValues = 16;
constexpr int kMaxShifts = 16;
enum KeyKind : int { kInt32 = 0, kInt64 = 1, kFloat32 = 2, kFloat64 = 3 };

struct Args {
  const void* keys[kMaxKeys];
  int key_kind[kMaxKeys];
  const float* values[kMaxValues];
  int64_t shifts[kMaxShifts];
};

__device__ __forceinline__ bool key_equal(const Args& a, int p, int64_t i, int64_t j) {
  switch (a.key_kind[p]) {
    case kInt32: {
      const int32_t* k = static_cast<const int32_t*>(a.keys[p]);
      return k[i] == k[j];
    }
    case kInt64: {
      const int64_t* k = static_cast<const int64_t*>(a.keys[p]);
      return k[i] == k[j];
    }
    case kFloat32: {
      const float* k = static_cast<const float*>(a.keys[p]);
      return k[i] == k[j];
    }
    default: {
      const double* k = static_cast<const double*>(a.keys[p]);
      return k[i] == k[j];
    }
  }
}

// out [S, C, n] float32
__global__ void __launch_bounds__(kThreads)
difference_lag_kernel(const __grid_constant__ Args a, int num_keys, int num_values, int num_shifts, int64_t n,
                      float* __restrict__ out) {
  const float nan = __int_as_float(0x7fc00000);
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    for (int s = 0; s < num_shifts; ++s) {
      const int64_t j = i - a.shifts[s];
      bool same = j >= 0 && j < n;
      for (int p = 0; same && p < num_keys; ++p) same = key_equal(a, p, i, j);
      float* o = out + static_cast<int64_t>(s) * num_values * n + i;
      for (int c = 0; c < num_values; ++c) {
        o[static_cast<int64_t>(c) * n] = same ? __fsub_rn(a.values[c][i], a.values[c][j]) : nan;
      }
    }
  }
}

inline unsigned int blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

extern "C" int nvt_difference_lag(const void* const* keys, const int* key_kinds, int num_keys,
                                  const void* const* values, int num_values, const int64_t* shifts,
                                  int num_shifts, int64_t n, float* out, void* stream) {
  if (n < 0 || num_keys < 0 || num_keys > kMaxKeys || num_values < 0 || num_values > kMaxValues ||
      num_shifts < 0 || num_shifts > kMaxShifts) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || num_values == 0 || num_shifts == 0) return 0;
  Args a = {};
  for (int p = 0; p < num_keys; ++p) {
    if (key_kinds[p] < kInt32 || key_kinds[p] > kFloat64) return static_cast<int>(cudaErrorInvalidValue);
    a.keys[p] = keys[p];
    a.key_kind[p] = key_kinds[p];
  }
  for (int c = 0; c < num_values; ++c) a.values[c] = static_cast<const float*>(values[c]);
  for (int s = 0; s < num_shifts; ++s) a.shifts[s] = shifts[s];
  difference_lag_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, num_keys, num_values, num_shifts, n, out);
  return static_cast<int>(cudaGetLastError());
}
