// Ragged (values, offsets) → padded rows for Hopper (sm_90a): kernel K11.
//
// Replaces nvtabular_tpu/kernels/ragged.py:22-32 (ragged_to_padded, which
// DeviceLoader runs once per chunk to pad a multihot column,
// nvtabular_tpu/loader/device_loader.py:180-184) and :35-48
// (ragged_slice_padded, ListSlice(pad=True)'s device branch,
// nvtabular_tpu/ops/list_slice.py:55-68). Both are one jnp.take of a clipped
// [R, L] index matrix under a mask, so both launch the one kernel below:
// ragged_to_padded is the slice [0, L) of every row.
//
// For row r of length n = offsets[r + 1] - offsets[r] and the python slice
// [start, end) (negative bounds count from the row's end), exactly as
// ragged.py:38-42 works them out:
//   s = start >= 0 ? min(start, n) : max(n + start, 0)
//   e = end > 0 ? min(end, n) : n + end;  e = max(e, s)
//   new_len = min(e - s, L)
//   out[r, p] = p < new_len ? values[offsets[r] + s + p] : pad
// `mask` (float32 1/0, as the loader casts it) and `new_len` (int64) are
// written when their pointers are not null. Rows longer than L are cut off:
// the caller chooses L. Values move as 4- or 8-byte words, whatever their
// dtype; the pad is given as the bits of the values' dtype.
//
// One thread per output element: consecutive threads write consecutive
// addresses of the [R, L] outputs; the L threads of a row read its two
// offsets (served from L1) and at most L consecutive values. Bound: bytes —
// the offsets (8 B each) and the values inside the slices read once, the
// outputs written once. At the loader's shapes (R = 500,000, L = 4) every
// row is a few dozen bytes, so the launch is a few microseconds.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

template <typename Word>
__global__ void __launch_bounds__(kThreads)
ragged_pad_kernel(const Word* __restrict__ values, int64_t num_values, const int64_t* __restrict__ offsets,
                  int64_t rows, int L, int64_t start, int64_t end, Word pad, Word* __restrict__ out,
                  float* __restrict__ mask, int64_t* __restrict__ new_len) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= rows * L) return;
  const int64_t r = t / L;
  const int p = static_cast<int>(t - r * L);
  const int64_t lo = offsets[r];
  const int64_t n = offsets[r + 1] - lo;
  const int64_t s = start >= 0 ? min64(start, n) : max64(n + start, 0);
  const int64_t e = max64(end > 0 ? min64(end, n) : n + end, s);
  const int64_t len = min64(e - s, L);
  const bool valid = p < len;
  Word v = pad;
  if (valid && num_values > 0) {
    // the reference clips the index into [0, T - 1]; a valid slot of
    // well-formed offsets is always inside it
    v = values[min64(max64(lo + s + p, 0), num_values - 1)];
  }
  out[t] = v;
  if (mask != nullptr) mask[t] = valid ? 1.0f : 0.0f;
  if (new_len != nullptr && p == 0) new_len[r] = len;
}

template <typename Word>
int launch(const void* values, int64_t num_values, const int64_t* offsets, int64_t rows, int L,
           int64_t start, int64_t end, uint64_t pad_bits, void* out, float* mask, int64_t* new_len,
           void* stream) {
  const int64_t total = rows * L;
  const unsigned int blocks = static_cast<unsigned int>((total + kThreads - 1) / kThreads);
  ragged_pad_kernel<Word><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Word*>(values), num_values, offsets, rows, L, start, end,
      static_cast<Word>(pad_bits), static_cast<Word*>(out), mask, new_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// word_bytes is 4 or 8; rows * L must stay below 2^31 blocks' worth, which
// the wrapper checks. Returns a cudaError_t.
extern "C" int nvt_ragged_pad(const void* values, int64_t num_values, int word_bytes, const int64_t* offsets,
                              int64_t rows, int L, int64_t start, int64_t end, uint64_t pad_bits, void* out,
                              float* mask, int64_t* new_len, void* stream) {
  if (rows < 0 || L < 0 || num_values < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || L == 0) return 0;
  if (word_bytes == 4) {
    return launch<uint32_t>(values, num_values, offsets, rows, L, start, end, pad_bits, out, mask, new_len,
                            stream);
  }
  if (word_bytes == 8) {
    return launch<uint64_t>(values, num_values, offsets, rows, L, start, end, pad_bits, out, mask, new_len,
                            stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
