// Ragged (values, offsets) kernels for Hopper (sm_90a): K11a-b (ragged →
// padded rows, below) and K11c (per-row reductions, after them).
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
#include <climits>
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

// ---------------------------------------------------------------------------
// K11c: per-row sum / mean / min / max of a ragged float32 column.
//
// Replaces nvtabular_tpu/kernels/ragged.py:51-70 (ragged_segment_reduce:
// jax.ops.segment_{sum,min,max} over row ids searchsorted from the offsets).
// Its semantics, kept here: value t belongs to row (the count of offsets[1:]
// <= t), so values before offsets[0] go to row 0 and values from
// offsets[R] on to row R; rows >= num_rows are dropped; an empty row gives 0
// (sum, mean), +inf (min) or -inf (max); NaN propagates through min and max,
// as XLA's do; mean divides by max(row length, 1).
//
// Skew is the design problem: in a session column one row can hold a fifth
// of all values, so the work is split by values, not rows. A block takes a
// chunk of kChunk consecutive values, each thread kItems of them. A thread
// walks its values, finds row changes against the offsets (a binary search
// narrowed to the block's rows), and reduces each of its runs. Rows wholly
// inside one thread are stored directly. The runs that cross threads are
// joined by a segmented scan over the block (warp shuffles, then the warps'
// totals); a row that ends inside the block is stored once, and a row at the
// chunk's edges (which may continue in a neighbour block) takes one atomic
// per block. So the head row of a zipf column costs one atomic per 2,048
// values. min and max run on ordered int keys (the int order is the float
// order, -0.0 below 0.0 as XLA's min and max pick them; NaN is the extreme
// that wins), so integer atomicMin / atomicMax combine them; a last pass
// decodes the keys, or divides the sums for the mean.
//
// Bound: bytes (4 B a value and 8 B an offset read once, 4 B a row
// written). Float32 sums run in another order than XLA's scatter.

namespace {

constexpr int kReduceThreads = 256;
constexpr int kItems = 8;
constexpr int kChunk = kReduceThreads * kItems;
constexpr int kSum = 0, kMean = 1, kMin = 2, kMax = 3;

__device__ __forceinline__ int32_t ordered_key(float v) {
  const int32_t b = __float_as_int(v);
  return b ^ ((b >> 31) & 0x7FFFFFFF);
}

template <int kOp>
struct Op {  // sum (and mean)
  using T = float;
  static __device__ __forceinline__ T identity() { return 0.0f; }
  static __device__ __forceinline__ T load(float v) { return v; }
  static __device__ __forceinline__ T combine(T a, T b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ void atomic(T* p, T v) { atomicAdd(p, v); }
};

template <>
struct Op<kMin> {
  using T = int32_t;
  static __device__ __forceinline__ T identity() { return 0x7F800000; }  // +inf
  static __device__ __forceinline__ T load(float v) { return isnan(v) ? INT_MIN : ordered_key(v); }
  static __device__ __forceinline__ T combine(T a, T b) { return a < b ? a : b; }
  static __device__ __forceinline__ void atomic(T* p, T v) { atomicMin(p, v); }
};

template <>
struct Op<kMax> {
  using T = int32_t;
  static __device__ __forceinline__ T identity() { return static_cast<int32_t>(0x807FFFFFu); }  // -inf
  static __device__ __forceinline__ T load(float v) { return isnan(v) ? INT_MAX : ordered_key(v); }
  static __device__ __forceinline__ T combine(T a, T b) { return a > b ? a : b; }
  static __device__ __forceinline__ void atomic(T* p, T v) { atomicMax(p, v); }
};

// The row of value t among rows [lo - 1, hi - 1]: the first k in [lo, hi)
// with offsets[k] > t, minus one (hi - 1 when there is none).
__device__ __forceinline__ int64_t row_of(const int64_t* __restrict__ offsets, int64_t lo, int64_t hi, int64_t t) {
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (offsets[mid] > t) hi = mid; else lo = mid + 1;
  }
  return lo - 1;
}

template <int kOp>
__device__ __forceinline__ void emit(typename Op<kOp>::T* out, int64_t row, typename Op<kOp>::T v, bool atomic,
                                     int64_t num_rows) {
  if (row >= num_rows) return;  // dropped, as segment_* drops ids >= num_segments
  if (atomic) Op<kOp>::atomic(out + row, v); else out[row] = v;
}

template <int kOp>
__global__ void __launch_bounds__(kReduceThreads)
segment_reduce_kernel(const float* __restrict__ values, int64_t T, const int64_t* __restrict__ offsets, int64_t R,
                      int64_t num_rows, typename Op<kOp>::T* __restrict__ out) {
  using Acc = typename Op<kOp>::T;
  __shared__ int64_t s_block_rows[2];
  __shared__ int64_t s_first[kReduceThreads], s_last[kReduceThreads];
  __shared__ Acc s_total[kReduceThreads];
  __shared__ Acc s_warp_val[kReduceThreads / 32];
  __shared__ bool s_warp_reset[kReduceThreads / 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kChunk;
  const int64_t c1 = c0 + kChunk < T ? c0 + kChunk : T;
  if (tid == 0) {
    s_block_rows[0] = row_of(offsets, 1, R + 1, c0);
    s_block_rows[1] = row_of(offsets, 1, R + 1, c1 - 1);
  }
  __syncthreads();
  const int64_t r_lo = s_block_rows[0], r_hi = s_block_rows[1];

  // 1. this thread's runs: the first and the last kept, the ones between stored
  const int64_t t0 = c0 + static_cast<int64_t>(tid) * kItems;
  int64_t first_row = -1, last_row = -1;
  Acc first_acc = Op<kOp>::identity(), acc = Op<kOp>::identity();
  if (t0 < c1) {
    const int64_t t_end = t0 + kItems < c1 ? t0 + kItems : c1;
    int64_t row = row_of(offsets, r_lo + 1, r_hi + 1, t0);
    int64_t next = row < R ? offsets[row + 1] : LLONG_MAX;
    first_row = row;
    for (int64_t t = t0; t < t_end; ++t) {
      if (t >= next) {
        if (row == first_row) first_acc = acc;
        else emit<kOp>(out, row, acc, false, num_rows);  // wholly inside this thread
        acc = Op<kOp>::identity();
        row = row_of(offsets, row + 2, r_hi + 1, t);
        next = row < R ? offsets[row + 1] : LLONG_MAX;
      }
      acc = Op<kOp>::combine(acc, Op<kOp>::load(values[t]));
    }
    last_row = row;
    if (last_row == first_row) first_acc = acc;
  }
  s_first[tid] = first_row;
  s_last[tid] = last_row;
  __syncthreads();

  // 2. segmented inclusive scan of the last runs over the block's threads
  const bool continues = tid > 0 && first_row >= 0 && s_last[tid - 1] == first_row;
  bool reset = first_row != last_row || !continues;
  Acc v = acc;
  for (int d = 1; d < 32; d <<= 1) {
    const Acc v_up = __shfl_up_sync(0xFFFFFFFFu, v, d);
    const bool r_up = __shfl_up_sync(0xFFFFFFFFu, static_cast<int>(reset), d) != 0;
    if (lane >= d) {
      if (!reset) v = Op<kOp>::combine(v_up, v);
      reset = reset || r_up;
    }
  }
  if (lane == 31) {
    s_warp_val[warp] = v;
    s_warp_reset[warp] = reset;
  }
  __syncthreads();
  if (!reset) {
    // the run continues from earlier warps: their totals, back to the last reset
    Acc prefix = Op<kOp>::identity();
    for (int w = 0; w < warp; ++w) {
      prefix = s_warp_reset[w] ? s_warp_val[w] : Op<kOp>::combine(prefix, s_warp_val[w]);
    }
    v = Op<kOp>::combine(prefix, v);
  }
  s_total[tid] = v;
  __syncthreads();
  if (first_row < 0) return;

  // 3. the runs that end in this thread
  if (first_row != last_row) {
    const Acc head = continues ? Op<kOp>::combine(s_total[tid - 1], first_acc) : first_acc;
    emit<kOp>(out, first_row, head, first_row == r_lo, num_rows);
  }
  const bool ends_here = tid == kReduceThreads - 1 || s_first[tid + 1] != last_row;
  if (ends_here) emit<kOp>(out, last_row, v, last_row == r_lo || last_row == r_hi, num_rows);
}

template <int kOp>
__global__ void segment_init_kernel(typename Op<kOp>::T* __restrict__ out, int64_t num_rows) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r < num_rows) out[r] = Op<kOp>::identity();
}

// min / max: ordered keys back to floats; mean: the sums over max(length, 1)
__global__ void segment_finalize_kernel(float* __restrict__ out, const int64_t* __restrict__ offsets,
                                        int64_t num_rows, int combiner) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= num_rows) return;
  if (combiner == kMean) {
    const int64_t n = offsets[r + 1] - offsets[r];
    out[r] = __fdiv_rn(out[r], static_cast<float>(n > 1 ? n : 1));
    return;
  }
  const int32_t k = __float_as_int(out[r]);
  if (k == INT_MIN || k == INT_MAX) {
    out[r] = __int_as_float(0x7FC00000);  // NaN
  } else {
    out[r] = __int_as_float(k ^ ((k >> 31) & 0x7FFFFFFF));
  }
}

template <int kOp>
int launch_segment_reduce(const float* values, int64_t T, const int64_t* offsets, int64_t R, int64_t num_rows,
                          float* out, int combiner, cudaStream_t stream) {
  using Acc = typename Op<kOp>::T;
  Acc* acc_out = reinterpret_cast<Acc*>(out);
  const unsigned int row_blocks = static_cast<unsigned int>((num_rows + 255) / 256);
  if (num_rows > 0) segment_init_kernel<kOp><<<row_blocks, 256, 0, stream>>>(acc_out, num_rows);
  if (T > 0 && num_rows > 0) {
    const unsigned int blocks = static_cast<unsigned int>((T + kChunk - 1) / kChunk);
    segment_reduce_kernel<kOp><<<blocks, kReduceThreads, 0, stream>>>(values, T, offsets, R, num_rows, acc_out);
  }
  if (combiner != kSum && num_rows > 0) {
    segment_finalize_kernel<<<row_blocks, 256, 0, stream>>>(out, offsets, num_rows, combiner);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// combiner: 0 sum, 1 mean, 2 min, 3 max; out holds num_rows floats. A mean
// needs num_rows == R (the wrapper checks). Returns a cudaError_t.
extern "C" int nvt_ragged_segment_reduce(const float* values, int64_t T, const int64_t* offsets, int64_t R,
                                         int64_t num_rows, int combiner, float* out, void* stream) {
  if (T < 0 || R < 0 || num_rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (combiner) {
    case kSum: case kMean: return launch_segment_reduce<kSum>(values, T, offsets, R, num_rows, out, combiner, s);
    case kMin: return launch_segment_reduce<kMin>(values, T, offsets, R, num_rows, out, combiner, s);
    case kMax: return launch_segment_reduce<kMax>(values, T, offsets, R, num_rows, out, combiner, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

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
