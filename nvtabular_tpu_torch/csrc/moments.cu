// Per-column partial moments for Hopper (sm_90a): kernel K15c.
//
// Replaces local_partials of nvtabular_tpu/parallel/stats.py:50-63, the
// per-device body of sharded_moments: over the rows a device holds of a
// float32 [rows, cols] array (row-major), for each column, with NaN as
// null,
//
//   count  the non-NaN values (int32)
//   mean   their sum / max(count, 1), in float32
//   M2     sum of (x - mean)^2 over them: the shifted second moment, not
//          sum x^2 - n mean^2, which cancels in float32 for a large column
//          of small variance (stats.py:11-14)
//   min, max   over them (+inf / -inf for an empty column)
//
// One block a column, two passes over its rows: the count and the sum,
// then M2, min and max about the mean of the first. Each thread sums a
// strided share of the rows in float64 and the block adds the threads'
// sums in a fixed tree, so the float32 results are rounded once, from
// sums more exact than the reference's float32 ones (held to it within a
// tolerance, never bit for bit). x - mean is rounded in float32, as the
// reference rounds it.
//
// Bound: bytes, the array read twice. A column's values are cols floats
// apart, so a warp's loads are not coalesced; the other blocks read the
// same lines, mostly from L2. A row-chunked grid with a second reduction
// is the faster shape, for a later version.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

template <class T, class Op>
__device__ __forceinline__ T block_reduce(T v, T* scratch, Op op) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = op(v, __shfl_down_sync(0xffffffffu, v, d));
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = scratch[lane < kWarps ? lane : 0];  // lanes past kWarps never reach lane 0's sum
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const T other = __shfl_down_sync(0xffffffffu, v, d);
      if (lane + d < kWarps) v = op(v, other);
    }
  }
  __syncthreads();  // scratch is reused by the next reduction
  return v;  // valid in thread 0
}

struct Add {
  template <class T> __device__ __forceinline__ T operator()(T a, T b) const { return a + b; }
};
struct Min {
  __device__ __forceinline__ float operator()(float a, float b) const { return fminf(a, b); }
};
struct Max {
  __device__ __forceinline__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

__global__ void __launch_bounds__(kThreads)
moments_kernel(const float* __restrict__ x, int64_t rows, int cols, int32_t* __restrict__ count,
               float* __restrict__ mean, float* __restrict__ m2, float* __restrict__ mn, float* __restrict__ mx) {
  __shared__ double dscratch[kWarps];
  __shared__ int32_t iscratch[kWarps];
  __shared__ float fscratch[kWarps];
  __shared__ float mean_s;
  const int c = blockIdx.x;
  int32_t cnt = 0;
  double sum = 0.0;
  for (int64_t r = threadIdx.x; r < rows; r += kThreads) {
    const float v = x[r * cols + c];
    if (!isnan(v)) {
      ++cnt;
      sum += static_cast<double>(v);
    }
  }
  cnt = block_reduce(cnt, iscratch, Add());
  sum = block_reduce(sum, dscratch, Add());
  if (threadIdx.x == 0) {
    const float mu = __fdiv_rn(static_cast<float>(sum), static_cast<float>(cnt > 1 ? cnt : 1));
    count[c] = cnt;
    mean[c] = mu;
    mean_s = mu;
  }
  __syncthreads();
  const float mu = mean_s;
  double q = 0.0;
  float lo = __int_as_float(0x7f800000), hi = __int_as_float(0xff800000);  // +inf, -inf
  for (int64_t r = threadIdx.x; r < rows; r += kThreads) {
    const float v = x[r * cols + c];
    if (!isnan(v)) {
      const float d = __fsub_rn(v, mu);
      q += static_cast<double>(d) * static_cast<double>(d);
      lo = fminf(lo, v);
      hi = fmaxf(hi, v);
    }
  }
  q = block_reduce(q, dscratch, Add());
  lo = block_reduce(lo, fscratch, Min());
  hi = block_reduce(hi, fscratch, Max());
  if (threadIdx.x == 0) {
    m2[c] = static_cast<float>(q);
    mn[c] = lo;
    mx[c] = hi;
  }
}

}  // namespace

// x float32 [rows, cols] → count int32 [cols], mean, m2, min, max float32 [cols].
extern "C" int nvt_column_moments(const float* x, int64_t rows, int cols, int32_t* count, float* mean,
                                  float* m2, float* mn, float* mx, void* stream) {
  if (cols == 0) return 0;
  moments_kernel<<<cols, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, rows, cols, count, mean, m2, mn, mx);
  return static_cast<int>(cudaGetLastError());
}
