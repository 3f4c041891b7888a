// Multihot embedding bag for Hopper (sm_90a): kernel K13c's forward.
//
// Replaces nvtabular_tpu/models/layers.py:75-94 (multihot_embedding_lookup,
// the same function as nvtabular_tpu/kernels/ragged.py:73-83
// padded_embedding_bag), which the tabular MLP runs once per multihot
// column (nvtabular_tpu/models/tabular_mlp.py:59-66), and the transpose XLA
// derives for it.
//
// Inputs: a float32 table [V, D], int32 values [B, L] and float32 mask
// [B, L] (1 = a real value) from DeviceLoader's padding. Ids follow
// jnp.take's defaults, as kernel K13a does: a negative id wraps once (id +
// V); an id still outside [0, V) reads a NaN row, and NaN * 0 is NaN, so a
// masked slot holding such an id poisons its row, as in the reference.
//
// nvt_embedding_bag_fwd: out[b] = sum_l table[v[b, l]] * m[b, l], summed in
// l order, divided by max(sum_l m[b, l], 1) for "mean". `out` may be a
// strided view (row stride out_row_stride floats): the tabular MLP passes
// its slot of the MLP's input. One thread owns VEC floats of one row (a
// float4 when D % 4 == 0 and the pointers are 16-byte aligned), so D / 4
// threads share a row. The products and sums are rounded one by one
// (__fmul_rn, __fadd_rn, __fdiv_rn), as the plain version's separate
// PyTorch operations round them: the two agree bit for bit.
//
// The transpose, dtable[v[b, l]] += (g[b] / cnt[b]) * m[b, l] for in-range
// ids, is K15d bag's gradient kernel nvt_range_bag_grad
// (csrc/sharded_embedding.cu) on the whole table: rows [0, V) of V, with
// negatives wrapped by V, exactly the ids this file's bag_row keeps. Its
// shared-memory sum per block takes the contention of a small table (65,536
// x 4 ids on the 23 rows of genres).
//
// A launch's flat index (rows x vectors a row) stays within int32: a larger
// batch launches once for each chunk of rows (chunks.cuh; the host plans
// them: kernels/embedding_bag.py fwd_rows), the values, mask and output
// moved to the chunk's first row, every launch counted.
//
// Bound: bytes: the values and mask (8 B a slot), the distinct table rows
// touched and the output once; a few MB at the training shapes:
// launch-scale.

#include <cuda_runtime.h>
#include <cstdint>

#include "chunks.cuh"

namespace {

constexpr int kThreads = 256;

// The table row of an id after jnp.take's wrap of negatives, or -1.
__device__ __forceinline__ int64_t bag_row(int32_t id, int64_t V) {
  const int64_t row = id < 0 ? static_cast<int64_t>(id) + V : static_cast<int64_t>(id);
  return (row >= 0 && row < V) ? row : -1;
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
bag_fwd_kernel(const float* __restrict__ table, int64_t V, int D, const int32_t* __restrict__ values,
               const float* __restrict__ mask, int B, int L, int mean, float* __restrict__ out,
               int64_t out_row_stride) {
  const int per_row = D / VEC;
  const int t = blockIdx.x * kThreads + threadIdx.x;  // a launch's B * D / VEC is below 2^31
  if (t >= B * per_row) return;
  const int b = t / per_row;
  const int q = t - b * per_row;
  const float nan = __int_as_float(0x7fc00000);
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
  float cnt = 0.0f;
  for (int l = 0; l < L; ++l) {
    const int64_t row = bag_row(values[static_cast<int64_t>(b) * L + l], V);
    const float m = mask[static_cast<int64_t>(b) * L + l];
    float v[VEC];
    if constexpr (VEC == 4) {
      float4 x = make_float4(nan, nan, nan, nan);
      if (row >= 0) x = *reinterpret_cast<const float4*>(table + row * D + q * 4);
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    } else {
      v[0] = row >= 0 ? table[row * D + q] : nan;
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(v[k], m));
    cnt = __fadd_rn(cnt, m);
  }
  if (mean) {
    cnt = fmaxf(cnt, 1.0f);
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = __fdiv_rn(acc[k], cnt);
  }
  float* dst = out + b * out_row_stride + q * VEC;
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    *dst = acc[0];
  }
}

bool bad_shape(int64_t V, int D, int64_t B, int L, int vec) {
  return V < 0 || D <= 0 || B < 0 || L < 0 || (vec != 1 && vec != 4) || D % vec != 0;
}

}  // namespace

// rows_per_launch: the rows of a launch (the host's plan), whose flat index
// stays within int32; *launches: the kernel launches made, one for each
// chunk of rows.
extern "C" int nvt_embedding_bag_fwd(const float* table, int64_t V, int D, const int32_t* values,
                                     const float* mask, int64_t B, int L, int mean, int64_t rows_per_launch,
                                     float* out, int64_t out_row_stride, int vec, int* launches, void* stream) {
  if (bad_shape(V, D, B, L, vec) || rows_per_launch < 1 || rows_per_launch > INT32_MAX / (D / vec))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per_row = D / vec;
  return nvt::for_each_chunk(B, rows_per_launch, [&](int64_t b0, int64_t rows) {
    const unsigned int blocks = static_cast<unsigned int>((rows * per_row + kThreads - 1) / kThreads);
    const int32_t* v = values + b0 * L;
    const float* m = mask + b0 * L;
    float* o = out + b0 * out_row_stride;
    if (vec == 4)
      bag_fwd_kernel<4><<<blocks, kThreads, 0, s>>>(table, V, D, v, m, static_cast<int>(rows), L, mean, o,
                                                    out_row_stride);
    else
      bag_fwd_kernel<1><<<blocks, kThreads, 0, s>>>(table, V, D, v, m, static_cast<int>(rows), L, mean, o,
                                                    out_row_stride);
    return nvt::launched(launches);
  });
}
