// The row-sharded embedding lookup and bag for Hopper (sm_90a): kernel K15b.
//
// Replaces the per-device bodies of nvtabular_tpu/parallel/embeddings.py:
// lookup (:40-50) and bag (:73-81) before their psum over the model axis.
// A rank holds the rows [start, start + rows_local) of a float32 table
// [V, D] as its local table [rows_local, D]; ids are global rows.
//
// nvt_range_gather: out[i] = table_local[ids[i] - start] when the row is
// local, else zeros: K13a's gather (csrc/embedding.cu) with a row range in
// place of a column's table. Exactly one rank owns each row, so the sum over
// the model axis assembles the embedding, bit for bit.
//
// nvt_range_bag: out[b] = sum_l table_local[clip(v[b, l] - start)] *
// (m[b, l] * in_range), summed in l order: K13c's bag (csrc/embedding_bag.cu)
// with a row range. A row outside the range reads the clipped row times a
// zero weight, as the reference's jnp.take of the clipped index does. It
// writes the sum; the mean divides after the sum over the model axis, by
// the mask counts (embeddings.py:84-87). Products and sums are rounded one
// by one (__fmul_rn, __fadd_rn), as the plain version's separate PyTorch
// operations round them.
//
// One thread copies or sums VEC floats of an output row (a float4 when
// D % 4 == 0 and the pointers are 16-byte aligned); consecutive threads
// write consecutive addresses. Bound: bytes — the ids (and mask), the
// distinct local rows touched and the output, once each.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <int VEC>
__device__ __forceinline__ void load_vec(const float* __restrict__ src, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    v[0] = *src;
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* __restrict__ dst, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *dst = v[0];
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
range_gather_kernel(const float* __restrict__ table, int64_t rows_local, int64_t start, int D,
                    const int32_t* __restrict__ ids, int64_t n, float* __restrict__ out) {
  const int per_row = D / VEC;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n * per_row) return;
  const int64_t i = t / per_row;
  const int q = static_cast<int>(t - i * per_row);
  const int64_t local = static_cast<int64_t>(ids[i]) - start;
  float v[VEC];
  if (local >= 0 && local < rows_local) {
    load_vec<VEC>(table + local * D + q * VEC, v);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = 0.0f;
  }
  store_vec<VEC>(out + i * D + q * VEC, v);
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
range_bag_kernel(const float* __restrict__ table, int64_t rows_local, int64_t start, int D,
                 const int32_t* __restrict__ values, const float* __restrict__ mask, int64_t B, int L,
                 float* __restrict__ out) {
  const int per_row = D / VEC;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= B * per_row) return;
  const int64_t b = t / per_row;
  const int q = static_cast<int>(t - b * per_row);
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
  for (int l = 0; l < L; ++l) {
    int64_t local = static_cast<int64_t>(values[b * L + l]) - start;
    const bool in_range = local >= 0 && local < rows_local;
    const float w = __fmul_rn(mask[b * L + l], in_range ? 1.0f : 0.0f);
    local = local < 0 ? 0 : (local >= rows_local ? rows_local - 1 : local);
    float v[VEC];
    load_vec<VEC>(table + local * D + q * VEC, v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(v[k], w));
  }
  store_vec<VEC>(out + b * D + q * VEC, acc);
}

unsigned blocks_for(int64_t threads) { return static_cast<unsigned>((threads + kThreads - 1) / kThreads); }

}  // namespace

// table float32 [rows_local, D], ids int32 [n] → out float32 [n, D]
extern "C" int nvt_range_gather(const float* table, int64_t rows_local, int64_t start, int D, const int32_t* ids,
                                int64_t n, float* out, int vec, void* stream_ptr) {
  if (n == 0 || D == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (vec == 4)
    range_gather_kernel<4><<<blocks_for(n * (D / 4)), kThreads, 0, stream>>>(table, rows_local, start, D, ids, n, out);
  else
    range_gather_kernel<1><<<blocks_for(n * D), kThreads, 0, stream>>>(table, rows_local, start, D, ids, n, out);
  return static_cast<int>(cudaGetLastError());
}

// table float32 [rows_local, D] (rows_local >= 1), values int32 [B, L], mask
// float32 [B, L] → out float32 [B, D], the weighted sums
extern "C" int nvt_range_bag(const float* table, int64_t rows_local, int64_t start, int D, const int32_t* values,
                             const float* mask, int64_t B, int L, float* out, int vec, void* stream_ptr) {
  if (B == 0 || D == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (vec == 4)
    range_bag_kernel<4><<<blocks_for(B * (D / 4)), kThreads, 0, stream>>>(table, rows_local, start, D, values, mask,
                                                                         B, L, out);
  else
    range_bag_kernel<1><<<blocks_for(B * D), kThreads, 0, stream>>>(table, rows_local, start, D, values, mask, B, L,
                                                                    out);
  return static_cast<int>(cudaGetLastError());
}
