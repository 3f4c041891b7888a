// The row-sharded embedding lookup and bag for Hopper (sm_90a): kernel K15b,
// and the multi-column lookup and gradient of the sharded train step: K15d.
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
//
// Kernel K15d: the lookup and its gradient inside the sharded DLRM train
// step (nvtabular_tpu/parallel/train.py:39-81 with the P("model", None)
// tables of models/dlrm.py:144-158, which GSPMD gathers shard by shard). A
// rank holds rows [start_c, start_c + size_c) of each table c, padded to
// Vp_c rows, all in one concatenated shard (column c from row offset_c);
// ids are global and follow jnp.take on the whole padded table: a negative
// id wraps once by Vp_c, and an id still outside [0, Vp_c) is held by no
// rank. Every rank decides from Vp_c, so all decide alike.
//
// nvt_range_gather_columns: out[b, c] = shard[offset_c + id - start_c] for
// the ids this rank holds, zeros for another rank's, and NaN for ids no
// rank holds on model rank 0 only (zeros on the others): the sum over the
// model group then gives jnp.take's rows, NaN included. The output is a
// contiguous [B, C, D] buffer that the group's all_reduce takes in place.
// K13a's gather (csrc/embedding.cu) with a row range per column.
//
// nvt_range_scatter_grad: the dense [rows_local, D] gradient of the shard,
// a zero fill (cudaMemsetAsync) then one atomic reduction per float4 (per
// float where D % 4 != 0) for each id this rank holds; another rank's ids
// and ids no rank holds add nothing. The gradient may be a strided view
// (grad_row_stride floats between rows: slots 1..C of the [B, 1 + C, D]
// features' gradient). Atomics make the summation order, and so the last
// bits, vary from run to run. Bound: bytes — the zero fill of the shard's
// gradient, the ids and the gradient rows this rank holds, once each.

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

constexpr int kMaxCols = 64;
constexpr int64_t kElsewhere = -1;  // a row another rank holds
constexpr int64_t kNoRank = -2;     // an id outside [-Vp, Vp): no rank holds it

struct RangeColumns {
  const int32_t* ids[kMaxCols];  // [B] each
  int64_t offset[kMaxCols];      // the column's first row in the shard
  int64_t size[kMaxCols];        // the column's rows in the shard
  int64_t start[kMaxCols];       // the global row of its first shard row
  int64_t padded[kMaxCols];      // the table's padded global size Vp
};

// The shard row of id b of column col, or kElsewhere / kNoRank.
__device__ __forceinline__ int64_t shard_row(const RangeColumns& c, int col, int64_t b) {
  int64_t id = c.ids[col][b];
  const int64_t vp = c.padded[col];
  if (id < 0) id += vp;
  if (id < 0 || id >= vp) return kNoRank;
  const int64_t local = id - c.start[col];
  return (local >= 0 && local < c.size[col]) ? c.offset[col] + local : kElsewhere;
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
range_gather_columns_kernel(const __grid_constant__ RangeColumns c, int num_cols, const float* __restrict__ table,
                            int D, int64_t B, int write_nan, float* __restrict__ out) {
  const int per_row = D / VEC;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= B * num_cols * per_row) return;
  const int64_t rc = t / per_row;  // b * num_cols + col: out's row
  const int q = static_cast<int>(t - rc * per_row);
  const int64_t b = rc / num_cols;
  const int col = static_cast<int>(rc - b * num_cols);
  const int64_t row = shard_row(c, col, b);
  float v[VEC];
  if (row >= 0) {
    load_vec<VEC>(table + row * D + q * VEC, v);
  } else {
    const float fill = (row == kNoRank && write_nan) ? __int_as_float(0x7fc00000) : 0.0f;
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = fill;
  }
  store_vec<VEC>(out + rc * D + q * VEC, v);
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
range_scatter_grad_kernel(const __grid_constant__ RangeColumns c, int num_cols, const float* __restrict__ grad,
                          int64_t grad_row_stride, int D, int64_t B, float* __restrict__ dtable) {
  const int per_row = D / VEC;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= B * num_cols * per_row) return;
  const int64_t rc = t / per_row;
  const int q = static_cast<int>(t - rc * per_row);
  const int64_t b = rc / num_cols;
  const int col = static_cast<int>(rc - b * num_cols);
  const int64_t row = shard_row(c, col, b);
  if (row < 0) return;
  const float* src = grad + b * grad_row_stride + static_cast<int64_t>(col) * D + q * VEC;
  float* dst = dtable + row * D + q * VEC;
  if constexpr (VEC == 4) {
    // one vector reduction (red.global.add.v4.f32, compute capability 9.x)
    atomicAdd(reinterpret_cast<float4*>(dst), *reinterpret_cast<const float4*>(src));
  } else {
    atomicAdd(dst, *src);
  }
}

int fill_range_columns(RangeColumns* c, const void* const* ids, const int64_t* offsets, const int64_t* sizes,
                       const int64_t* starts, const int64_t* padded, int num_cols) {
  if (num_cols < 1 || num_cols > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < num_cols; ++k) {
    c->ids[k] = static_cast<const int32_t*>(ids[k]);
    c->offset[k] = offsets[k];
    c->size[k] = sizes[k];
    c->start[k] = starts[k];
    c->padded[k] = padded[k];
  }
  return 0;
}

bool bad_range_shape(int D, int64_t B, int vec) {
  return D <= 0 || B < 0 || (vec != 1 && vec != 4) || D % vec != 0;
}

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

// ids: C int32 [B] columns; offsets, sizes, starts, padded: int64 [C];
// table float32 [rows_local, D] → out float32 [B, C, D], contiguous.
// model_rank 0 writes NaN for the ids no rank holds.
extern "C" int nvt_range_gather_columns(const void* const* ids, const int64_t* offsets, const int64_t* sizes,
                                        const int64_t* starts, const int64_t* padded, int num_cols,
                                        const float* table, int D, int64_t B, int model_rank, float* out, int vec,
                                        void* stream_ptr) {
  RangeColumns c;
  if (int rc = fill_range_columns(&c, ids, offsets, sizes, starts, padded, num_cols)) return rc;
  if (bad_range_shape(D, B, vec)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = B * num_cols * (D / vec);
  if (total == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int write_nan = model_rank == 0;
  if (vec == 4)
    range_gather_columns_kernel<4><<<blocks_for(total), kThreads, 0, stream>>>(c, num_cols, table, D, B, write_nan,
                                                                              out);
  else
    range_gather_columns_kernel<1><<<blocks_for(total), kThreads, 0, stream>>>(c, num_cols, table, D, B, write_nan,
                                                                              out);
  return static_cast<int>(cudaGetLastError());
}

// grad float32 [B, C, D] with rows grad_row_stride floats apart (each
// row's [C, D] block contiguous) → dtable float32 [rows_local, D], zeroed
// here, then the atomics.
extern "C" int nvt_range_scatter_grad(const void* const* ids, const int64_t* offsets, const int64_t* sizes,
                                      const int64_t* starts, const int64_t* padded, int num_cols, const float* grad,
                                      int64_t grad_row_stride, int D, int64_t B, float* dtable, int64_t rows_local,
                                      int vec, void* stream_ptr) {
  RangeColumns c;
  if (int rc = fill_range_columns(&c, ids, offsets, sizes, starts, padded, num_cols)) return rc;
  if (bad_range_shape(D, B, vec) || rows_local < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (rows_local > 0) {
    const cudaError_t err = cudaMemsetAsync(dtable, 0, static_cast<size_t>(rows_local) * D * sizeof(float), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t total = B * num_cols * (D / vec);
  if (total == 0) return 0;
  if (vec == 4)
    range_scatter_grad_kernel<4><<<blocks_for(total), kThreads, 0, stream>>>(c, num_cols, grad, grad_row_stride, D,
                                                                            B, dtable);
  else
    range_scatter_grad_kernel<1><<<blocks_for(total), kThreads, 0, stream>>>(c, num_cols, grad, grad_row_stride, D,
                                                                            B, dtable);
  return static_cast<int>(cudaGetLastError());
}
