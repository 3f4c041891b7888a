// Embedding gather and its transpose for Hopper (sm_90a): kernel K13a.
//
// Replaces nvtabular_tpu/models/layers.py:70-72 (embedding_lookup,
// jnp.take(table, ids, axis=0)) as DLRM calls it once per table
// (nvtabular_tpu/models/dlrm.py:123-124), followed by the jnp.stack of the
// features (:133), and the transpose XLA derives for it: a scatter-add of
// the feature gradient into a dense table gradient.
//
// The tables live in one concatenated float32 [sum V, D] array; column c
// owns rows [offset[c], offset[c] + size[c]). Ids follow jnp.take's
// defaults: a negative id wraps once (id + size), and an id still outside
// [0, size) reads a NaN row in the forward and is dropped from the
// gradient. No id reads or writes outside its column's rows.
//
// nvt_embedding_gather: out[b, c, :] = table[offset[c] + id_c[b], :], where
// `out` is a strided view (row stride out_row_stride floats, column stride
// D): DLRM passes features slots 1..C of its [B, 1 + C, D] buffer, so no
// stack follows. One thread copies VEC floats (a float4 when D % 4 == 0 and
// the pointers are 16-byte aligned); consecutive threads write consecutive
// addresses. Bound: bytes — the ids (4 B each), each distinct table row the
// batch touches (D * 4 B), and the output (D * 4 B per id) once each.
//
// nvt_embedding_scatter_grad: dtable[offset[c] + id_c[b], :] += grad[b, c, :]
// into a gradient the wrapper has zeroed, with one fire-and-forget atomic
// reduction per float4 (Hopper's vector atomicAdd) or per float where D is
// not a multiple of 4. Skewed columns send many rows of a
// batch to the same few table rows, and those atomics serialize at L2; a
// later version can pre-reduce in shared memory or sort the ids. Atomics
// make the summation order, and so the last bits, vary from run to run.
// Bound: bytes — the zeroed dense gradient written once (sum V * D * 4 B),
// the ids and the feature gradient read once.
//
// A launch takes the tables of up to kMaxCols columns by value in a
// __grid_constant__ argument (1.5 KB); a call of more columns launches once
// for each chunk of kMaxCols (chunks.cuh), the output and gradient
// pointers moved to the chunk's first column. A launch's flat index (rows x
// columns x vectors a row) stays within int32: a larger batch launches once
// for each chunk of rows (the host plans them: kernels/embedding.py
// launch_rows), the ids, output and gradient moved to the chunk's first
// row.

#include <cuda_runtime.h>
#include <cstdint>

#include "chunks.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 64;

struct Columns {
  const int32_t* ids[kMaxCols];  // [B] each
  int64_t offset[kMaxCols];
  int64_t size[kMaxCols];
};

// Row of the concatenated table for id b of column col, or -1 when the id
// is outside the column's table after jnp.take's wrap of negative ids.
__device__ __forceinline__ int64_t table_row(const Columns& c, int col, int b) {
  int64_t id = c.ids[col][b];
  const int64_t size = c.size[col];
  if (id < 0) id += size;
  return (id >= 0 && id < size) ? c.offset[col] + id : -1;
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const __grid_constant__ Columns c, int num_cols, const float* __restrict__ table,
              int D, int B, float* __restrict__ out, int64_t out_row_stride) {
  const int per_row = D / VEC;
  const int t = blockIdx.x * kThreads + threadIdx.x;  // a launch's B * C * per_row is below 2^31
  if (t >= B * num_cols * per_row) return;
  const int rc = t / per_row;
  const int q = t - rc * per_row;
  const int b = rc / num_cols;
  const int col = rc - b * num_cols;
  const int64_t row = table_row(c, col, b);
  float* dst = out + b * out_row_stride + static_cast<int64_t>(col) * D + q * VEC;
  if constexpr (VEC == 4) {
    const float nan = __int_as_float(0x7fc00000);
    float4 v = make_float4(nan, nan, nan, nan);
    if (row >= 0) v = *reinterpret_cast<const float4*>(table + row * D + q * 4);
    *reinterpret_cast<float4*>(dst) = v;
  } else {
    *dst = row >= 0 ? table[row * D + q] : __int_as_float(0x7fc00000);
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
scatter_grad_kernel(const __grid_constant__ Columns c, int num_cols, const float* __restrict__ grad,
                    int64_t grad_row_stride, int D, int B, float* __restrict__ dtable) {
  const int per_row = D / VEC;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= B * num_cols * per_row) return;
  const int rc = t / per_row;
  const int q = t - rc * per_row;
  const int b = rc / num_cols;
  const int col = rc - b * num_cols;
  const int64_t row = table_row(c, col, b);
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

// Columns [c0, c0 + n) of the call's tables from row b0 (a chunk: the
// columns and the rows are independent).
void fill_columns(Columns* c, const void* const* ids, const int64_t* offsets, const int64_t* sizes, int c0,
                  int n, int64_t b0) {
  for (int k = 0; k < n; ++k) {
    c->ids[k] = static_cast<const int32_t*>(ids[c0 + k]) + b0;
    c->offset[k] = offsets[c0 + k];
    c->size[k] = sizes[c0 + k];
  }
}

// rows: the rows of a launch, whose flat index over the widest chunk of
// columns stays within int32.
bool bad_shape(int num_cols, int D, int64_t B, int vec, int64_t rows) {
  if (num_cols < 0 || D <= 0 || B < 0 || (vec != 1 && vec != 4) || D % vec != 0 || rows < 1) return true;
  const int64_t per_row = static_cast<int64_t>(nvt::chunk_size(num_cols, 0, kMaxCols)) * (D / vec);
  return per_row > 0 && rows > INT32_MAX / per_row;
}

// launch(c0, n, b0, m) for each chunk of kMaxCols columns and, in it, each
// chunk of `rows` rows.
template <class Launch>
int for_each_launch(int num_cols, int64_t B, int64_t rows, Launch launch) {
  return nvt::for_each_chunk(num_cols, kMaxCols, [&](int c0, int n) {
    return nvt::for_each_chunk(B, rows, [&](int64_t b0, int64_t m) { return launch(c0, n, b0, static_cast<int>(m)); });
  });
}

}  // namespace

// rows: the rows of a launch (the host's plan); *launches: the kernel
// launches made, one for each chunk of kMaxCols columns and of rows.
extern "C" int nvt_embedding_gather(const void* const* ids, const int64_t* offsets,
                                    const int64_t* sizes, int num_cols, const float* table, int D,
                                    int64_t B, int64_t rows_per_launch, float* out, int64_t out_row_stride,
                                    int vec, int* launches, void* stream) {
  if (bad_shape(num_cols, D, B, vec, rows_per_launch)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return for_each_launch(num_cols, B, rows_per_launch, [&](int c0, int n, int64_t b0, int rows) {
    Columns c;
    fill_columns(&c, ids, offsets, sizes, c0, n, b0);
    const unsigned int blocks = static_cast<unsigned int>((int64_t{rows} * n * (D / vec) + kThreads - 1) / kThreads);
    float* o = out + b0 * out_row_stride + static_cast<int64_t>(c0) * D;
    if (vec == 4)
      gather_kernel<4><<<blocks, kThreads, 0, s>>>(c, n, table, D, rows, o, out_row_stride);
    else
      gather_kernel<1><<<blocks, kThreads, 0, s>>>(c, n, table, D, rows, o, out_row_stride);
    return nvt::launched(launches);
  });
}

extern "C" int nvt_embedding_scatter_grad(const void* const* ids, const int64_t* offsets,
                                          const int64_t* sizes, int num_cols, const float* grad,
                                          int64_t grad_row_stride, int D, int64_t B, int64_t rows_per_launch,
                                          float* dtable, int vec, int* launches, void* stream) {
  if (bad_shape(num_cols, D, B, vec, rows_per_launch)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return for_each_launch(num_cols, B, rows_per_launch, [&](int c0, int n, int64_t b0, int rows) {
    Columns c;
    fill_columns(&c, ids, offsets, sizes, c0, n, b0);
    const unsigned int blocks = static_cast<unsigned int>((int64_t{rows} * n * (D / vec) + kThreads - 1) / kThreads);
    const float* g = grad + b0 * grad_row_stride + static_cast<int64_t>(c0) * D;
    if (vec == 4)
      scatter_grad_kernel<4><<<blocks, kThreads, 0, s>>>(c, n, g, grad_row_stride, D, rows, dtable);
    else
      scatter_grad_kernel<1><<<blocks, kThreads, 0, s>>>(c, n, g, grad_row_stride, D, rows, dtable);
    return nvt::launched(launches);
  });
}
