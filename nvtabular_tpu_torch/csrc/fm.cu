// DeepFM's factorization-machine terms and their gradient for Hopper
// (sm_90a): kernel K16.
//
// Replaces nvtabular_tpu/models/deepfm.py:58-68 (deepfm_forward): the
// second-order term 0.5 * sum_d[(sum_f v)^2 - sum_f v^2] over the stacked
// features v [B, F, D] (:62-64), the first-order jnp.take of every table's
// linear weights plus dense @ dense_w (:66-68), and the transpose XLA
// derives for them.
//
// The linear weights of all tables live in one float32 [sum V] array;
// column f owns entries [offset[f], offset[f] + size[f]). Ids follow
// jnp.take's defaults as in K13a: a negative id wraps once, an id still out
// of range reads NaN and is dropped from the gradient.
//
// v is a strided view: row b's [F, D] block is contiguous and starts at
// v + b * v_row_stride. DeepFM passes columns 0..F*D-1 of its [B, F*D + nd]
// deep-tower input, whose columns F*D.. hold the dense features (`dense`,
// row stride dense_row_stride), so each row is read once, without a copy.
//
// One warp takes one row at a time. When 32 % D == 0 the lanes walk the
// row's F*D floats with stride 32, so every element a lane reads has the
// same d = lane % D; each lane sums its elements and their squares, and
// xor-shuffles over lane distances D, 2D, .., 16 leave s_d = sum_f v_bfd
// and q_d = sum_f v_bfd^2 in every lane (coalesced, no shared memory).
// Otherwise a lane takes d = lane, lane + 32, .. and loops over f. Lanes
// take the linear lookups (lane f) and the dense dot (lane j); three warp
// sums finish the row: out[b] = (lin + dense . w) + 0.5 * sum_d (s_d^2 - q_d),
// JAX's order of the last two additions (fm1 + fm2).
//
// nvt_fm_bwd, given g [B]: dv_bfd = g_b * (s_bd - v_bfd) and ddense_bj =
// g_b * w_j (rows written with their own row strides, so the gradient can
// land in the two slots of a wider buffer); dlinear[row] += g_b for every
// valid id (one atomic each into a gradient the wrapper zeroed);
// dw_j = sum_b g_b * dense_bj, summed per block in shared memory, then one
// atomic per block and column. Atomics make the summation order, and so
// the last bits, vary from run to run.
//
// A launch of at most kMaxCols fields takes their tables by value in a
// __grid_constant__ argument; more fields read a [3, F] int64 table on the
// card (the ids' pointers, the offsets and the sizes, copied there by the
// wrapper), so any F is one launch and the row's sums keep their order.
//
// Bound: bytes. The forward reads v, the ids, the linear entries the batch
// touches and the dense features once; its ~3 F D flops a row are ~1/20 of
// the byte time at the float32 rate. The backward reads v, ids, g and the
// dense features, writes dv (and ddense), and writes the dense [sum V]
// linear gradient once (the wrapper's memset).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 64;
constexpr unsigned int kMaxBlocks = 132 * 8;  // 8 blocks of 8 warps on each of the H100's SMs
constexpr int kSmemLimit = 48 * 1024;

struct Columns {
  const int32_t* ids[kMaxCols];  // [B] each
  int64_t offset[kMaxCols];
  int64_t size[kMaxCols];
};

// The same tables on the card: rows ids' pointers, offsets, sizes.
struct ColumnTable {
  const int64_t* t;  // [3, F]
  int F;
};

__device__ __forceinline__ int64_t wrap_row(int64_t id, int64_t offset, int64_t size) {
  if (id < 0) id += size;
  return (id >= 0 && id < size) ? offset + id : -1;
}

// Entry of the concatenated linear weights for id b of column col, or -1
// when the id is outside the column's table after jnp.take's wrap.
__device__ __forceinline__ int64_t table_row(const Columns& c, int col, int64_t b) {
  return wrap_row(c.ids[col][b], c.offset[col], c.size[col]);
}

__device__ __forceinline__ int64_t table_row(const ColumnTable& c, int col, int64_t b) {
  const int32_t* ids = reinterpret_cast<const int32_t*>(c.t[col]);
  return wrap_row(ids[b], c.t[c.F + col], c.t[2 * c.F + col]);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// After each lane has summed its elements e = lane + 32 k (all of one d =
// lane % D, D dividing 32): the sum over f of that d in every lane.
__device__ __forceinline__ float packed_field_sum(float v, int D) {
  for (int off = D; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <bool PACKED, class Cols>
__global__ void __launch_bounds__(kThreads)
fm_fwd_kernel(const __grid_constant__ Cols c, int F, int D, const float* __restrict__ v,
              int64_t v_row_stride, const float* __restrict__ dense, int64_t dense_row_stride,
              int nd, const float* __restrict__ linear, const float* __restrict__ dense_w, int64_t B,
              float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * kWarps;
  const int FD = F * D;
  for (int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5); b < B; b += nwarps) {
    const float* row = v + b * v_row_stride;
    float pair = 0.0f;  // this lane's share of sum_d (s_d^2 - q_d)
    if constexpr (PACKED) {
      float s = 0.0f, q = 0.0f;
      for (int e = lane; e < FD; e += 32) {
        const float x = row[e];
        s += x;
        q = fmaf(x, x, q);
      }
      s = packed_field_sum(s, D);
      q = packed_field_sum(q, D);
      if (lane < D) pair = s * s - q;  // lanes 0..D-1 hold each d once
    } else {
      for (int d = lane; d < D; d += 32) {
        float s = 0.0f, q = 0.0f;
        for (int f = 0; f < F; ++f) {
          const float x = row[f * D + d];
          s += x;
          q = fmaf(x, x, q);
        }
        pair += s * s - q;
      }
    }
    float lin = 0.0f;
    for (int f = lane; f < F; f += 32) {
      const int64_t r = table_row(c, f, b);
      lin += r >= 0 ? linear[r] : __int_as_float(0x7fc00000);
    }
    float dw = 0.0f;
    for (int j = lane; j < nd; j += 32) dw = fmaf(dense[b * dense_row_stride + j], dense_w[j], dw);
    pair = warp_sum(pair);
    lin = warp_sum(lin);
    dw = warp_sum(dw);
    if (lane == 0) out[b] = (lin + dw) + 0.5f * pair;
  }
}

template <bool PACKED, class Cols>
__global__ void __launch_bounds__(kThreads)
fm_bwd_kernel(const __grid_constant__ Cols c, int F, int D, const float* __restrict__ v,
              int64_t v_row_stride, const float* __restrict__ dense, int64_t dense_row_stride,
              int nd, const float* __restrict__ dense_w, const float* __restrict__ g, int64_t B,
              float* __restrict__ dv, int64_t dv_row_stride, float* __restrict__ ddense,
              int64_t ddense_row_stride, float* __restrict__ dlinear, float* __restrict__ ddense_w) {
  extern __shared__ float wsum[];  // the block's nd partial sums of dw
  for (int j = threadIdx.x; j < nd; j += kThreads) wsum[j] = 0.0f;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * kWarps;
  const int FD = F * D;
  for (int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5); b < B; b += nwarps) {
    const float gb = g[b];
    const float* row = v + b * v_row_stride;
    float* drow = dv + b * dv_row_stride;
    if constexpr (PACKED) {
      float s = 0.0f;
      for (int e = lane; e < FD; e += 32) s += row[e];
      s = packed_field_sum(s, D);
      for (int e = lane; e < FD; e += 32) drow[e] = gb * (s - row[e]);
    } else {
      for (int d = lane; d < D; d += 32) {
        float s = 0.0f;
        for (int f = 0; f < F; ++f) s += row[f * D + d];
        for (int f = 0; f < F; ++f) drow[f * D + d] = gb * (s - row[f * D + d]);
      }
    }
    for (int f = lane; f < F; f += 32) {
      const int64_t r = table_row(c, f, b);
      if (r >= 0) atomicAdd(dlinear + r, gb);
    }
    for (int j = lane; j < nd; j += 32) {
      ddense[b * ddense_row_stride + j] = gb * dense_w[j];
      atomicAdd(wsum + j, gb * dense[b * dense_row_stride + j]);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < nd; j += kThreads) atomicAdd(ddense_w + j, wsum[j]);
}

void fill_columns(Columns* c, const void* const* ids, const int64_t* offsets, const int64_t* sizes, int num_cols) {
  for (int k = 0; k < num_cols; ++k) {
    c->ids[k] = static_cast<const int32_t*>(ids[k]);
    c->offset[k] = offsets[k];
    c->size[k] = sizes[k];
  }
}

bool bad_shape(int F, int D, int nd, int64_t B) {
  return F <= 0 || D <= 0 || nd < 0 || B < 0 || static_cast<int64_t>(nd) * 4 > kSmemLimit;
}

unsigned int blocks_for(int64_t B) {
  const int64_t need = (B + kWarps - 1) / kWarps;
  return static_cast<unsigned int>(need < kMaxBlocks ? need : kMaxBlocks);
}

struct FwdArgs {
  int F, D;
  const float* v;
  int64_t v_row_stride;
  const float* dense;
  int64_t dense_row_stride;
  int nd;
  const float* linear;
  const float* dense_w;
  int64_t B;
  float* out;
  cudaStream_t s;

  template <class Cols>
  int launch(const Cols& c) const {
    if (32 % D == 0)
      fm_fwd_kernel<true><<<blocks_for(B), kThreads, 0, s>>>(c, F, D, v, v_row_stride, dense, dense_row_stride, nd,
                                                             linear, dense_w, B, out);
    else
      fm_fwd_kernel<false><<<blocks_for(B), kThreads, 0, s>>>(c, F, D, v, v_row_stride, dense, dense_row_stride, nd,
                                                              linear, dense_w, B, out);
    return static_cast<int>(cudaGetLastError());
  }
};

struct BwdArgs {
  int F, D;
  const float* v;
  int64_t v_row_stride;
  const float* dense;
  int64_t dense_row_stride;
  int nd;
  const float* dense_w;
  const float* g;
  int64_t B;
  float* dv;
  int64_t dv_row_stride;
  float* ddense;
  int64_t ddense_row_stride;
  float* dlinear;
  float* ddense_w;
  cudaStream_t s;

  template <class Cols>
  int launch(const Cols& c) const {
    const size_t smem = static_cast<size_t>(nd) * 4;
    if (32 % D == 0)
      fm_bwd_kernel<true><<<blocks_for(B), kThreads, smem, s>>>(c, F, D, v, v_row_stride, dense, dense_row_stride,
                                                                nd, dense_w, g, B, dv, dv_row_stride, ddense,
                                                                ddense_row_stride, dlinear, ddense_w);
    else
      fm_bwd_kernel<false><<<blocks_for(B), kThreads, smem, s>>>(c, F, D, v, v_row_stride, dense, dense_row_stride,
                                                                 nd, dense_w, g, B, dv, dv_row_stride, ddense,
                                                                 ddense_row_stride, dlinear, ddense_w);
    return static_cast<int>(cudaGetLastError());
  }
};

// The tables by value up to kMaxCols fields, else the card's copy
// (col_table, int64 [3, F]; null where F <= kMaxCols).
template <class Args>
int launch_with_columns(const Args& a, const void* const* ids, const int64_t* offsets, const int64_t* sizes,
                        const int64_t* col_table) {
  if (a.F <= kMaxCols) {
    Columns c;
    fill_columns(&c, ids, offsets, sizes, a.F);
    return a.launch(c);
  }
  if (col_table == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return a.launch(ColumnTable{col_table, a.F});
}

}  // namespace

extern "C" int nvt_fm_fwd(const void* const* ids, const int64_t* offsets, const int64_t* sizes,
                          const int64_t* col_table, int num_cols, int D, const float* v, int64_t v_row_stride,
                          const float* dense, int64_t dense_row_stride, int nd,
                          const float* linear, const float* dense_w, int64_t B, float* out,
                          void* stream) {
  if (bad_shape(num_cols, D, nd, B)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const FwdArgs a{num_cols, D, v, v_row_stride, dense, dense_row_stride, nd, linear, dense_w, B, out,
                  static_cast<cudaStream_t>(stream)};
  return launch_with_columns(a, ids, offsets, sizes, col_table);
}

extern "C" int nvt_fm_bwd(const void* const* ids, const int64_t* offsets, const int64_t* sizes,
                          const int64_t* col_table, int num_cols, int D, const float* v, int64_t v_row_stride,
                          const float* dense, int64_t dense_row_stride, int nd,
                          const float* dense_w, const float* g, int64_t B, float* dv,
                          int64_t dv_row_stride, float* ddense, int64_t ddense_row_stride,
                          float* dlinear, float* ddense_w, void* stream) {
  if (bad_shape(num_cols, D, nd, B)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const BwdArgs a{num_cols, D, v, v_row_stride, dense, dense_row_stride, nd, dense_w, g, B, dv, dv_row_stride,
                  ddense, ddense_row_stride, dlinear, ddense_w, static_cast<cudaStream_t>(stream)};
  return launch_with_columns(a, ids, offsets, sizes, col_table);
}
