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
// valid id, into a gradient zeroed here (cudaMemsetAsync, as ddense_w);
// dw_j = sum_b g_b * dense_bj. A persistent grid; each warp takes a
// contiguous run of the batch's rows and a contiguous run of the linear
// gradient's tiles:
//
// - A row's fields are read once, held in registers (up to kRowRegs floats
//   a lane; wider rows are read again for dv), their sums over f by the
//   packed shuffles above, and dv written; then ddense, and each lane keeps
//   its dense column's partial of dw in a register over the warp's rows.
//   The block adds its warps' partials in shared memory and makes one
//   atomic a column; past 32 dense features the warp walks its rows again
//   for each further 32 (any nd, no shared-memory cap).
// - The linear gradient is K15d's scatter (range_scatter_grad) at D = 1: a
//   tile is 32 consecutive ids of one column (one coalesced load of the ids
//   and of g, the column's offset and size the same across the warp), equal
//   rows grouped and summed by row_groups.cuh's shuffle tree, one
//   red.global.add.f32 a group, and one hot row's sum carried in a register
//   across the warp's tiles. Criteo's small fields send most of a column's
//   ids to a few rows: a scalar atomic a term, lane f taking column f of a
//   row, serialized on them (kernel_ab.py's split on an H100 80GB HBM3 at
//   700 W: 0.39 ms at [65536, 26, 16] + 13, 0.26 of it those atomics,
//   against a bound of 0.0959).
//
// Atomics make the summation order, and so the last bits of dlinear and
// ddense_w, vary from run to run.
//
// A launch of at most kMaxCols fields takes their tables by value in a
// __grid_constant__ argument; more fields read a [3, F] int64 table on the
// card (the ids' pointers, the offsets and the sizes, copied there by the
// wrapper), so any F is one launch and the row's sums keep their order. The
// backward reads a tile's column once, the same entry in every lane.
//
// Bound: bytes. The forward reads v, the ids, the linear entries the batch
// touches and the dense features once; its ~3 F D flops a row are ~1/20 of
// the byte time at the float32 rate. The backward reads v, ids, g and the
// dense features, writes dv (and ddense), and writes the dense [sum V]
// linear gradient once (the zero fill).

#include <cuda_runtime.h>
#include <cstdint>

#include "chunks.cuh"
#include "row_groups.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 64;
constexpr unsigned int kMaxBlocks = 132 * 8;  // 8 blocks of 8 warps on each of the H100's SMs
constexpr int kRowRegs = 16;  // a row's floats a lane holds in the backward (rows up to 512 floats)

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

// A column's ids, first entry and size.
struct Column {
  const int32_t* ids;
  int64_t offset, size;
};

__device__ __forceinline__ Column column(const Columns& c, int col) { return {c.ids[col], c.offset[col], c.size[col]}; }

__device__ __forceinline__ Column column(const ColumnTable& c, int col) {
  return {reinterpret_cast<const int32_t*>(c.t[col]), c.t[c.F + col], c.t[2 * c.F + col]};
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

// The linear gradient of warp `warp`'s tiles [t0, t1) of the F * ceil(B /
// 32) (column-major: tile t is ids [32 (t % tiles), +32) of column t /
// tiles), summed by groups of equal rows, one hot row carried across them.
template <class Cols>
__device__ __forceinline__ void linear_grad_tiles(const Cols& c, const float* __restrict__ g, int64_t B, int64_t t0,
                                                  int64_t t1, float* __restrict__ dlinear) {
  const int lane = threadIdx.x & 31;
  const int64_t tiles = (B + 31) >> 5;
  int64_t carry_row = -1;  // warp-uniform; -1: nothing carried
  float carry = 0.0f;      // its sum, the same in every lane
  for (int64_t t = t0; t < t1; ++t) {
    const int col = static_cast<int>(t / tiles);
    const int64_t b = ((t - col * tiles) << 5) + lane;
    const Column cl = column(c, col);
    const int64_t row = b < B ? wrap_row(cl.ids[b], cl.offset, cl.size) : -1;
    const bool held = row >= 0;
    float v[1][1] = {{held ? g[b] : 0.0f}};
    if (__ballot_sync(nvt::kAllLanes, held) == 0) continue;
    const nvt::RowGroups groups(held, row, lane);
    const nvt::Carry joins = nvt::carry_keeper(groups, row, lane, carry_row);
    if (joins.restart) {
      if (lane == 0) atomicAdd(dlinear + carry_row, carry);
      carry = 0.0f;
    }
    carry_row = joins.row;
    groups.sum(v, lane);
    const float kept = __shfl_sync(nvt::kAllLanes, v[0][0], joins.lane < 0 ? 0 : joins.lane);
    if (joins.lane >= 0) carry += kept;
    if (groups.leader && lane != joins.lane) atomicAdd(dlinear + row, v[0][0]);
  }
  if (carry_row >= 0 && lane == 0) atomicAdd(dlinear + carry_row, carry);
}

// One row's dv: the field sums s_d over f, then g_b (s_d - v_bfd).
template <bool PACKED>
__device__ __forceinline__ void field_grad_row(const float* __restrict__ row, float* __restrict__ drow, int F, int D,
                                               float gb) {
  const int lane = threadIdx.x & 31;
  const int FD = F * D;
  if constexpr (PACKED) {
    if (FD <= 32 * kRowRegs) {  // the row read once, held in registers
      float x[kRowRegs];
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < kRowRegs; ++k) {
        const int e = lane + 32 * k;
        x[k] = e < FD ? row[e] : 0.0f;
        s += x[k];
      }
      s = packed_field_sum(s, D);
#pragma unroll
      for (int k = 0; k < kRowRegs; ++k) {
        const int e = lane + 32 * k;
        if (e < FD) drow[e] = gb * (s - x[k]);
      }
    } else {
      float s = 0.0f;
      for (int e = lane; e < FD; e += 32) s += row[e];
      s = packed_field_sum(s, D);
      for (int e = lane; e < FD; e += 32) drow[e] = gb * (s - row[e]);
    }
  } else {
    for (int d = lane; d < D; d += 32) {
      float s = 0.0f;
      for (int f = 0; f < F; ++f) s += row[f * D + d];
      for (int f = 0; f < F; ++f) drow[f * D + d] = gb * (s - row[f * D + d]);
    }
  }
}

// The block's dw partials of dense columns [j0, j0 + 32): each warp's lane j
// holds its own, summed over the warps in shared memory, one atomic a column.
__device__ __forceinline__ void add_dense_partials(float (*part)[32], float acc, int j0, int nd,
                                                   float* __restrict__ ddense_w) {
  part[threadIdx.x >> 5][threadIdx.x & 31] = acc;
  __syncthreads();
  if (threadIdx.x < 32 && j0 + static_cast<int>(threadIdx.x) < nd) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += part[w][threadIdx.x];
    atomicAdd(ddense_w + j0 + threadIdx.x, s);
  }
  __syncthreads();
}

template <bool PACKED, class Cols>
__global__ void __launch_bounds__(kThreads)
fm_bwd_kernel(const __grid_constant__ Cols c, int F, int D, const float* __restrict__ v,
              int64_t v_row_stride, const float* __restrict__ dense, int64_t dense_row_stride,
              int nd, const float* __restrict__ dense_w, const float* __restrict__ g, int64_t B,
              float* __restrict__ dv, int64_t dv_row_stride, float* __restrict__ ddense,
              int64_t ddense_row_stride, float* __restrict__ dlinear, float* __restrict__ ddense_w) {
  __shared__ float part[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int64_t tiles = ((B + 31) >> 5) * F;
  linear_grad_tiles(c, g, B, tiles * warp / warps, tiles * (warp + 1) / warps, dlinear);
  const int64_t r0 = B * warp / warps, r1 = B * (warp + 1) / warps;
  float acc = 0.0f;  // lane j's partial of dw_j
  const float wj = lane < nd ? dense_w[lane] : 0.0f;
  for (int64_t b = r0; b < r1; ++b) {
    const float gb = g[b];
    field_grad_row<PACKED>(v + b * v_row_stride, dv + b * dv_row_stride, F, D, gb);
    if (lane < nd) {
      ddense[b * ddense_row_stride + lane] = gb * wj;
      acc = fmaf(gb, dense[b * dense_row_stride + lane], acc);
    }
  }
  add_dense_partials(part, acc, 0, nd, ddense_w);
  for (int j0 = 32; j0 < nd; j0 += 32) {  // the dense features past 32, 32 a walk of the rows
    const int j = j0 + lane;
    const float w = j < nd ? dense_w[j] : 0.0f;
    acc = 0.0f;
    if (j < nd) {
      for (int64_t b = r0; b < r1; ++b) {
        const float gb = g[b];
        ddense[b * ddense_row_stride + j] = gb * w;
        acc = fmaf(gb, dense[b * dense_row_stride + j], acc);
      }
    }
    add_dense_partials(part, acc, j0, nd, ddense_w);
  }
}

void fill_columns(Columns* c, const void* const* ids, const int64_t* offsets, const int64_t* sizes, int num_cols) {
  for (int k = 0; k < num_cols; ++k) {
    c->ids[k] = static_cast<const int32_t*>(ids[k]);
    c->offset[k] = offsets[k];
    c->size[k] = sizes[k];
  }
}

bool bad_shape(int F, int D, int nd, int64_t B) { return F <= 0 || D <= 0 || nd < 0 || B < 0; }

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

  template <bool PACKED, class Cols>
  int run(const Cols& c) const {
    // a persistent grid, at most one block a warp's row
    unsigned blocks = 0;
    if (int rc = nvt::resident_blocks(fm_bwd_kernel<PACKED, Cols>, kThreads, 0, (B + kWarps - 1) / kWarps, &blocks))
      return rc;
    fm_bwd_kernel<PACKED><<<blocks, kThreads, 0, s>>>(c, F, D, v, v_row_stride, dense, dense_row_stride, nd, dense_w,
                                                      g, B, dv, dv_row_stride, ddense, ddense_row_stride, dlinear,
                                                      ddense_w);
    return static_cast<int>(cudaGetLastError());
  }

  template <class Cols>
  int launch(const Cols& c) const {
    return 32 % D == 0 ? run<true>(c) : run<false>(c);
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

// dlinear [num_rows] and ddense_w [nd] are zeroed here, then summed into.
extern "C" int nvt_fm_bwd(const void* const* ids, const int64_t* offsets, const int64_t* sizes,
                          const int64_t* col_table, int num_cols, int D, const float* v, int64_t v_row_stride,
                          const float* dense, int64_t dense_row_stride, int nd,
                          const float* dense_w, const float* g, int64_t B, float* dv,
                          int64_t dv_row_stride, float* ddense, int64_t ddense_row_stride,
                          float* dlinear, int64_t num_rows, float* ddense_w, void* stream) {
  if (bad_shape(num_cols, D, nd, B) || num_rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(dlinear, 0, static_cast<size_t>(num_rows) * sizeof(float), s);
  if (err == cudaSuccess) err = cudaMemsetAsync(ddense_w, 0, static_cast<size_t>(nd) * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0) return 0;
  const BwdArgs a{num_cols, D, v, v_row_stride, dense, dense_row_stride, nd, dense_w, g, B, dv, dv_row_stride,
                  ddense, ddense_row_stride, dlinear, ddense_w, s};
  return launch_with_columns(a, ids, offsets, sizes, col_table);
}
