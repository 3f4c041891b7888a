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

#include "async.cuh"

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
// as XLA's do; mean divides by max(offsets[r + 1] - offsets[r], 1).
//
// Bound: bytes (4 B a value and 8 B an offset read once, 4 B a row
// written). Skew is the design problem: in a session column one row can
// hold a fifth of all values, and most rows are short. So the work is split
// by merge path (Merrill & Garland's merge-based CSR SpMV, SC'16; CUB's
// DeviceSpmv): the row ends of rows [0, n_end) (n_end = min(num_rows, R))
// and the T values form one path in which row end x comes right after the
// values before offsets[x + 1]; a tile is kSegTile consecutive items of it,
// values and row ends alike, so an empty row costs an item and a head row
// of millions of values costs its bytes. Three launches:
//
// 1. The plan: a warp a tile boundary finds the row ends before it by a
//    64-ary search over the offsets (its lanes probe at once, 3 rounds for
//    147K rows), all tiles at once; no thread searches alone.
// 2. The tiles, a block each (kSegItems items a thread): the tile's values
//    go to shared memory by 16-byte cp.async (4-byte at the edges), its row
//    ends as int32 positions among them, so that the walk compares ints;
//    each thread finds its items by a binary search in shared memory and
//    walks them, the next row end in a register. A row that ends inside
//    the tile is finalized (the mean's division, min / max's key decode)
//    and stored once; the runs that cross threads are joined by a segmented
//    scan over the block (warp shuffles, then the warps' totals). The
//    tile's first row, which may have begun in an earlier tile, is not
//    stored: its tile-local part goes to head[k], and the part of the row
//    still open at the tile's end to tail[k]. The work is counted in
//    instructions a tile as much as in bytes (PERF.md), so a tile is large:
//    3,840 items.
// 3. The fix-up, one block: a segmented scan of the tails in tile order
//    gives each tile the carry of its first row; that row, and row n_end
//    (the values past the last row end: row R where num_rows > R), are
//    finalized and stored, and rows past R + 1 get the empty row's value.
//
// Every row is written once, by one thread, with no atomics and no pass
// over all rows to initialize or finalize them; every sum is taken in an
// order fixed by the shapes alone, so a sum is the same from run to run.
// min and max run on ordered int keys (the int order is the float order,
// -0.0 below 0.0 as XLA's min and max pick them; NaN is the extreme that
// wins). Float32 sums run in another order than XLA's scatter. The offsets
// must ascend, as the reference's searchsorted needs; offsets that do not
// give wrong rows but never a read or write out of bounds.

namespace {

constexpr int kSegThreads = 256;
constexpr int kSegItems = 15;  // a thread's items: odd, so that its neighbours' values sit in other banks
constexpr int kSegTile = kSegThreads * kSegItems;
constexpr int kPlanThreads = 256;  // 8 tile boundaries a block, a warp each
constexpr int kFixThreads = 1024;
constexpr int kFixItems = 4;  // tiles a fix-up thread scans in turn
constexpr int kSum = 0, kMean = 1, kMin = 2, kMax = 3;

__device__ __forceinline__ int32_t ordered_key(float v) {
  const int32_t b = __float_as_int(v);
  return b ^ ((b >> 31) & 0x7FFFFFFF);
}

template <int kOp>
struct Op {  // sum and mean
  using T = float;
  static __device__ __forceinline__ T identity() { return 0.0f; }
  static __device__ __forceinline__ T load(float v) { return v; }
  static __device__ __forceinline__ T combine(T a, T b) { return __fadd_rn(a, b); }
};

template <>
struct Op<kMin> {
  using T = int32_t;
  static __device__ __forceinline__ T identity() { return 0x7F800000; }  // +inf
  static __device__ __forceinline__ T load(float v) { return isnan(v) ? INT_MIN : ordered_key(v); }
  static __device__ __forceinline__ T combine(T a, T b) { return a < b ? a : b; }
};

template <>
struct Op<kMax> {
  using T = int32_t;
  static __device__ __forceinline__ T identity() { return static_cast<int32_t>(0x807FFFFFu); }  // -inf
  static __device__ __forceinline__ T load(float v) { return isnan(v) ? INT_MAX : ordered_key(v); }
  static __device__ __forceinline__ T combine(T a, T b) { return a > b ? a : b; }
};

// A row's value as the output holds it: the mean's sum over max(len, 1),
// min / max's key decoded (NaN's keys to NaN).
template <int kOp>
__device__ __forceinline__ float finalize(typename Op<kOp>::T v, int64_t len) {
  if constexpr (kOp == kSum) {
    return v;
  } else if constexpr (kOp == kMean) {
    return __fdiv_rn(v, static_cast<float>(len > 1 ? len : 1));
  } else {
    if (v == INT_MIN || v == INT_MAX) return __int_as_float(0x7FC00000);
    return __int_as_float(v ^ ((v >> 31) & 0x7FFFFFFF));
  }
}

// Row r's length as the mean divides by it (the reference's offsets[r + 1]
// - offsets[r], whatever values lie there).
__device__ __forceinline__ int64_t row_length(const int64_t* __restrict__ offsets, int64_t r) {
  return __ldg(offsets + r + 1) - __ldg(offsets + r);
}

// The length of row x0 + i that began and ended in a tile, from its first
// value's and its end's positions among the tile's nv values; an end at nv
// may have been clamped there, so that row's offsets are read again.
__device__ __forceinline__ int64_t tile_row_length(const int64_t* __restrict__ offsets, int64_t x0, int i, int start,
                                                   int end, int nv) {
  return end < nv ? end - start : row_length(offsets, x0 + i);
}

// A run's (reset, value) pair: `reset` where a row ended in it, `value` the
// combined values since its last row end (all of them where none did).
// (f1, v1) then (f2, v2) is (f1 | f2, f2 ? v2 : v1 + v2).
template <int kOp>
__device__ __forceinline__ void seg_join(int& f, typename Op<kOp>::T& v, int f2, typename Op<kOp>::T v2) {
  v = f2 ? v2 : Op<kOp>::combine(v, v2);
  f |= f2;
}

// The inclusive segmented scan of (f, v) over a block's threads (warp
// shuffles, then the warps' totals in a fixed order); (fe, ve) is the
// exclusive one, the combined runs of the threads before this one.
template <int kOp, int kThreads>
__device__ __forceinline__ void block_seg_scan(int& f, typename Op<kOp>::T& v, int& fe, typename Op<kOp>::T& ve,
                                               int* s_f, typename Op<kOp>::T* s_v) {
  using Acc = typename Op<kOp>::T;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Acc vu = __shfl_up_sync(0xFFFFFFFFu, v, d);
    const int fu = __shfl_up_sync(0xFFFFFFFFu, f, d);
    if (lane >= d) {
      v = f ? v : Op<kOp>::combine(vu, v);
      f |= fu;
    }
  }
  if (lane == 31) {
    s_f[warp] = f;
    s_v[warp] = v;
  }
  __syncthreads();
  int fp = 0;
  Acc vp = Op<kOp>::identity();
  for (int w = 0; w < warp; ++w) seg_join<kOp>(fp, vp, s_f[w], s_v[w]);
  const Acc vu = __shfl_up_sync(0xFFFFFFFFu, v, 1);
  const int fu = __shfl_up_sync(0xFFFFFFFFu, f, 1);
  fe = fp;
  ve = vp;
  if (lane > 0) seg_join<kOp>(fe, ve, fu, vu);
  int fi = fp;
  Acc vi = vp;
  seg_join<kOp>(fi, vi, f, v);
  f = fi;
  v = vi;
}

// A tile's rows [x0, x1) from the plan's counts a = coord[k] and b =
// coord[k + 1], clamped so that offsets that do not ascend cannot put a tile
// out of bounds; len is the tile's items.
__device__ __forceinline__ void tile_rows(int64_t a, int64_t b, int64_t n_end, int len, int64_t& x0, int64_t& x1) {
  x0 = a < 0 ? 0 : (a > n_end ? n_end : a);
  const int64_t hi = x0 + len < n_end ? x0 + len : n_end;
  x1 = b < x0 ? x0 : (b > hi ? hi : b);
}

// 1. coord[k] = the row ends before merge position k * kSegTile: the rows x
// of [0, n_end) whose end x + clamp(offsets[x + 1], 0, T) lies below it. A
// warp a boundary: each round its lanes probe 64 evenly spaced rows of the
// range left (two a lane, loaded together) and keep the step between the
// last row below and the first not below: 3 rounds for 147K rows.
__global__ void __launch_bounds__(kPlanThreads)
segment_plan_kernel(const int64_t* __restrict__ offsets, int64_t T, int64_t n_end, int64_t ntiles,
                    int64_t* __restrict__ coord) {
  const int64_t k = (static_cast<int64_t>(blockIdx.x) * kPlanThreads + threadIdx.x) >> 5;
  if (k > ntiles) return;  // whole warps
  const int lane = threadIdx.x & 31;
  const int64_t b = k * kSegTile;
  int64_t lo = 0, hi = n_end;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int64_t step = (hi - lo + 63) / 64;
    int m = 0;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int64_t x = lo + (2 * lane + q) * step;
      bool below = false;
      if (x < hi) {
        const int64_t a = offsets[x + 1];
        below = x + (a < 0 ? 0 : (a > T ? T : a)) < b;
      }
      m += __popc(__ballot_sync(0xFFFFFFFFu, below));
    }
    if (m == 0) {
      hi = lo;
    } else {
      const int64_t top = lo + m * step;
      lo += (m - 1) * step + 1;
      hi = top < hi ? top : hi;
    }
  }
  if (lane == 0) coord[k] = lo;
}

// A tile's place on the merge path: its rows [x0, x0 + ne) and values [y0,
// y0 + nv), and the values before the first 16-byte boundary (vh0).
struct SegTile {
  int64_t k, x0, y0;
  int ne, nv, vh0;
};

__device__ __forceinline__ int tile_len(int64_t k, int64_t n_end, int64_t T) {
  const int64_t d0 = k * kSegTile;
  return static_cast<int>(n_end + T - d0 < kSegTile ? n_end + T - d0 : kSegTile);
}

// Tile k's place, from its plan counts a = coord[k], b = coord[k + 1].
__device__ __forceinline__ SegTile seg_tile(const float* values, int64_t T, int64_t n_end, int64_t k, int64_t a,
                                            int64_t b) {
  SegTile t;
  t.k = k;
  const int64_t d0 = k * kSegTile;
  const int len = tile_len(k, n_end, T);
  int64_t x1;
  tile_rows(a, b, n_end, len, t.x0, x1);
  t.ne = static_cast<int>(x1 - t.x0);
  t.y0 = d0 - t.x0 < 0 ? 0 : (d0 - t.x0 > T ? T : d0 - t.x0);
  t.nv = static_cast<int>(len - t.ne < T - t.y0 ? len - t.ne : T - t.y0);
  t.vh0 = static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(values + t.y0) & 15)) & 15) / 4);
  return t;
}

// Tile k (a block): its values in shared memory by 16-byte cp.async (4-byte
// at the edges), placed so that their 16-byte-aligned body lands on a
// 16-byte boundary; its row ends offsets[x0 + 1 .. x0 + ne] through
// registers as int32 positions among the tile's values, clamped to [0, nv]
// (row end i comes before value j where rel[i] <= j). Each thread's
// kSegItems items are walked from its merge-path start, rows that end here
// stored, the first row's part to head[k] and the open row's to tail[k].
template <int kOp>
__global__ void __launch_bounds__(kSegThreads)
segment_tile_kernel(const float* __restrict__ values, int64_t T, const int64_t* __restrict__ offsets, int64_t n_end,
                    int64_t num_rows, const int64_t* __restrict__ coord, typename Op<kOp>::T* __restrict__ head,
                    typename Op<kOp>::T* __restrict__ tail, float* __restrict__ out) {
  using Acc = typename Op<kOp>::T;
  __shared__ __align__(16) float s_vals[kSegTile + 4];
  __shared__ int s_rel[kSegTile];
  __shared__ int s_f[kSegThreads / 32];
  __shared__ Acc s_v[kSegThreads / 32];

  const SegTile t = seg_tile(values, T, n_end, blockIdx.x, coord[blockIdx.x], coord[blockIdx.x + 1]);
  const int ne = t.ne, nv = t.nv;
  const int64_t x0 = t.x0, y0 = t.y0;
  float* v_s = s_vals + ((4 - t.vh0) & 3);
  {
    const float* vsrc = values + y0;
    const int vh = t.vh0 < nv ? t.vh0 : nv;
    const int vbody = (nv - vh) / 4;
    for (int u = threadIdx.x; u < vbody; u += kSegThreads) nvt::cp_async16(v_s + vh + 4 * u, vsrc + vh + 4 * u);
    const int vrest = nv - vh - 4 * vbody;
    if (threadIdx.x >= 32 && threadIdx.x < 32 + vh) nvt::cp_async4(v_s + threadIdx.x - 32, vsrc + threadIdx.x - 32);
    if (threadIdx.x >= 64 && threadIdx.x < 64 + vrest) {
      const int j = nv - vrest + threadIdx.x - 64;
      nvt::cp_async4(v_s + j, vsrc + j);
    }
    nvt::cp_async_commit();
    for (int i = threadIdx.x; i < ne; i += kSegThreads) {
      const int64_t e = __ldg(offsets + x0 + 1 + i) - y0;
      s_rel[i] = static_cast<int>(e < 0 ? 0 : (e > nv ? nv : e));
    }
    nvt::cp_async_wait<0>();
  }
  __syncthreads();

  const int total = ne + nv;
  const int dt = threadIdx.x * kSegItems < total ? threadIdx.x * kSegItems : total;
  int lo = dt - nv > 0 ? dt - nv : 0, hi = dt < ne ? dt : ne;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_rel[mid] <= dt - mid - 1) lo = mid + 1; else hi = mid;
  }
  int xi = lo, yj = dt - lo;
  const int x_first = xi;
  int nend = xi < ne ? s_rel[xi] : INT_MAX;  // the next row end's position
  int start = xi > 0 ? s_rel[xi - 1] : 0;  // the mean's: this row's first value's position
  Acc acc = Op<kOp>::identity(), first = Op<kOp>::identity();
  int seen = 0;
#pragma unroll
  for (int i = 0; i < kSegItems; ++i) {
    if (dt + i >= total) break;
    if (yj >= nend) {  // row x0 + xi ends
      if (!seen) {
        first = acc;
        seen = 1;
      } else if (x0 + xi < num_rows) {  // begun and ended in this thread
        out[x0 + xi] = finalize<kOp>(acc, kOp == kMean ? tile_row_length(offsets, x0, xi, start, nend, nv) : 0);
      }
      acc = Op<kOp>::identity();
      ++xi;
      start = nend;
      nend = xi < ne ? s_rel[xi] : INT_MAX;
    } else {
      acc = Op<kOp>::combine(acc, Op<kOp>::load(v_s[yj]));
      ++yj;
    }
  }

  int f = seen, fe;
  Acc v = acc, ve;
  block_seg_scan<kOp, kSegThreads>(f, v, fe, ve, s_f, s_v);
  if (seen) {  // this thread's first row: the runs before it in the tile, then its own
    const Acc row = Op<kOp>::combine(ve, first);
    if (fe) {  // begun in this tile
      if (x0 + x_first < num_rows)
        out[x0 + x_first] = finalize<kOp>(
            row, kOp == kMean ? tile_row_length(offsets, x0, x_first, s_rel[x_first - 1], s_rel[x_first], nv) : 0);
    } else {  // the tile's first row: the fix-up adds the tiles before
      head[t.k] = row;
    }
  }
  if (threadIdx.x == kSegThreads - 1) {
    tail[t.k] = v;
    if (!f) head[t.k] = Op<kOp>::identity();  // no row ends in this tile
  }
}

// 3. The fix-up (one block): positions k = 0 .. ntiles (the tiles, then
// the path's end) scanned in tile order, kFixItems a thread, with a carry
// from one chunk of positions to the next. The carry into tile k is its
// first row's part in the tiles before; tile k stores that row where a row
// ends in it, and the path's end stores row n_end. Every load of a turn is
// issued before the scan waits on any.
template <int kOp>
__global__ void __launch_bounds__(kFixThreads)
segment_fixup_kernel(const int64_t* __restrict__ offsets, int64_t T, int64_t n_end, int64_t num_rows,
                     int64_t ntiles, const int64_t* __restrict__ coord, const typename Op<kOp>::T* __restrict__ head,
                     const typename Op<kOp>::T* __restrict__ tail, float* __restrict__ out) {
  using Acc = typename Op<kOp>::T;
  __shared__ int s_f[kFixThreads / 32];
  __shared__ Acc s_v[kFixThreads / 32];
  __shared__ int s_cf;
  __shared__ Acc s_cv;
  int cf = 0;  // the carry into this chunk
  Acc cv = Op<kOp>::identity();
  for (int64_t c0 = 0; c0 <= ntiles; c0 += kFixThreads * kFixItems) {
    const int64_t p0 = c0 + static_cast<int64_t>(threadIdx.x) * kFixItems;
    int pf[kFixItems];  // a row ends in tile p
    int64_t px[kFixItems];  // tile p's first row
    Acc pv[kFixItems], ph[kFixItems];
    int64_t plen[kFixItems];  // its length (the mean's divisor)
#pragma unroll
    for (int i = 0; i < kFixItems; ++i) {
      const int64_t p = p0 + i;
      pf[i] = 0;
      px[i] = n_end;
      pv[i] = ph[i] = Op<kOp>::identity();
      plen[i] = 0;
      if (p < ntiles) {
        int64_t x1;
        tile_rows(coord[p], coord[p + 1], n_end, tile_len(p, n_end, T), px[i], x1);
        pf[i] = x1 > px[i];
        pv[i] = tail[p];
        ph[i] = head[p];
        if (kOp == kMean && px[i] < n_end) plen[i] = row_length(offsets, px[i]);
      }
    }
    int f = 0, fe;
    Acc v = Op<kOp>::identity(), ve;
#pragma unroll
    for (int i = 0; i < kFixItems; ++i) seg_join<kOp>(f, v, pf[i], pv[i]);
    block_seg_scan<kOp, kFixThreads>(f, v, fe, ve, s_f, s_v);
    int rf = cf;  // the carry into position p0
    Acc rv = cv;
    seg_join<kOp>(rf, rv, fe, ve);
#pragma unroll
    for (int i = 0; i < kFixItems; ++i) {
      const int64_t p = p0 + i;
      if (p < ntiles && pf[i]) {
        if (px[i] < num_rows)
          out[px[i]] = finalize<kOp>(Op<kOp>::combine(rv, ph[i]), plen[i]);
      } else if (p == ntiles && n_end < num_rows) {  // row R: the values past the last row end
        out[n_end] = finalize<kOp>(rv, 0);
      }
      seg_join<kOp>(rf, rv, pf[i], pv[i]);
    }
    if (threadIdx.x == kFixThreads - 1) {  // the carry into the next chunk
      seg_join<kOp>(cf, cv, f, v);
      s_cf = cf;
      s_cv = cv;
    }
    __syncthreads();
    cf = s_cf;
    cv = s_cv;
    __syncthreads();  // s_f, s_v and the carry are read before the next chunk writes them
  }
  for (int64_t r = n_end + 1 + threadIdx.x; r < num_rows; r += kFixThreads)  // rows past R + 1: empty
    out[r] = finalize<kOp>(Op<kOp>::identity(), 0);
}

template <int kOp>
int launch_segment_reduce(const float* values, int64_t T, const int64_t* offsets, int64_t n_end, int64_t num_rows,
                          int64_t ntiles, int64_t* scratch, float* out, cudaStream_t stream) {
  using Acc = typename Op<kOp>::T;
  int64_t* coord = scratch;
  Acc* head = reinterpret_cast<Acc*>(scratch + ntiles + 1);
  Acc* tail = head + ntiles;
  const int64_t plan_blocks = ((ntiles + 1) * 32 + kPlanThreads - 1) / kPlanThreads;
  segment_plan_kernel<<<static_cast<unsigned>(plan_blocks), kPlanThreads, 0, stream>>>(offsets, T, n_end, ntiles,
                                                                                      coord);
  if (ntiles > 0)
    segment_tile_kernel<kOp><<<static_cast<unsigned>(ntiles), kSegThreads, 0, stream>>>(values, T, offsets, n_end,
                                                                                      num_rows, coord, head, tail, out);
  segment_fixup_kernel<kOp><<<1, kFixThreads, 0, stream>>>(offsets, T, n_end, num_rows, ntiles, coord, head, tail,
                                                           out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// combiner: 0 sum, 1 mean, 2 min, 3 max; out holds num_rows floats. A mean
// needs num_rows == R (the wrapper checks). `tiles` is the merge path's
// tiles, ceil((min(num_rows, R) + T) / kSegTile), and `scratch` holds 2 *
// tiles + 1 int64s (the plan, then each tile's head and tail), as the
// wrapper's segment_plan gives them. Returns a cudaError_t.
extern "C" int nvt_ragged_segment_reduce(const float* values, int64_t T, const int64_t* offsets, int64_t R,
                                         int64_t num_rows, int combiner, int64_t tiles, int64_t* scratch, float* out,
                                         void* stream) {
  if (T < 0 || R < 0 || num_rows < 0 || combiner < kSum || combiner > kMax || (combiner == kMean && num_rows != R))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_end = num_rows < R ? num_rows : R;
  if (tiles != (n_end + T + kSegTile - 1) / kSegTile || tiles > 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (combiner) {
    case kSum: return launch_segment_reduce<kSum>(values, T, offsets, n_end, num_rows, tiles, scratch, out, s);
    case kMean: return launch_segment_reduce<kMean>(values, T, offsets, n_end, num_rows, tiles, scratch, out, s);
    case kMin: return launch_segment_reduce<kMin>(values, T, offsets, n_end, num_rows, tiles, scratch, out, s);
    default: return launch_segment_reduce<kMax>(values, T, offsets, n_end, num_rows, tiles, scratch, out, s);
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
