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
// zero weight, as the reference's jnp.take of the clipped index does (the
// zero rule). It writes the sum; the mean divides after the sum over the
// model axis, by the mask counts (embeddings.py:84-87). Products and sums
// are rounded one by one (__fmul_rn, __fadd_rn), as the plain version's
// separate PyTorch operations round them.
//
// In take mode it is the forward of K15d's bag, the multihot lookup of the
// sharded DLRM step (dlrm.py:125-132 on P("model", None) tables): ids
// follow jnp.take on the whole padded table of Vp rows, as K15d's gather
// does. A negative id wraps once by Vp; an id still outside [0, Vp) is held
// by no rank and makes its bag NaN (NaN times any mask, 0 included) on
// model rank 0 only, so the model group's sum is NaN exactly where the
// unsharded bag is; the ids another rank holds add nothing. On one rank it
// is K13c's forward sum bit for bit. `out` may be a strided view (a slot of
// the [b, C + M, D] buffer that the group's all_reduce sums).
//
// nvt_range_bag_grad: the transpose of either rule's bag for this rank's
// rows, dtable[v - start] += (g[b] / cnt[b]) * m[b, l] for each id it holds
// (cnt = max(sum_l m, 1) in l order for the mean, 1 for the sum; negatives
// wrapped by Vp in take mode, not in the zero rule), into a gradient zeroed
// here; ids outside the table add nothing. No collective: every rank of the
// model group holds the same pooled bags, so the sum's transpose is the
// identity. A genres shard holds a few rows that every id of the batch
// falls on (6 rows x 64 dims for 262,144 ids at shard 1 of 4), so where a
// block's private copies of the shard's gradient fit its shared memory
// (the wrapper's plan) every group of lanes that takes a bag sums its terms
// into a copy of its own, with no atomics, the count and g / cnt once a
// bag; then each block of a grid the card holds at once adds its copies'
// sum with one atomic a cell to the gradient, zeroed by a memset (on an
// H100 at 700 W, a second pass that summed the blocks' partials in block
// order took 0.0175 ms against this 0.0165 at phase 23's shape). A larger
// shard takes one global atomic per float4 of a held id. The atomics make
// the summation order, and so the last bits, vary from run to run. On the
// whole table (start 0, rows_local = padded = V, wrap) it is also K13c's
// backward, the transpose of csrc/embedding_bag.cu's bag. Bound: bytes —
// the values, mask and gradient rows once each, and the gradient written.
//
// nvt_range_gather: one thread copies VEC floats of an output row (a float4
// when D % 4 == 0 and the pointers are 16-byte aligned); consecutive threads
// write consecutive addresses. Bound: bytes — the ids, the distinct local
// rows touched and the output, once each. nvt_range_bag: see
// range_bag_kernel below.
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
// [B, C, D] view whose rows may be strided (the first C slots of the
// [B, C + M, D] buffer that the group's all_reduce takes in place). Bound:
// bytes — the output (three quarters of it another rank's zeros at a
// quarter shard), the ids and the distinct held rows, once each. A
// persistent grid's blocks walk tiles of rows: a tile's shard rows staged in
// shared memory (each column's ranges read at one parameter index a warp,
// each id once), then its output rows written whole by consecutive threads
// with no 64-bit division a vector, the zero and NaN rows stored without a
// table read (a thread a float4 with two 64-bit divisions and five
// divergent parameter reads each took 0.0766 ms at phase 21's shape against
// a bound of 0.0373 on an H100 80GB HBM3 at 700 W, kernel_ab.py).
//
// nvt_range_scatter_grad: the dense [rows_local, D] gradient of the shard,
// a zero fill (cudaMemsetAsync, one pass at the memory's rate: the floor)
// then the held ids' rows added; another rank's ids and ids no rank holds
// add nothing. The gradient may be a strided view (grad_row_stride floats
// between rows: slots 1..C of the [B, 1 + C, D] features' gradient). Bound:
// bytes — the zero fill of the shard's gradient, the ids and the gradient
// rows this rank holds, once each. At a quarter shard of Criteo's tables
// only a quarter of the ids are held, and the small tables send most of a
// column's ids to a few rows, whose atomics would serialize at their L2
// slice. So a warp takes 32 consecutive ids of one column (one coalesced
// load, each id read once), ballots the held ones, groups equal shard rows
// and sums each group's gradient rows in registers (row_groups.cuh: one
// shuffle tree, the same for every float4 of the row); the group's leader
// alone issues the reductions, one red.global.add.v4.f32 per float4 (a
// float where D % 4 != 0 or a row is not 16-byte aligned). A warp walks a
// contiguous run of such tiles and carries one hot row's sum across them in
// shared memory, so a row that takes most of a column's ids gets one
// reduction a float4 per warp, not per tile. A launch takes at most kCarryMaxDim (1536) floats of each row
// (its carries fill 48 KB a block): a wider D launches once for each chunk
// of kCarryMaxDim columns, the gradient and its shard moved to the chunk's
// first column. Atomics and the tree make the
// summation order, and so the last bits, vary from run to run.

#include <cuda_runtime.h>
#include <cstdint>

#include "chunks.cuh"
#include "row_groups.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBagThreads = 512;        // range_bag_grad's shared path
constexpr int kSmemOptIn = 227 * 1024;  // the shared memory an H100 block can opt into
constexpr int64_t kElsewhere = -1;  // a row another rank holds
constexpr int64_t kNoRank = -2;     // an id outside [-Vp, Vp): no rank holds it

unsigned blocks_for(int64_t threads) { return static_cast<unsigned>((threads + kThreads - 1) / kThreads); }

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

// The shard row of a bag's id under jnp.take's rule on a table of Vp rows
// (wrap: negatives wrap once by Vp), or kElsewhere / kNoRank.
__device__ __forceinline__ int64_t bag_shard_row(int32_t v, int64_t start, int64_t rows_local, int64_t padded,
                                                 int wrap) {
  int64_t id = v;
  if (wrap && id < 0) id += padded;
  if (id < 0 || id >= padded) return kNoRank;
  const int64_t local = id - start;
  return (local >= 0 && local < rows_local) ? local : kElsewhere;
}

// nvt_range_bag, both rules. Bound: bytes: the ids and mask, the distinct
// shard rows the bags touch and the output, once each. A thread a float4 of
// an output row (16 of a bag at D = 64) repeated its bag's id work (a 64-bit
// division, L id and mask loads, jnp.take's 64-bit tests) and summed a
// chain of L dependent row loads: 0.0126 ms at phase 23's [65536, 4]
// against a bound of 0.0056 on an H100 80GB HBM3 at 700 W. Design, where
// the wrapper's plan (bag_fwd_plan) gives tiles: a shard of at most
// kBagStageFloats floats (genres' 6 x 64 at phase 23) and bags of at most
// kBagTileIds ids:
// * The block copies the shard into shared memory once; every term reads it
//   there.
// * A persistent grid's blocks walk tiles of `tile_bags` bags. A tile's ids
//   and masks are read once, coalesced (16 bytes a thread where L % 4 == 0
//   and both are aligned, else kBagStageIds loads in flight a thread), and
//   each id's term is decided once: the offset of its shard row
//   (row * D) or, in take mode, kElsewhere / kNoRank, and its weight, into
//   shared memory.
// * The sums: thread k takes vector k % per_row of bags k / per_row + j *
//   (kThreads / per_row) of the tile, so consecutive threads write each
//   output row's vectors whole (rows out_row_stride floats apart, streaming
//   stores); kBagLoads row loads are issued before they are summed in l
//   order.
// Otherwise (K15b's 5.59M rows of 16 floats at phase 19) a thread takes a
// vector of an output row and decides its bag's ids itself
// (range_bag_vectors_kernel): the tiles, the shard read from global memory,
// were slower there.
constexpr int kBagTileIds = 2048;      // ids a tile decides at once (int64 offset and weight each: 24 KB)
constexpr int kBagStageFloats = 4096;  // the largest shard staged in shared memory (16 KB)
constexpr int kBagLoads = 4;           // row loads in flight a sum
constexpr int kBagStageIds = 8;        // ids and masks a thread loads at once while a tile is decided
constexpr int kBagMinBlocks = 4;       // resident blocks an SM the registers must allow

// A bag id's term: the offset of its shard row (row * D), or kElsewhere /
// kNoRank in take mode (jnp.take's rule on the padded table), and its
// weight; in the zero rule the clipped row, weighted mask * in_range.
__device__ __forceinline__ void bag_term(int32_t v, float m, int take, int64_t start, int64_t rows_local,
                                         int64_t padded, int D, int64_t& off, float& w) {
  if (take) {
    const int64_t row = bag_shard_row(v, start, rows_local, padded, 1);
    off = row < 0 ? row : row * D;
    w = m;
  } else {
    int64_t local = static_cast<int64_t>(v) - start;
    const bool in_range = local >= 0 && local < rows_local;
    w = __fmul_rn(m, in_range ? 1.0f : 0.0f);
    local = local < 0 ? 0 : (local >= rows_local ? rows_local - 1 : local);
    off = local * D;
  }
}

// kVecIds: L % 4 == 0 and values and mask 16-byte aligned. Dynamic shared
// memory: the shard (rows_local * D floats, rounded up to 16 bytes), then
// the tile's tile_bags * L offsets and weights.
template <int VEC, bool kVecIds>
__global__ void __launch_bounds__(kThreads, kBagMinBlocks)
range_bag_kernel(const float* __restrict__ table, int64_t rows_local, int64_t start, int D,
                 const int32_t* __restrict__ values, const float* __restrict__ mask, int64_t B, int L, int take,
                 int64_t padded, int write_nan, float* __restrict__ out, int64_t out_row_stride, int tile_bags) {
  extern __shared__ float4 bag_smem4[];
  const int cells = static_cast<int>(rows_local) * D;
  float* shard = reinterpret_cast<float*>(bag_smem4);
  int64_t* offs = reinterpret_cast<int64_t*>(shard + ((cells + 3) & ~3));
  float* ws = reinterpret_cast<float*>(offs + tile_bags * L);
  // visible after the first tile's barrier
  if constexpr (VEC == 4) {
    for (int k = threadIdx.x; k < cells / 4; k += kThreads) bag_smem4[k] = __ldg(reinterpret_cast<const float4*>(table) + k);
  } else {
    for (int k = threadIdx.x; k < cells; k += kThreads) shard[k] = __ldg(table + k);
  }
  // this thread's sums of a tile: vectors q0 + j qstep of bags r0 + i rstep
  const int per_row = D / VEC;
  int r0 = 0, rstep = 1, q0 = threadIdx.x, qstep = kThreads;
  if (per_row <= kThreads) {
    rstep = kThreads / per_row;
    r0 = threadIdx.x / per_row;
    q0 = threadIdx.x - r0 * per_row;
    qstep = per_row;
    if (r0 >= rstep) r0 = tile_bags;  // past the last whole row of vectors: no sum
  }
  const int64_t tiles = (B + tile_bags - 1) / tile_bags;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t b0 = t * tile_bags;
    const int n = B - b0 < tile_bags ? static_cast<int>(B - b0) : tile_bags;
    const int64_t base = b0 * L;  // the tile's ids: [b0 L, (b0 + n) L)
    const int m = n * L;
    __syncthreads();  // the sums before are done with offs and ws
    if constexpr (kVecIds) {
      for (int e4 = threadIdx.x; e4 < m / 4; e4 += kThreads) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(values + base) + e4);
        const float4 w = __ldg(reinterpret_cast<const float4*>(mask + base) + e4);
        const int e = 4 * e4;
        bag_term(v.x, w.x, take, start, rows_local, padded, D, offs[e], ws[e]);
        bag_term(v.y, w.y, take, start, rows_local, padded, D, offs[e + 1], ws[e + 1]);
        bag_term(v.z, w.z, take, start, rows_local, padded, D, offs[e + 2], ws[e + 2]);
        bag_term(v.w, w.w, take, start, rows_local, padded, D, offs[e + 3], ws[e + 3]);
      }
    } else {
      for (int e0 = threadIdx.x; e0 < m; e0 += kThreads * kBagStageIds) {
        int32_t v[kBagStageIds];
        float w[kBagStageIds];
#pragma unroll
        for (int j = 0; j < kBagStageIds; ++j) {
          const int e = e0 + j * kThreads;
          v[j] = e < m ? __ldg(values + base + e) : 0;
          w[j] = e < m ? __ldg(mask + base + e) : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < kBagStageIds; ++j) {
          const int e = e0 + j * kThreads;
          if (e < m) bag_term(v[j], w[j], take, start, rows_local, padded, D, offs[e], ws[e]);
        }
      }
    }
    __syncthreads();
    for (int r = r0; r < n; r += rstep) {
      const int64_t* bo = offs + r * L;
      const float* bw = ws + r * L;
      float* o = out + (b0 + r) * out_row_stride;
      for (int q = q0; q < per_row; q += qstep) {
        float acc[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
        bool no_rank = false;
        for (int l = 0; l < L; l += kBagLoads) {
          float v[kBagLoads][VEC];
          unsigned loaded = 0;  // the terms of this round that add to the sum
#pragma unroll
          for (int j = 0; j < kBagLoads; ++j) {
            const int64_t off = l + j < L ? bo[l + j] : kElsewhere;
            no_rank |= off == kNoRank;
            if (off >= 0) {
              load_vec<VEC>(shard + off + q * VEC, v[j]);
              loaded |= 1u << j;
            }
          }
#pragma unroll
          for (int j = 0; j < kBagLoads; ++j) {
            if (!(loaded >> j & 1u)) continue;  // another rank's row, no rank's, or past the bag
            const float w = bw[l + j];
#pragma unroll
            for (int k = 0; k < VEC; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(v[j][k], w));
          }
        }
        if (no_rank && write_nan) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] = __int_as_float(0x7fc00000);
        }
        if constexpr (VEC == 4) {
          __stcs(reinterpret_cast<float4*>(o + q * 4), make_float4(acc[0], acc[1], acc[2], acc[3]));
        } else {
          __stcs(o + q, acc[0]);
        }
      }
    }
  }
}

// A thread a vector of an output row, which decides each of its bag's ids
// itself: where the plan gives no tiles.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
range_bag_vectors_kernel(const float* __restrict__ table, int64_t rows_local, int64_t start, int D,
                         const int32_t* __restrict__ values, const float* __restrict__ mask, int64_t B, int L,
                         int take, int64_t padded, int write_nan, float* __restrict__ out, int64_t out_row_stride) {
  const int per_row = D / VEC;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= B * per_row) return;
  const int64_t b = t / per_row;
  const int q = static_cast<int>(t - b * per_row);
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
  bool no_rank = false;
  for (int l = 0; l < L; ++l) {
    float v[VEC];
    float w;
    if (take) {
      const int64_t row = bag_shard_row(values[b * L + l], start, rows_local, padded, 1);
      no_rank |= row == kNoRank;
      if (row < 0) continue;  // another rank's row, or no rank's
      w = mask[b * L + l];
      load_vec<VEC>(table + row * D + q * VEC, v);
    } else {
      int64_t local = static_cast<int64_t>(values[b * L + l]) - start;
      const bool in_range = local >= 0 && local < rows_local;
      w = __fmul_rn(mask[b * L + l], in_range ? 1.0f : 0.0f);
      local = local < 0 ? 0 : (local >= rows_local ? rows_local - 1 : local);
      load_vec<VEC>(table + local * D + q * VEC, v);
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(v[k], w));
  }
  if (no_rank && write_nan) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = __int_as_float(0x7fc00000);
  }
  store_vec<VEC>(out + b * out_row_stride + q * VEC, acc);
}

// A launch of range_bag_kernel<VEC, kVecIds> on a persistent grid: as many
// blocks as the card holds at once, at most one a tile.
template <int VEC, bool kVecIds>
int launch_range_bag_tiles(const float* table, int64_t rows_local, int64_t start, int D, const int32_t* values,
                           const float* mask, int64_t B, int L, int take, int64_t padded, int write_nan, float* out,
                           int64_t out_row_stride, int tile_bags, cudaStream_t stream) {
  static nvt::ResidentCache cache;
  const int smem = 4 * ((static_cast<int>(rows_local) * D + 3) & ~3) +
                   tile_bags * L * static_cast<int>(sizeof(int64_t) + sizeof(float));
  unsigned blocks = 0;
  if (int rc = nvt::cached_resident_blocks(cache, range_bag_kernel<VEC, kVecIds>, kThreads, smem,
                                           (B + tile_bags - 1) / tile_bags, &blocks))
    return rc;
  range_bag_kernel<VEC, kVecIds><<<blocks, kThreads, smem, stream>>>(table, rows_local, start, D, values, mask, B, L,
                                                                    take, padded, write_nan, out, out_row_stride,
                                                                    tile_bags);
  return static_cast<int>(cudaGetLastError());
}

// max(sum_l m[l], 1), summed in l order as the forward's counts are.
__device__ __forceinline__ float bag_count(const float* __restrict__ m, int L) {
  float cnt = 0.0f;
  for (int l = 0; l < L; ++l) cnt = __fadd_rn(cnt, m[l]);
  return fmaxf(cnt, 1.0f);
}

// A bag's ids and mask: one 16-byte load each where L == 4 (kVecIds), else
// one load an id; its shard rows (< 0: not this rank's) and the divisor of
// its gradient (the mask count for the mean, else 1).
template <bool kVecIds>
struct BagIds {
  int row[kVecIds ? 4 : 1];
  float m[kVecIds ? 4 : 1];
  float cnt;

  __device__ __forceinline__ void load(const int32_t* __restrict__ values, const float* __restrict__ mask, int64_t b,
                                       int L, int64_t start, int64_t rows_local, int64_t padded, int wrap, int mean) {
    if constexpr (kVecIds) {
      const int4 v = reinterpret_cast<const int4*>(values)[b];
      const float4 w = reinterpret_cast<const float4*>(mask)[b];
      const int32_t vs[4] = {v.x, v.y, v.z, v.w};
      m[0] = w.x; m[1] = w.y; m[2] = w.z; m[3] = w.w;
#pragma unroll
      for (int l = 0; l < 4; ++l) row[l] = static_cast<int>(bag_shard_row(vs[l], start, rows_local, padded, wrap));
      cnt = mean ? fmaxf(__fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(0.0f, m[0]), m[1]), m[2]), m[3]), 1.0f) : 1.0f;
    } else {
      cnt = mean ? bag_count(mask + b * L, L) : 1.0f;
    }
  }
};

// Shared path: a bag is taken by a group of S lanes (S the least power of
// two >= D / VEC, at most 32), each lane VEC floats of every S-th chunk of
// the row, and each group sums its terms into a private [rows_local, D]
// copy in shared memory with plain loads and stores: the lanes of a group
// write distinct chunks and no two groups share a copy, so no atomics. The
// count and g / cnt are taken once a bag and chunk; the gradient row is
// read whether or not the bag holds an id, so that its load does not wait
// on the ids'. Then the block sums its copies in copy order and adds each
// cell's sum to the zeroed gradient with one atomic.
template <int VEC, bool kVecIds>
__global__ void __launch_bounds__(kBagThreads)
range_bag_grad_copies_kernel(const float* __restrict__ grad, int64_t grad_row_stride,
                             const int32_t* __restrict__ values, const float* __restrict__ mask, int64_t B, int L,
                             int D, int64_t start, int64_t rows_local, int64_t padded, int wrap, int mean, int S,
                             float* __restrict__ dtable) {
  extern __shared__ float4 copies4[];
  float* copies = reinterpret_cast<float*>(copies4);
  const int cells = static_cast<int>(rows_local) * D;
  const int groups = kBagThreads / S;  // copies of the block
  for (int i = threadIdx.x; i < groups * cells; i += kBagThreads) copies[i] = 0.0f;
  __syncthreads();
  const int group = threadIdx.x / S;
  const int lane = threadIdx.x - group * S;
  float* copy = copies + group * cells;
  const int per_row = D / VEC;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * groups;
  for (int64_t b = static_cast<int64_t>(blockIdx.x) * groups + group; b < B; b += stride) {
    BagIds<kVecIds> bag;
    bag.load(values, mask, b, L, start, rows_local, padded, wrap, mean);
    for (int q = lane; q < per_row; q += S) {
      float g[VEC];
      load_vec<VEC>(grad + b * grad_row_stride + q * VEC, g);
#pragma unroll
      for (int k = 0; k < VEC; ++k) g[k] = mean ? __fdiv_rn(g[k], bag.cnt) : g[k];
      auto add = [&](int row, float m) {
        if (row < 0) return;
        float* dst = copy + row * D + q * VEC;
        float t[VEC];
        load_vec<VEC>(dst, t);
#pragma unroll
        for (int k = 0; k < VEC; ++k) t[k] += __fmul_rn(g[k], m);
        store_vec<VEC>(dst, t);
      };
      if constexpr (kVecIds) {
#pragma unroll
        for (int l = 0; l < 4; ++l) add(bag.row[l], bag.m[l]);
      } else {
        for (int l = 0; l < L; ++l)
          add(static_cast<int>(bag_shard_row(values[b * L + l], start, rows_local, padded, wrap)), mask[b * L + l]);
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cells; c += kBagThreads) {
    float sum = 0.0f;
    for (int k = 0; k < groups; ++k) sum += copies[k * cells + c];
    atomicAdd(dtable + c, sum);
  }
}

// One launch of range_bag_grad_copies_kernel<VEC, kVecIds>, above 48 KB of
// shared memory by the opt-in attribute.
struct CopiesLaunch {
  const float* grad;
  int64_t grad_row_stride;
  const int32_t* values;
  const float* mask;
  int64_t B;
  int L, D;
  int64_t start, rows_local, padded;
  int wrap, mean, S;
  float* dtable;
  int blocks, smem;
  cudaStream_t stream;

  template <int VEC, bool kVecIds>
  cudaError_t run() const {
    const cudaError_t err = cudaFuncSetAttribute(range_bag_grad_copies_kernel<VEC, kVecIds>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    range_bag_grad_copies_kernel<VEC, kVecIds><<<blocks, kBagThreads, smem, stream>>>(
        grad, grad_row_stride, values, mask, B, L, D, start, rows_local, padded, wrap, mean, S, dtable);
    return cudaGetLastError();
  }
};

// Global path (a shard too large for a block's copies): a thread a (bag,
// VEC floats of its row) takes the count and g / cnt once, then one atomic
// (a float4 reduction where VEC == 4) a held id into the zeroed gradient.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
range_bag_grad_global_kernel(const float* __restrict__ grad, int64_t grad_row_stride,
                             const int32_t* __restrict__ values, const float* __restrict__ mask, int64_t B, int L,
                             int D, int64_t start, int64_t rows_local, int64_t padded, int wrap, int mean,
                             float* __restrict__ dtable) {
  const int per_row = D / VEC;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= B * per_row) return;
  const int64_t b = t / per_row;
  const int q = static_cast<int>(t - b * per_row);
  const float cnt = mean ? bag_count(mask + b * L, L) : 1.0f;
  float g[VEC];
  load_vec<VEC>(grad + b * grad_row_stride + q * VEC, g);
#pragma unroll
  for (int k = 0; k < VEC; ++k) g[k] = mean ? __fdiv_rn(g[k], cnt) : g[k];
  for (int l = 0; l < L; ++l) {
    const int64_t row = bag_shard_row(values[b * L + l], start, rows_local, padded, wrap);
    if (row < 0) continue;
    const float m = mask[b * L + l];
    float* dst = dtable + row * D + q * VEC;
    if constexpr (VEC == 4) {
      atomicAdd(reinterpret_cast<float4*>(dst),
                make_float4(__fmul_rn(g[0], m), __fmul_rn(g[1], m), __fmul_rn(g[2], m), __fmul_rn(g[3], m)));
    } else {
      atomicAdd(dst, __fmul_rn(g[0], m));
    }
  }
}

constexpr int kMaxCols = 64;

struct RangeColumns {
  const int32_t* ids[kMaxCols];  // [B] each
  int64_t offset[kMaxCols];      // the column's first row in the shard
  int64_t size[kMaxCols];        // the column's rows in the shard
  int64_t start[kMaxCols];       // the global row of its first shard row
  int64_t padded[kMaxCols];      // the table's padded global size Vp
};

// The shard row of column col's id, or kElsewhere / kNoRank.
__device__ __forceinline__ int64_t shard_row_of(const RangeColumns& c, int col, int64_t id) {
  const int64_t vp = c.padded[col];
  if (id < 0) id += vp;
  if (id < 0 || id >= vp) return kNoRank;
  const int64_t local = id - c.start[col];
  return (local >= 0 && local < c.size[col]) ? c.offset[col] + local : kElsewhere;
}

using nvt::kAllLanes;
constexpr int kWarps = kThreads / 32;
constexpr int kGatherUnroll = 4;  // vectors a thread has in flight in range_gather_columns
constexpr int kGatherRows = 32;   // rows of a range_gather_columns tile: a warp's lanes

// A persistent grid's blocks walk tiles of kGatherRows rows (tile t: rows
// [t kGatherRows, +kGatherRows) of every column of the launch), strided by
// the grid. A tile first stages its shard rows in shared memory, [row][col]:
// thread e takes column e / kGatherRows (the same in a warp's 32 lanes, so
// the column's ranges are read at one index of the launch's parameters) and
// row e % kGatherRows, each id read once, coalesced. Then the block copies
// the tile's output rows in order, vector k by thread k % kThreads
// (consecutive threads, consecutive addresses: each output row's [C, D]
// block is written whole), kGatherUnroll vectors in flight a thread, with no
// 64-bit division; a row no rank holds, or another rank's, is a fill stored
// without a table read. Every store is a streaming one (on an H100 80GB HBM3
// at 700 W, kernel_ab.py at phase 21's shape: 0.0585-0.0589 ms against
// 0.0606-0.0608 with plain stores; 64-row tiles 0.0614, 16-row 0.0601; 8
// vectors in flight 0.0728; the fills stored before the held rows
// 0.0619-0.0621; the next tile's ids loaded during the copy 0.0583-0.0584).
template <int VEC>
__global__ void __launch_bounds__(kThreads)
range_gather_columns_kernel(const __grid_constant__ RangeColumns c, int num_cols, const float* __restrict__ table,
                            int D, int64_t B, int write_nan, float* __restrict__ out, int64_t out_row_stride) {
  __shared__ int64_t rows[kGatherRows * kMaxCols];  // the tile's shard rows, [row][col]
  const int per_row = D / VEC;
  const int per_tile_row = num_cols * per_row;  // vectors of a row of the tile
  const float nan = __int_as_float(0x7fc00000);
  const int64_t tiles = (B + kGatherRows - 1) / kGatherRows;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t b0 = t * kGatherRows;
    const int n = B - b0 < kGatherRows ? static_cast<int>(B - b0) : kGatherRows;
    __syncthreads();  // the tile before is copied
    for (int e = threadIdx.x; e < num_cols * kGatherRows; e += kThreads) {
      const int col = e / kGatherRows, r = e - col * kGatherRows;
      rows[r * num_cols + col] = r < n ? shard_row_of(c, col, c.ids[col][b0 + r]) : kElsewhere;
    }
    __syncthreads();
    const int vectors = n * per_tile_row;
    for (int k0 = threadIdx.x; k0 < vectors; k0 += kThreads * kGatherUnroll) {
      float v[kGatherUnroll][VEC];
      int64_t src[kGatherUnroll];
#pragma unroll
      for (int u = 0; u < kGatherUnroll; ++u) {
        const int k = k0 + u * kThreads;
        const int rc = k / per_row;  // the tile's [row][col] entry
        src[u] = k < vectors ? rows[rc] : kElsewhere;
        if (src[u] >= 0) load_vec<VEC>(table + src[u] * D + (k - rc * per_row) * VEC, v[u]);
      }
#pragma unroll
      for (int u = 0; u < kGatherUnroll; ++u) {
        const int k = k0 + u * kThreads;
        if (k >= vectors) break;
        const int r = k / per_tile_row;
        float* o = out + (b0 + r) * out_row_stride + (k - r * per_tile_row) * VEC;
        if (src[u] < 0) {
          const float fill = (src[u] == kNoRank && write_nan) ? nan : 0.0f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) v[u][e] = fill;
        }
        if constexpr (VEC == 4) {
          __stcs(reinterpret_cast<float4*>(o), make_float4(v[u][0], v[u][1], v[u][2], v[u][3]));
        } else {
          __stcs(o, v[u][0]);
        }
      }
    }
  }
}

constexpr int kRowChunk = 4;   // vectors of a gradient row a lane holds at once
constexpr int kCarryMaxDim = 48 * 1024 / (kWarps * static_cast<int>(sizeof(float)));  // 48 KB of carries a block

// Columns [0, width) of the rows (row length D: the chunk's), moved by the
// caller to the chunk's first column. Warp w takes tiles [w * T / W, (w + 1) * T / W) of the T = C * ceil(B / 32)
// 32-id tiles (column-major: a tile is 32 consecutive ids of one column),
// so its tiles are consecutive ids of one column or two. Each warp carries
// the sum of one shard row across its tiles in shared memory
// (nvt::carry_keeper); the other groups' leaders add their sums at once.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
range_scatter_grad_kernel(const __grid_constant__ RangeColumns c, int num_cols, const float* __restrict__ grad,
                          int64_t grad_row_stride, int D, int width, int64_t B, float* __restrict__ dtable) {
  extern __shared__ float carries[];  // [kWarps, width]
  const int per_row = width / VEC;
  const int lane = threadIdx.x & 31;
  float* carry = carries + (threadIdx.x >> 5) * width;
  for (int d = lane; d < width; d += 32) carry[d] = 0.0f;
  __syncwarp();
  const int64_t tiles = (B + 31) >> 5;
  const int64_t total = tiles * num_cols;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  int64_t carry_row = -1;  // warp-uniform; -1: nothing carried

  auto flush = [&]() {  // add the carried sum to the gradient and restart it
    __syncwarp();
    for (int q = lane; q < per_row; q += 32) {
      float* d = dtable + carry_row * D + q * VEC;
      if constexpr (VEC == 4) {
        // one vector reduction (red.global.add.v4.f32, compute capability 9.x)
        atomicAdd(reinterpret_cast<float4*>(d), *reinterpret_cast<const float4*>(carry + q * 4));
        *reinterpret_cast<float4*>(carry + q * 4) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      } else {
        atomicAdd(d, carry[q]);
        carry[q] = 0.0f;
      }
    }
    __syncwarp();
  };

  const int64_t w_end = total * (warp + 1) / warps;
  auto id_of = [&](int64_t w) -> int32_t {  // lane's id of tile w (0 past the batch)
    const int col = static_cast<int>(w / tiles);
    const int64_t b = ((w - col * tiles) << 5) + lane;
    return b < B ? c.ids[col][b] : 0;
  };
  int64_t w = total * warp / warps;
  int32_t next_id = w < w_end ? id_of(w) : 0;  // the ids are read one tile ahead
  for (; w < w_end; ++w) {
    const int col = static_cast<int>(w / tiles);
    const int64_t b = ((w - col * tiles) << 5) + lane;
    const int32_t id = next_id;
    if (w + 1 < w_end) next_id = id_of(w + 1);
    const int64_t row = b < B ? shard_row_of(c, col, id) : kElsewhere;
    const bool held = row >= 0;
    if (__ballot_sync(kAllLanes, held) == 0) continue;
    const float* src = grad + (held ? b * grad_row_stride + static_cast<int64_t>(col) * D : 0);
    float v[kRowChunk][VEC];
    auto load_chunk = [&](int q0) {  // vectors q0 .. q0 + kRowChunk - 1 of the lane's gradient row
#pragma unroll
      for (int k = 0; k < kRowChunk; ++k) {
        if (held && q0 + k < per_row) {
          load_vec<VEC>(src + (q0 + k) * VEC, v[k]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) v[k][e] = 0.0f;
        }
      }
    };
    load_chunk(0);  // in flight while the warp groups its rows
    const nvt::RowGroups groups(held, row, lane);
    const nvt::Carry joins = nvt::carry_keeper(groups, row, lane, carry_row);
    if (joins.restart) flush();
    carry_row = joins.row;
    const int keeper = joins.lane;
    const bool leader = groups.leader;
    float* dst = dtable + (held ? row * D : 0);
    for (int q0 = 0; q0 < per_row; q0 += kRowChunk) {
      if (q0 > 0) load_chunk(q0);
      groups.sum(v, lane);
      if (leader) {
#pragma unroll
        for (int k = 0; k < kRowChunk; ++k) {
          if (q0 + k >= per_row) break;
          if (lane == keeper) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) carry[(q0 + k) * VEC + e] += v[k][e];
          } else if constexpr (VEC == 4) {
            atomicAdd(reinterpret_cast<float4*>(dst + (q0 + k) * 4), make_float4(v[k][0], v[k][1], v[k][2], v[k][3]));
          } else {
            atomicAdd(dst + q0 + k, v[k][0]);
          }
        }
      }
    }
  }
  if (carry_row >= 0) flush();
}

// Columns [c0, c0 + n) of the call's tables: a launch takes at most
// kMaxCols by value, and a call of more launches once for each chunk of
// kMaxCols (chunks.cuh; the columns are independent).
void fill_range_columns(RangeColumns* c, const void* const* ids, const int64_t* offsets, const int64_t* sizes,
                        const int64_t* starts, const int64_t* padded, int c0, int n) {
  for (int k = 0; k < n; ++k) {
    c->ids[k] = static_cast<const int32_t*>(ids[c0 + k]);
    c->offset[k] = offsets[c0 + k];
    c->size[k] = sizes[c0 + k];
    c->start[k] = starts[c0 + k];
    c->padded[k] = padded[c0 + k];
  }
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
// float32 [B, L] → out float32 [B, D] (rows out_row_stride floats apart), the
// weighted sums; take = 0: the zero rule, take = 1: jnp.take's rule on the
// padded table of `padded` rows, NaN bags written when write_nan. The plan
// (the wrapper's bag_fwd_plan): tiles of tile_bags bags with the shard
// staged, or none (0).
extern "C" int nvt_range_bag(const float* table, int64_t rows_local, int64_t start, int D, const int32_t* values,
                             const float* mask, int64_t B, int L, int take, int64_t padded, int write_nan, float* out,
                             int64_t out_row_stride, int vec, int tile_bags, void* stream_ptr) {
  if (B == 0 || D == 0) return 0;
  if (bad_range_shape(D, B, vec) || L < 0 || (take && start + rows_local > padded) || tile_bags < 0 ||
      (tile_bags && (static_cast<int64_t>(tile_bags) * L > kBagTileIds || rows_local * D > kBagStageFloats)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (tile_bags) {
    const bool vec_ids = L % 4 == 0 && reinterpret_cast<uintptr_t>(values) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(mask) % 16 == 0;
    const auto launch = vec == 4 ? (vec_ids ? launch_range_bag_tiles<4, true> : launch_range_bag_tiles<4, false>)
                                 : (vec_ids ? launch_range_bag_tiles<1, true> : launch_range_bag_tiles<1, false>);
    return launch(table, rows_local, start, D, values, mask, B, L, take, padded, write_nan, out, out_row_stride,
                  tile_bags, stream);
  }
  if (vec == 4)
    range_bag_vectors_kernel<4><<<blocks_for(B * (D / 4)), kThreads, 0, stream>>>(
        table, rows_local, start, D, values, mask, B, L, take, padded, write_nan, out, out_row_stride);
  else
    range_bag_vectors_kernel<1><<<blocks_for(B * D), kThreads, 0, stream>>>(
        table, rows_local, start, D, values, mask, B, L, take, padded, write_nan, out, out_row_stride);
  return static_cast<int>(cudaGetLastError());
}

// grad float32 [B, D] (rows grad_row_stride floats apart), values int32
// [B, L], mask float32 [B, L] → dtable float32 [rows_local, D], zeroed here,
// then the held ids' terms. S 0: the global path; else the shared path by
// the wrapper's plan, `blocks` blocks of kBagThreads in groups of S lanes,
// each group a private copy of rows_local * D floats in shared memory.
extern "C" int nvt_range_bag_grad(const float* grad, int64_t grad_row_stride, const int32_t* values, const float* mask,
                                  int64_t B, int L, int D, int64_t start, int64_t rows_local, int64_t padded, int wrap,
                                  int mean, float* dtable, int vec, int S, int blocks, void* stream_ptr) {
  if (bad_range_shape(D, B, vec) || L < 0 || rows_local < 0 || start < 0 || start + rows_local > padded)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t cells = rows_local * D;
  if (cells > 0) {
    const cudaError_t err = cudaMemsetAsync(dtable, 0, static_cast<size_t>(cells) * sizeof(float), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (B * L == 0 || cells == 0) return 0;
  if (S == 0) {
    const int64_t n = B * (D / vec);
    if (vec == 4)
      range_bag_grad_global_kernel<4><<<blocks_for(n), kThreads, 0, stream>>>(
          grad, grad_row_stride, values, mask, B, L, D, start, rows_local, padded, wrap, mean, dtable);
    else
      range_bag_grad_global_kernel<1><<<blocks_for(n), kThreads, 0, stream>>>(
          grad, grad_row_stride, values, mask, B, L, D, start, rows_local, padded, wrap, mean, dtable);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t smem = kBagThreads / S * cells * static_cast<int64_t>(sizeof(float));
  if (S > 32 || (S & (S - 1)) || blocks < 1 || smem > kSmemOptIn) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_ids = L == 4 && reinterpret_cast<uintptr_t>(values) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(mask) % 16 == 0;
  const CopiesLaunch launch{grad, grad_row_stride, values, mask, B, L, D, start, rows_local, padded, wrap, mean, S,
                            dtable, blocks, static_cast<int>(smem), stream};
  return static_cast<int>(vec == 4 ? (vec_ids ? launch.run<4, true>() : launch.run<4, false>())
                                   : (vec_ids ? launch.run<1, true>() : launch.run<1, false>()));
}

// ids: C int32 [B] columns; offsets, sizes, starts, padded: int64 [C];
// table float32 [rows_local, D] → out float32 [B, C, D] with rows
// out_row_stride floats apart (each row's [C, D] block contiguous).
// model_rank 0 writes NaN for the ids no rank holds. *launches: the kernel
// launches made, one for each chunk of kMaxCols columns.
extern "C" int nvt_range_gather_columns(const void* const* ids, const int64_t* offsets, const int64_t* sizes,
                                        const int64_t* starts, const int64_t* padded, int num_cols,
                                        const float* table, int D, int64_t B, int model_rank, float* out,
                                        int64_t out_row_stride, int vec, int* launches, void* stream_ptr) {
  if (num_cols < 1 || bad_range_shape(D, B, vec)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int write_nan = model_rank == 0;
  return nvt::for_each_chunk(num_cols, kMaxCols, [&](int c0, int n) {
    RangeColumns c;
    fill_range_columns(&c, ids, offsets, sizes, starts, padded, c0, n);
    float* o = out + static_cast<int64_t>(c0) * D;
    const int64_t tiles = (B + kGatherRows - 1) / kGatherRows;  // a block a tile
    unsigned blocks = 0;
    if (vec == 4) {
      if (int rc = nvt::resident_blocks(range_gather_columns_kernel<4>, kThreads, 0, tiles, &blocks)) return rc;
      range_gather_columns_kernel<4><<<blocks, kThreads, 0, stream>>>(c, n, table, D, B, write_nan, o, out_row_stride);
    } else {
      if (int rc = nvt::resident_blocks(range_gather_columns_kernel<1>, kThreads, 0, tiles, &blocks)) return rc;
      range_gather_columns_kernel<1><<<blocks, kThreads, 0, stream>>>(c, n, table, D, B, write_nan, o, out_row_stride);
    }
    return nvt::launched(launches);
  });
}

// grad float32 [B, C, D] with rows grad_row_stride floats apart (each
// row's [C, D] block contiguous) → dtable float32 [rows_local, D], zeroed
// here, then the atomics: a launch for each chunk of kMaxCols columns and
// kCarryMaxDim floats of a row, counted in *launches.
extern "C" int nvt_range_scatter_grad(const void* const* ids, const int64_t* offsets, const int64_t* sizes,
                                      const int64_t* starts, const int64_t* padded, int num_cols, const float* grad,
                                      int64_t grad_row_stride, int D, int64_t B, float* dtable, int64_t rows_local,
                                      int vec, int* launches, void* stream_ptr) {
  if (num_cols < 1 || bad_range_shape(D, B, vec) || rows_local < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (rows_local > 0) {
    const cudaError_t err = cudaMemsetAsync(dtable, 0, static_cast<size_t>(rows_local) * D * sizeof(float), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (B == 0) return 0;
  return nvt::for_each_chunk(num_cols, kMaxCols, [&](int c0, int n) {
    RangeColumns c;
    fill_range_columns(&c, ids, offsets, sizes, starts, padded, c0, n);
    const int64_t tiles = (B + 31) / 32 * n;
    const int64_t busy = (tiles + kWarps - 1) / kWarps;  // blocks with a tile a warp
    return nvt::for_each_chunk(D, kCarryMaxDim, [&](int d0, int width) {
      const int smem = kWarps * width * static_cast<int>(sizeof(float));
      const float* g = grad + static_cast<int64_t>(c0) * D + d0;
      unsigned blocks = 0;
      if (vec == 4) {
        if (int rc = nvt::resident_blocks(range_scatter_grad_kernel<4>, kThreads, smem, busy, &blocks)) return rc;
        range_scatter_grad_kernel<4><<<blocks, kThreads, smem, stream>>>(c, n, g, grad_row_stride, D, width, B,
                                                                         dtable + d0);
      } else {
        if (int rc = nvt::resident_blocks(range_scatter_grad_kernel<1>, kThreads, smem, busy, &blocks)) return rc;
        range_scatter_grad_kernel<1><<<blocks, kThreads, smem, stream>>>(c, n, g, grad_row_stride, D, width, B,
                                                                         dtable + d0);
      }
      return nvt::launched(launches);
    });
  });
}
