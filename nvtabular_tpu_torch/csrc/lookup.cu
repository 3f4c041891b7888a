// Column-batched Categorify lookups for Hopper (sm_90a): kernels K1-K3, K6
// and K8 with the Categorify epilogue K4 fused into each.
//
// K1-K3 and K6 read the stacked int32 values of C columns ([C, N], row-major), K8
// float32 values; each writes their final codes ([C, N] int32):
//   hit  -> the code stored in the column's table
//   miss -> miss_code, or where nbuckets[c] > 1 (K4's hashed branch,
//           nvtabular_tpu/ops/categorify.py:628-634)
//           2 + hash_array(v) % nbuckets[c]: hash_lanes(u32(v), u32(v >> 31), 0)
//           for an int32 key, hash_lanes(bits(v), 0, 0) for a float32 key
//           (dispatch.py:66-69, 78-85)
//   validity[c, r] == 0, or a NaN float -> null_code
//   then + col_off[c].
// Categorify passes miss 2 (OOV_INDEX) and null 1 (NULL_INDEX), and
// nbuckets when a column has several OOV buckets (nullptr otherwise); its
// codes are 2 + num_buckets + rank and col_off the single_table offset.
// The value is in a register already, so the hash costs nothing on a hit.
// A TargetEncoding or JoinGroupby group index
// (nvtabular_tpu/ops/groupby_stats.py:590-610) passes num_groups for both
// and col_off 0: its codes are group rows, and misses and nulls read the
// pad slot.
// This is nvtabular_tpu/ops/categorify.py:1666-1684 (_encode_batched_device's
// null/offset/cast epilogue, with _Vocab._oov_codes_dev at :628-634) fused
// into the lookup, so one launch per table kind writes final codes.
//
// sel[c] picks the table row of value row c (joint vocabularies share one).
// Every entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the Python wrapper can raise.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "async.cuh"
#include "hash.cuh"

namespace {

constexpr int kTinyMax = 4096;
constexpr int kThreads = 256;

struct Epilogue {
  int32_t miss;
  int32_t null;
  const int32_t* nbuckets;  // [C] or nullptr: every column has one OOV bucket
};

constexpr int32_t kOovIndex = 2;
constexpr float kFloatMinNormal = 1.17549435e-38f;

// the OOV code of a miss of column c whose key hashes to lanes (lo, hi)
__device__ __forceinline__ int32_t miss_code(uint32_t lo, uint32_t hi, int c, const Epilogue& e) {
  if (e.nbuckets != nullptr) {
    const int32_t nb = e.nbuckets[c];
    if (nb > 1) return kOovIndex + static_cast<int32_t>(nvt::hash_lanes(lo, hi, 0u) % static_cast<uint32_t>(nb));
  }
  return e.miss;
}

// the code of int32 key v of column c at flat index i
__device__ __forceinline__ int32_t epilogue(int32_t code, bool hit, int32_t v, int c, const uint8_t* valid,
                                            int64_t i, int32_t off, const Epilogue& e) {
  int32_t out = hit ? code : miss_code(static_cast<uint32_t>(v), static_cast<uint32_t>(v >> 31), c, e);
  if (valid != nullptr && valid[i] == 0) out = e.null;
  return out + off;
}

// Lemire, Kaser & Kurz, "Faster remainder by direct computation" (2019):
// a % d = mulhi64((m * a) mod 2^64, d) for m = ceil(2^64 / d), every 32-bit a
// and 0 < d < 2^32 (d = 1: m wraps to 0, and so does the remainder).
__device__ __forceinline__ uint64_t fastmod_m(uint32_t d) { return ~uint64_t{0} / d + 1; }
__device__ __forceinline__ uint32_t fastmod(uint32_t a, uint64_t m, uint32_t d) {
  return static_cast<uint32_t>(__umul64hi(m * a, d));
}

// The hashed branch's OOV code of int32 key v: 2 + hash_array(v) % nk, by
// fastmod (nk > 1; mk its multiplier).
__device__ __forceinline__ int32_t hashed_miss(int32_t v, uint32_t nk, uint64_t mk) {
  return kOovIndex +
         static_cast<int32_t>(fastmod(nvt::hash_lanes(static_cast<uint32_t>(v), static_cast<uint32_t>(v >> 31), 0u),
                                      mk, nk));
}

// A thread's turn in K1 and K3: values [i0, i0 + cnt) of one column
// (cnt <= kUnit) and whether each is a live (valid) row.
constexpr int kUnit = 4;  // values a thread a turn: one int4
struct ValueUnit {
  int32_t v[kUnit];
  bool live[kUnit];
};

// The unit's values and validity: a 16-byte value load and a 4-byte
// validity word where kVec (cnt == 4, aligned), else one at a time.
template <bool kVec>
__device__ __forceinline__ ValueUnit load_unit(const int32_t* __restrict__ values, const uint8_t* __restrict__ valid,
                                               int64_t i0, int cnt) {
  ValueUnit u;
  if constexpr (kVec) {
    const int4 q = __ldcs(reinterpret_cast<const int4*>(values + i0));
    u.v[0] = q.x; u.v[1] = q.y; u.v[2] = q.z; u.v[3] = q.w;
    const uint32_t w = valid != nullptr ? __ldcs(reinterpret_cast<const unsigned int*>(valid + i0)) : 0x01010101u;
#pragma unroll
    for (int q4 = 0; q4 < kUnit; ++q4) u.live[q4] = ((w >> (8 * q4)) & 0xFFu) != 0;
  } else {
#pragma unroll
    for (int q4 = 0; q4 < kUnit; ++q4) {
      u.v[q4] = q4 < cnt ? values[i0 + q4] : 0;
      u.live[q4] = q4 < cnt && (valid == nullptr || valid[i0 + q4] != 0);
    }
  }
  return u;
}

// The unit's codes r: a 16-byte streaming store where kVec, else one at a time.
template <bool kVec>
__device__ __forceinline__ void store_unit(int32_t* __restrict__ out, int64_t i0, int cnt, const int32_t (&r)[kUnit]) {
  if constexpr (kVec) {
    __stcs(reinterpret_cast<int4*>(out + i0), make_int4(r[0], r[1], r[2], r[3]));
  } else {
#pragma unroll
    for (int q4 = 0; q4 < kUnit; ++q4)
      if (q4 < cnt) out[i0 + q4] = r[q4];
  }
}

// K1: tiny vocabularies. Replaces BatchedTiny.encode_dev
// (nvtabular_tpu/ops/lookup.py:157-167), which compares every value with
// every key of its column and max-reduces the matching code.
//
// Row b of the bin holds its lens[b] keys sorted, then repeats its first key
// to vmax (so only [0, lens[b]) is searched); vmax <= 4096. Each value takes
// the lower bound of its column's keys, a hit where the key there equals it.
// Vocabulary keys are unique, so that equals the reference's max-reduce.
//
// Bound: the value reads and code writes (8 B per value) and, on the
// operations side, one compare a search step; a table is a few KB. Each
// search step is integer work (a compare and two adds) beside one
// shared-memory probe, and Hopper issues integer instructions at half the
// rate of float ones, so at Criteo's tables (6.6 steps a value on average,
// 12 at 2,209 keys) the instructions and probes a value bound the batched
// launch, and the staging and the chain of dependent probes a short one.
// Design:
// * A persistent grid (the blocks the card holds at once, at most one a
//   turn of 1,024 values, so that the solo branch's [1, 262144] spreads over
//   every SM) splits the flat [C, N] values evenly; a block walks its share
//   column by column and stages a column's keys only when it enters it.
// * Staging: the row's keys are read as 16-byte vectors from its
//   16-byte-aligned floor, every load issued before the barrier, and each key
//   is written to its node of an Eytzinger (breadth-first) tree of 2^h - 1
//   nodes (h = bit_length(len), so 2^h - 1 >= len; the sorted slots past len
//   hold INT32_MAX, which no key is below). A level's lanes read nodes spread
//   over all 32 banks (a sorted array's power-of-two steps would send them to
//   one). Codes are not staged: a hit reads its code through L1.
// * A thread takes 4 consecutive values a turn (one 16-byte load, the
//   validity as one word, one 16-byte store; scalar edges where a segment is
//   unaligned or short), the first turn's values loaded before the staging
//   barrier and each next turn's before this one's searches.
// * The search has a fixed depth h, the same for every lane of a column, and
//   interleaves the thread's 4 values, so their 4 probes of a level are in
//   flight together: k = 2k + (tree[k] < x) from k = 1 ends at 2^h + (keys
//   < x), the lower bound, and k >> ffs(~k) is the node of the first key >= x.
//   It steps shared-memory addresses, not indexes: three integer
//   instructions a level. The unit's 4 hit tests, then its hits' 4 code
//   loads, all go out before any result is used.
constexpr int kTinyThreads = 256;
constexpr int kTinyMinBlocks = 4;  // resident blocks an SM the registers must allow
constexpr int kTinyStageVecs = (kTinyMax + 6) / 4 / kTinyThreads + 1;  // a thread's 16-byte key loads, at most

__device__ __forceinline__ int bit_length(int x) { return 32 - __clz(x); }

// The Eytzinger node of sorted slot i in a tree of 2^h - 1 nodes: the slot
// j = i + 1 = (2m + 1) 2^t sits at depth h - 1 - t, m-th of its level.
__device__ __forceinline__ int tiny_node(int i, int h) {
  const int j = i + 1;
  const int t = __ffs(j) - 1;
  return (1 << (h - 1 - t)) + (j >> (t + 1));
}

// The dynamic shared memory: the tree's 2^bit_length(vmax) int32 slots
// (node 0 unused), at least 4.
inline int tiny_smem_bytes(int vmax) {
  int h = 0;
  while (h < 31 && (1 << h) <= vmax) ++h;
  return 4 * ((1 << h) > 4 ? (1 << h) : 4);
}

struct TinyCol {  // one column's table and constants, in registers for its segment
  const int32_t* codes;
  int len, h;
  int32_t col_off;
  uint32_t nk;  // OOV buckets (0: one, the Epilogue's miss)
  uint64_t mk;
};

// Stage a row of len keys as an Eytzinger tree of depth h.
__device__ __forceinline__ void tiny_stage(const int32_t* keys, int len, int h, int32_t* tree) {
  __syncthreads();  // the previous column's searches are done with the tree
  const int ko = static_cast<int>((reinterpret_cast<uintptr_t>(keys) & 15) >> 2);
  const int4* kv = reinterpret_cast<const int4*>(keys - ko);
  const int nk4 = (ko + len + 3) >> 2;
  int4 q[kTinyStageVecs];
#pragma unroll
  for (int s = 0; s < kTinyStageVecs; ++s) {
    const int v = threadIdx.x + s * kTinyThreads;
    if (v < nk4) q[s] = __ldg(kv + v);
  }
  for (int i = len + threadIdx.x; i < (1 << h) - 1; i += kTinyThreads) tree[tiny_node(i, h)] = INT32_MAX;
#pragma unroll
  for (int s = 0; s < kTinyStageVecs; ++s) {
    const int v = threadIdx.x + s * kTinyThreads;
    if (v < nk4) {
      const int32_t k4[4] = {q[s].x, q[s].y, q[s].z, q[s].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * v + e - ko;
        if (i >= 0 && i < len) tree[tiny_node(i, h)] = k4[e];
      }
    }
  }
  __syncthreads();
}

// A 4-byte load from shared-memory address a.
__device__ __forceinline__ int32_t lds(uint32_t a) {
  int32_t v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}

// The unit's codes: its 4 searches interleaved level by level. A search
// holds the shared address of its node k, a = tree + 4k; its child's is
// tree + 4 (2k + (key < x)) = 2a - tree, plus 4 where key < x: a compare, a
// shift-add and a predicated add a level.
template <bool kVec>
__device__ __forceinline__ void tiny_codes(const ValueUnit& u, uint32_t tree, const TinyCol& col,
                                           int32_t* __restrict__ out, int64_t i0, int cnt, const Epilogue& e) {
  uint32_t a[kUnit];
#pragma unroll
  for (int q4 = 0; q4 < kUnit; ++q4) a[q4] = tree + 4u;
  for (int d = 0; d < col.h; ++d) {
#pragma unroll
    for (int q4 = 0; q4 < kUnit; ++q4) {
      const bool right = lds(a[q4]) < u.v[q4];
      a[q4] = 2u * a[q4] - tree;
      if (right) a[q4] += 4u;
    }
  }
  // the 4 hit tests' probes, then the hits' 4 code loads, go out before any is used
  int pos[kUnit];
  bool hit[kUnit];
#pragma unroll
  for (int q4 = 0; q4 < kUnit; ++q4) {
    const int k = static_cast<int>((a[q4] - tree) >> 2);  // 2^h + (keys < x)
    pos[q4] = k - (1 << col.h);
    hit[q4] = lds(tree + 4u * static_cast<uint32_t>(k >> __ffs(~k))) == u.v[q4] && pos[q4] < col.len;
  }
  int32_t code[kUnit];
#pragma unroll
  for (int q4 = 0; q4 < kUnit; ++q4) code[q4] = hit[q4] ? __ldg(col.codes + pos[q4]) : e.miss;
  if (col.nk > 1) {
#pragma unroll
    for (int q4 = 0; q4 < kUnit; ++q4)
      if (!hit[q4]) code[q4] = hashed_miss(u.v[q4], col.nk, col.mk);
  }
  int32_t r[kUnit];
#pragma unroll
  for (int q4 = 0; q4 < kUnit; ++q4) r[q4] = (u.live[q4] ? code[q4] : e.null) + col.col_off;
  store_unit<kVec>(out, i0, cnt, r);
}

// VEC: values and out 16-byte aligned, validity (if any) 4-byte aligned, so
// a flat index that is a multiple of 4 aligns all three.
template <bool VEC>
__global__ void __launch_bounds__(kTinyThreads, kTinyMinBlocks)
tiny_lookup_kernel(const int32_t* __restrict__ values, const uint8_t* __restrict__ valid,
                   const int32_t* __restrict__ keys, const int32_t* __restrict__ codes,
                   const int32_t* __restrict__ lens, const int32_t* __restrict__ sel,
                   const int32_t* __restrict__ col_off, int32_t* __restrict__ out,
                   int64_t n, int num_cols, int vmax, Epilogue e) {
  extern __shared__ int4 s_tiny4[];
  int32_t* tree = reinterpret_cast<int32_t*>(s_tiny4);
  constexpr int64_t kStride = kTinyThreads * kUnit;
  const int64_t total = n * num_cols;
  const int64_t share_end = total * (blockIdx.x + 1) / gridDim.x;
  for (int64_t seg = total * blockIdx.x / gridDim.x; seg < share_end;) {  // the same for every thread
    const int c = static_cast<int>(seg / n);
    const int64_t seg_end = (c + 1) * n < share_end ? (c + 1) * n : share_end;
    const int b = sel[c];
    TinyCol col;
    col.len = lens[b] < 0 ? 0 : (lens[b] > vmax ? vmax : lens[b]);
    col.h = col.len > 0 ? bit_length(col.len) : 0;
    col.codes = codes + static_cast<int64_t>(b) * vmax;
    col.col_off = col_off[c];
    const int32_t nk = e.nbuckets != nullptr ? e.nbuckets[c] : 0;
    col.nk = nk > 1 ? static_cast<uint32_t>(nk) : 0u;
    col.mk = col.nk > 1 ? fastmod_m(col.nk) : 0;
    // [a0, a1): whole units of 4 (from a multiple of 4 where VEC); the 0-3 values on either side alone
    int64_t a0 = VEC ? (seg + 3) & ~int64_t{3} : seg;
    if (a0 > seg_end) a0 = seg_end;
    const int64_t a1 = a0 + (seg_end - a0) / kUnit * kUnit;
    int64_t i = a0 + static_cast<int64_t>(threadIdx.x) * kUnit;
    ValueUnit cur;
    if (i < a1) cur = load_unit<VEC>(values, valid, i, kUnit);  // in flight while the tree stages
    tiny_stage(keys + static_cast<int64_t>(b) * vmax, col.len, col.h, tree);
    const uint32_t t = nvt::smem_addr(tree);
    if (threadIdx.x == 0 && a0 > seg) {
      const int cnt = static_cast<int>(a0 - seg);
      tiny_codes<false>(load_unit<false>(values, valid, seg, cnt), t, col, out, seg, cnt, e);
    }
    if (threadIdx.x == 1 && seg_end > a1) {
      const int cnt = static_cast<int>(seg_end - a1);
      tiny_codes<false>(load_unit<false>(values, valid, a1, cnt), t, col, out, a1, cnt, e);
    }
    for (; i < a1; i += kStride) {
      ValueUnit next;
      if (i + kStride < a1) next = load_unit<VEC>(values, valid, i + kStride, kUnit);
      tiny_codes<VEC>(cur, t, col, out, i, kUnit, e);
      cur = next;
    }
    seg = seg_end;
  }
}

// K2: direct (dense) map. Replaces BatchedDirect.encode_dev
// (nvtabular_tpu/ops/lookup.py:585-601), which on the TPU gathers an 8-lane
// row and selects a lane; here one 4-byte load per value.
//
// Semantics: idx = clip(v - min, 0, len - 1), taken in int64 (in int32 it
// overflows for keys far from min), code = table[table_off + idx], and a hit
// where min <= v <= max and code >= 0: the hit test uses v itself, so the
// codes equal the reference's. A value outside [min, max] or a row marked
// invalid reads no table entry (neither can hit).
//
// Bound: bytes. Values and codes stream (8 B per value); each table read is
// one random 32-byte sector. The tables (62,000 to 300,000 keys a column,
// 0.25-1.2 MB) sit in L2 but not in shared memory, so the rate of random
// reads through L1 and L2 and the latency before them set the time, not the
// bytes. Design:
// * A block takes kThreads x 4 values of one column (blockIdx.y), a thread
//   4 consecutive ones (K1's and K3's unit): one 16-byte value load, the
//   validity as one word and one 16-byte streaming code store where the
//   column is aligned and N a multiple of 4, else one at a time.
// * The values' load goes out before the column's constants are read; the
//   unit's table loads go out together, through L1 (__ldg).
// * The hashed branch's 2 + hash % nbuckets[c] by fastmod, as K1 and K3.
// On an H100 80GB HBM3 at 700 W, K3's persistent grid (the blocks the card
// holds at once splitting the flat [C, N] values, each thread's next unit
// loaded before this one's table reads) was slower than this grid at every
// main-path shape; one value a thread took as long at phase 6's and the
// solo branch's shapes, and longer at phase 9's and 10's and on misses.
struct DirectCol {  // a column's table and constants
  const int32_t* table;  // the column's row of the bin: table + table_off[b]
  int64_t last;          // lens[b] - 1
  int32_t mn, mx, col_off;
  uint32_t nk;  // OOV buckets (0: one, the Epilogue's miss)
  uint64_t mk;
};

// VEC: values and out 16-byte aligned, validity (if any) 4-byte aligned and
// N a multiple of 4, so that every unit is whole and aligned.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
direct_lookup_kernel(const int32_t* __restrict__ values, const uint8_t* __restrict__ valid,
                     const int32_t* __restrict__ table, const int32_t* __restrict__ mins,
                     const int32_t* __restrict__ maxs, const int64_t* __restrict__ lens,
                     const int64_t* __restrict__ table_off, const int32_t* __restrict__ sel,
                     const int32_t* __restrict__ col_off, int32_t* __restrict__ out, int64_t n, Epilogue e) {
  const int64_t r = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kUnit;
  if (r >= n) return;
  const int c = blockIdx.y;
  const int64_t i0 = c * n + r;
  const int cnt = n - r < kUnit ? static_cast<int>(n - r) : kUnit;
  const ValueUnit u = load_unit<VEC>(values, valid, i0, cnt);
  const int b = sel[c];
  DirectCol col;
  col.table = table + table_off[b];
  col.last = lens[b] - 1;
  col.mn = mins[b];
  col.mx = maxs[b];
  col.col_off = col_off[c];
  const int32_t nk = e.nbuckets != nullptr ? e.nbuckets[c] : 0;
  col.nk = nk > 1 ? static_cast<uint32_t>(nk) : 0u;
  col.mk = col.nk > 1 ? fastmod_m(col.nk) : 0;
  // the live in-range values' table loads together, then the epilogue
  int32_t code[kUnit];
#pragma unroll
  for (int k = 0; k < kUnit; ++k) {
    code[k] = -1;  // no hit
    if (u.live[k] && u.v[k] >= col.mn && u.v[k] <= col.mx) {
      const int64_t idx = static_cast<int64_t>(u.v[k]) - col.mn;  // >= 0
      code[k] = __ldg(col.table + (idx < col.last ? idx : col.last));
    }
  }
  int32_t res[kUnit];
#pragma unroll
  for (int k = 0; k < kUnit; ++k) {
    const int32_t miss = col.nk > 1 ? hashed_miss(u.v[k], col.nk, col.mk) : e.miss;
    res[k] = (u.live[k] ? (code[k] >= 0 ? code[k] : miss) : e.null) + col.col_off;
  }
  store_unit<VEC>(out, i0, cnt, res);
}

__device__ __forceinline__ void probe(const int4& k, const int4& v, int32_t key, int32_t& code,
                                      bool& hit) {
  // the reference's override order (lookup.py:702-707): slot 0..3, later wins;
  // a key lives in one slot only, so the order never changes a code
  if (k.x == key && v.x >= 0) { code = v.x; hit = true; }
  if (k.y == key && v.y >= 0) { code = v.y; hit = true; }
  if (k.z == key && v.z >= 0) { code = v.z; hit = true; }
  if (k.w == key && v.w >= 0) { code = v.w; hit = true; }
}

// K3: two-choice, 4-slot bucketed cuckoo. Replaces BatchedCuckoo.encode_dev
// (nvtabular_tpu/ops/lookup.py:693-708), which gathers both buckets of every
// value and lets a hit in the second override one in the first.
//
// Precondition: a key sits in at most one slot of its two buckets, as
// build_cuckoo places every key exactly once (kernels/lookup.py's tables
// come from ops/lookup.py:build_cuckoo). Under it the two buckets never both
// hit, so probing b1 only where b0 misses gives the reference's codes.
//
// Bound: bytes, dominated by random 32-byte buckets from a table of ~200 MB
// at the Criteo-TB profile (four times L2). A bucket row [k0..k3, v0..v3] is
// exactly one 32-byte sector, read as two aligned int4 loads. The build
// places by first choice first at load 0.8, so most keys sit in b0: a hit
// there moves 40 B (value, code and one sector), not the 72 B of reading
// both buckets; misses (out-of-vocabulary values) still read both.
// Design:
// * A persistent grid (the blocks the card holds at once) splits the flat
//   [C, N] values evenly; a block walks its share column by column, each
//   column's sel, nbs, row_off, col_off and nbuckets read once a segment
//   into registers (a block's share spans one or two columns).
// * A thread takes 4 consecutive values a turn: one 16-byte value load,
//   the validity as one 32-bit word, one 16-byte code store, where the
//   arrays are aligned (a segment's unaligned first and last 0-3 values go
//   through the same code with scalar loads); rows marked invalid read no
//   bucket.
// * The four b0 buckets' loads go out before any compare, then the b1 loads
//   of the values that missed, together; the thread's next 4 values are
//   loaded before this turn's buckets. A random sector costs a round trip
//   to device memory, so the kernel is bound by round trips in flight: 4
//   blocks of 256 threads an SM (at most 64 registers), 4 values each.
// * Bucket indexes fmix32(u32(v) ^ seed) % nbs[b] + row_off[b] (seeds 0 and
//   0x9E3779B9, uint32 as in the reference) take Lemire's fastmod (a multiply
//   by ceil(2^64 / nb) and a 64-bit multiply-high; exact for every 32-bit
//   value and nb < 2^32), as does the hashed branch's % nbuckets[c].
constexpr int kCuckooThreads = 256;
constexpr int kCuckooMinBlocks = 4;  // resident blocks an SM the registers must allow

struct CuckooCol {  // one column's constants, in registers for its segment
  int64_t row_off;
  uint64_t m, mk;  // fastmod's multipliers of nb and nk
  uint32_t nb, nk;  // buckets; OOV buckets (0: one, the Epilogue's miss)
  int32_t col_off;
};

__device__ __forceinline__ int64_t cuckoo_bucket(uint32_t u, uint32_t seed, const CuckooCol& col) {
  return col.row_off + fastmod(nvt::fmix32(u ^ seed), col.m, col.nb);
}

// The unit's codes: every b0 bucket's loads go out before any compare, then
// the b1 loads of the values b0 missed, together; a 16-byte code store where
// kVec.
template <bool kVec>
__device__ __forceinline__ void cuckoo_codes(const ValueUnit& u, const int4* __restrict__ table,
                                             const CuckooCol& col, int32_t* __restrict__ out, int64_t i0, int cnt,
                                             const Epilogue& e) {
  int4 k[kUnit], s[kUnit];
#pragma unroll
  for (int q4 = 0; q4 < kUnit; ++q4) {
    if (u.live[q4]) {
      const int64_t b0 = cuckoo_bucket(static_cast<uint32_t>(u.v[q4]), 0u, col);
      k[q4] = __ldg(table + 2 * b0);
      s[q4] = __ldg(table + 2 * b0 + 1);
    }
  }
  int32_t code[kUnit];
  bool hit[kUnit];
#pragma unroll
  for (int q4 = 0; q4 < kUnit; ++q4) {
    code[q4] = 0;
    hit[q4] = false;
    if (u.live[q4]) probe(k[q4], s[q4], u.v[q4], code[q4], hit[q4]);
  }
#pragma unroll
  for (int q4 = 0; q4 < kUnit; ++q4) {
    if (u.live[q4] && !hit[q4]) {
      const int64_t b1 = cuckoo_bucket(static_cast<uint32_t>(u.v[q4]), 0x9E3779B9u, col);
      k[q4] = __ldg(table + 2 * b1);
      s[q4] = __ldg(table + 2 * b1 + 1);
    }
  }
  int32_t r[kUnit];
#pragma unroll
  for (int q4 = 0; q4 < kUnit; ++q4) {
    if (u.live[q4] && !hit[q4]) probe(k[q4], s[q4], u.v[q4], code[q4], hit[q4]);
    const int32_t miss = col.nk > 1 ? hashed_miss(u.v[q4], col.nk, col.mk) : e.miss;
    r[q4] = (u.live[q4] ? (hit[q4] ? code[q4] : miss) : e.null) + col.col_off;
  }
  store_unit<kVec>(out, i0, cnt, r);
}

// VEC: values and out 16-byte aligned, validity (if any) 4-byte aligned, so
// a flat index that is a multiple of 4 aligns all three. A thread's next
// unit's values are loaded before this unit's buckets are probed, so that a
// unit waits for two round trips (b0, then b1 of its misses), not three.
template <bool VEC>
__global__ void __launch_bounds__(kCuckooThreads, kCuckooMinBlocks)
cuckoo_lookup_kernel(const int32_t* __restrict__ values, const uint8_t* __restrict__ valid,
                     const int4* __restrict__ table, const int64_t* __restrict__ nbs,
                     const int64_t* __restrict__ row_off, const int32_t* __restrict__ sel,
                     const int32_t* __restrict__ col_off, int32_t* __restrict__ out, int64_t n, int num_cols,
                     Epilogue e) {
  constexpr int64_t kStride = kCuckooThreads * kUnit;
  const int64_t total = n * num_cols;
  const int64_t share_end = total * (blockIdx.x + 1) / gridDim.x;
  for (int64_t seg = total * blockIdx.x / gridDim.x; seg < share_end;) {
    const int c = static_cast<int>(seg / n);
    const int64_t seg_end = (c + 1) * n < share_end ? (c + 1) * n : share_end;
    const int b = sel[c];
    CuckooCol col;
    col.nb = static_cast<uint32_t>(nbs[b]);
    col.m = fastmod_m(col.nb);
    col.row_off = row_off[b];
    col.col_off = col_off[c];
    const int32_t nk = e.nbuckets != nullptr ? e.nbuckets[c] : 0;
    col.nk = nk > 1 ? static_cast<uint32_t>(nk) : 0u;
    col.mk = col.nk > 1 ? fastmod_m(col.nk) : 0;
    // [a0, a1): whole units of 4 (from a multiple of 4 where VEC); the 0-3 values on either side alone
    int64_t a0 = VEC ? (seg + 3) & ~int64_t{3} : seg;
    if (a0 > seg_end) a0 = seg_end;
    const int64_t a1 = a0 + (seg_end - a0) / kUnit * kUnit;
    if (threadIdx.x == 0 && a0 > seg) {
      const int cnt = static_cast<int>(a0 - seg);
      cuckoo_codes<false>(load_unit<false>(values, valid, seg, cnt), table, col, out, seg, cnt, e);
    }
    if (threadIdx.x == 1 && seg_end > a1) {
      const int cnt = static_cast<int>(seg_end - a1);
      cuckoo_codes<false>(load_unit<false>(values, valid, a1, cnt), table, col, out, a1, cnt, e);
    }
    int64_t i = a0 + static_cast<int64_t>(threadIdx.x) * kUnit;
    ValueUnit cur;
    if (i < a1) cur = load_unit<VEC>(values, valid, i, kUnit);
    for (; i < a1; i += kStride) {
      ValueUnit next;
      if (i + kStride < a1) next = load_unit<VEC>(values, valid, i + kStride, kUnit);
      cuckoo_codes<VEC>(cur, table, col, out, i, kUnit, e);
      cur = next;
    }
    seg = seg_end;
  }
}

// K6: a single-hash primary and a two-choice stash. Replaces
// BatchedStash.encode_dev (nvtabular_tpu/ops/lookup.py:632-669), which
// gathers the primary bucket and both stash buckets of every value and lets
// a later hit override.
//
// Bound: bytes. Values and codes stream (8 B per value); the primary bucket
// is one random 32-byte sector (two aligned int4 loads). The stash's two
// sectors are read only on a primary miss: at the build's primary load of
// 0.5, the ~5% of keys that spilled and the values outside the vocabulary.
// The tables must hold each key in exactly one of its three buckets, as
// build_stash makes them: then the codes are the reference's, which always
// probes all three and lets a later hit override. Buckets: primary
// fmix32(u32(v)) & (nbps[b] - 1), stash fmix32(u32(v) ^ seed) & (nbss[b] -
// 1) for the seeds 0x68E31DA4 and 0xB5297A4D (lookup.py:41-42; masks: both
// counts are powers of two), each plus its row offset.
// Grid: (ceil(N / kThreads), C).
__global__ void __launch_bounds__(kThreads)
stash_lookup_kernel(const int32_t* __restrict__ values, const uint8_t* __restrict__ valid,
                    const int4* __restrict__ table, const int64_t* __restrict__ nbps,
                    const int64_t* __restrict__ row_off, const int4* __restrict__ stash,
                    const int64_t* __restrict__ nbss, const int64_t* __restrict__ stash_off,
                    const int32_t* __restrict__ sel, const int32_t* __restrict__ col_off,
                    int32_t* __restrict__ out, int64_t n, Epilogue e) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int c = blockIdx.y;
  const int b = sel[c];
  const int64_t i = static_cast<int64_t>(c) * n + r;
  const int32_t v = values[i];
  const uint32_t u = static_cast<uint32_t>(v);
  const int64_t p = row_off[b] + (nvt::fmix32(u) & static_cast<uint32_t>(nbps[b] - 1));
  int32_t code = 0;
  bool hit = false;
  probe(__ldg(table + 2 * p), __ldg(table + 2 * p + 1), v, code, hit);
  if (!hit) {
    const int64_t nbs = nbss[b];
    if (nbs > 0) {
      const uint32_t mask = static_cast<uint32_t>(nbs - 1);
      const int64_t so = stash_off[b];
      const int64_t s0 = so + (nvt::fmix32(u ^ 0x68E31DA4u) & mask);
      const int64_t s1 = so + (nvt::fmix32(u ^ 0xB5297A4Du) & mask);
      const int4 k0 = __ldg(stash + 2 * s0);
      const int4 v0 = __ldg(stash + 2 * s0 + 1);
      const int4 k1 = __ldg(stash + 2 * s1);
      const int4 v1 = __ldg(stash + 2 * s1 + 1);
      probe(k0, v0, v, code, hit);
      probe(k1, v1, v, code, hit);
    }
  }
  out[i] = epilogue(code, hit, v, c, valid, i, col_off[c], e);
}

// K8: sorted float vocabularies. Replaces the searchsorted branch of
// _Vocab.encode_device (nvtabular_tpu/ops/categorify.py:570-585), which XLA
// lowers to a loop of gathers over one column's sorted float32 keys.
//
// Each value takes the lower bound of its column's keys [starts[b], starts[b]
// + lens[b]) of the concatenated table: the first key >= v (float compares,
// so -0.0 and 0.0 find the same key), a hit when that key equals v. An empty
// vocabulary takes the OOV code with no search; a NaN or invalid row takes
// the null code whatever it would have found. XLA flushes subnormals to zero
// on the reference's device path, so a subnormal value searches as 0.0 (the
// table's keys are flushed when it is built); a missed value hashes its own
// bits, as the reference's bitcast does.
//
// Bound: bytes. Values and codes stream (8 B per value), and the table is
// read where the searches land: at Criteo's float columns ~114K keys a
// column, which L2 (50 MB) holds. A plain binary search makes ~17 dependent
// L2 round trips a value, so the design keeps the search's top levels in
// shared memory and touches L2 once or twice:
//
// * Windows and fences. Column b's keys are cut into windows of S = 2^shift
//   slots from base = starts[b] & ~3 (so every window is 16-byte aligned;
//   slots outside [starts[b], starts[b] + lens[b]) belong to no window's
//   search). The fence of window j is its first key of the column,
//   keys[max(base + j * S, starts[b])]. S is the least power of two >= 4
//   that leaves at most kFenceMax windows, so the fences fit 128 KB.
// * The fences are a complete binary search tree of 2^h - 1 nodes (h the
//   bit length of the window count, +inf past the last fence) in Eytzinger
//   (breadth-first) order, node k at tree[k], built once with the table
//   (sorted_fences in kernels/lookup.py) from fence_starts[b], a multiple
//   of 4 floats. Descending k = 2k + (tree[k] < x) for h steps ends at
//   2^h + (the fences < x), and k >> ffs(~k) is the node of the first fence
//   >= x. A level's lanes read nodes spread over all 32 banks; a sorted
//   array searched by power-of-two steps would send every lane of a level
//   to one bank (measured: 2.7x slower, PERF.md).
// * A persistent grid (the blocks the card holds at once) splits the [C, N]
//   values evenly; a block stages each column's tree it enters in shared
//   memory with one run of 16-byte cp.async copies (twice at most at
//   Criteo's shape) and walks its values kSortedIlp at a time.
// * Window j, the last whose fence is < x, holds the first key >= x or
//   ends just before it, so a run of equal keys that straddles a window
//   edge is found at its first key. It is read with independent float4
//   loads (one L2 round trip; one vector at S = 4) and its keys < x are
//   counted without branches; the least key >= x among the window and the
//   next fence is the key at the answer's slot. None of the fences < x:
//   the first key is the answer. Only a hit reads its code.
constexpr int kFenceMax = 32767;       // sorted_fences' FENCE_MAX: a tree of at most 32,768 floats
constexpr int kTreeBytes = (kFenceMax + 1) * static_cast<int>(sizeof(float));
constexpr int kSortedThreads = 1024;
constexpr int kSortedIlp = 4;          // values a thread searches at once

// key k at slot t of a window whose column slots are [lo, hi): counted when
// below x, else a candidate for the first key >= x
__device__ __forceinline__ void tally(float k, int t, int lo, int hi, float x, int& less, float& first) {
  const bool in = t >= lo && t < hi;
  less += (in && k < x) ? 1 : 0;
  first = (in && !(k < x)) ? fminf(first, k) : first;
}

// The code of value v of a column whose keys are [start, end) and whose
// fence tree of 2^h - 1 nodes is in shared memory.
__device__ __forceinline__ int32_t sorted_code(float v, const float* __restrict__ keys,
                                               const int32_t* __restrict__ codes, const float* tree, int h,
                                               int64_t start, int64_t end, int64_t base, int shift, int c,
                                               const Epilogue& e) {
  const float x = fabsf(v) < kFloatMinNormal ? 0.0f : v;
  int k = 1;
  for (int d = 0; d < h; ++d) k = 2 * k + (tree[k] < x ? 1 : 0);
  const int below = k - (1 << h);  // fences < x
  const int next = k >> __ffs(~k);  // the node of the first fence >= x; 0: none
  float first = next ? tree[next] : __int_as_float(0x7fc00000);  // NaN compares unequal
  int64_t pos = start;  // the first slot whose key is >= x
  if (below > 0) {
    const int64_t w0 = base + (static_cast<int64_t>(below - 1) << shift);
    const int lo = static_cast<int>(start > w0 ? start - w0 : 0);  // the window's column slots [lo, hi)
    const int64_t left = end - w0;
    const int hi = static_cast<int>(left < (int64_t{1} << shift) ? left : (int64_t{1} << shift));
    int less = 0;
    for (int t = 0; t < hi; t += 4) {  // a vector past the column's last slot may lie past the table
      const float4 q = __ldg(reinterpret_cast<const float4*>(keys + w0 + t));
      tally(q.x, t, lo, hi, x, less, first);
      tally(q.y, t + 1, lo, hi, x, less, first);
      tally(q.z, t + 2, lo, hi, x, less, first);
      tally(q.w, t + 3, lo, hi, x, less, first);
    }
    pos = w0 + lo + less;
  }
  return pos < end && first == x ? __ldg(codes + pos) : miss_code(__float_as_uint(v), 0u, c, e);
}

__global__ void __launch_bounds__(kSortedThreads)
sorted_lookup_kernel(const float* __restrict__ values, const uint8_t* __restrict__ valid,
                     const float* __restrict__ keys, const int32_t* __restrict__ codes,
                     const int64_t* __restrict__ starts, const int64_t* __restrict__ lens,
                     const float* __restrict__ fences, const int64_t* __restrict__ fence_starts,
                     const int32_t* __restrict__ fence_shifts, const int32_t* __restrict__ sel,
                     const int32_t* __restrict__ col_off, int32_t* __restrict__ out, int64_t n, int num_cols,
                     Epilogue e) {
  extern __shared__ float4 s_tree4[];
  const float* tree = reinterpret_cast<const float*>(s_tree4);
  const int64_t total = n * num_cols;
  const int64_t share_end = total * (blockIdx.x + 1) / gridDim.x;
  for (int64_t seg = total * blockIdx.x / gridDim.x; seg < share_end;) {
    const int c = static_cast<int>(seg / n);
    const int64_t seg_end = (c + 1) * n < share_end ? (c + 1) * n : share_end;
    const int b = sel[c];
    const int64_t start = starts[b];
    const int64_t end = start + lens[b];
    const int shift = fence_shifts[b];
    const int64_t base = start & ~int64_t{3};
    const int64_t windows = end > start ? (end - base + (int64_t{1} << shift) - 1) >> shift : 0;
    const int h = windows > 0 ? 64 - __clzll(windows < kFenceMax ? windows : kFenceMax) : 0;
    const float* f = fences + fence_starts[b];
    __syncthreads();  // the previous column's searches are done with the tree
    for (int q = threadIdx.x; q < (h > 0 ? ((1 << h) + 3) / 4 : 0); q += kSortedThreads) {
      nvt::cp_async16(reinterpret_cast<float*>(s_tree4 + q), f + 4 * q);
    }
    nvt::cp_async_commit();
    nvt::cp_async_wait<0>();
    __syncthreads();
    const int32_t off = col_off[c];
    for (int64_t i0 = seg + threadIdx.x; i0 < seg_end; i0 += kSortedThreads * kSortedIlp) {
      float v[kSortedIlp];
#pragma unroll
      for (int u = 0; u < kSortedIlp; ++u) {
        const int64_t i = i0 + u * kSortedThreads;
        v[u] = i < seg_end ? values[i] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kSortedIlp; ++u) {
        const int64_t i = i0 + u * kSortedThreads;
        if (i >= seg_end) break;
        int32_t code;
        if (isnan(v[u]) || (valid != nullptr && valid[i] == 0)) {
          code = e.null;
        } else if (h == 0) {
          code = miss_code(__float_as_uint(v[u]), 0u, c, e);
        } else {
          code = sorted_code(v[u], keys, codes, tree, h, start, end, base, shift, c, e);
        }
        out[i] = code + off;
      }
    }
    seg = seg_end;
  }
}

template <bool VEC>
int launch_tiny(const int32_t* values, const uint8_t* valid, const int32_t* keys, const int32_t* codes,
                const int32_t* lens, const int32_t* sel, const int32_t* col_off, int32_t* out, int num_cols,
                int64_t n, int vmax, const Epilogue& e, cudaStream_t s) {
  // The tree of the deepest column; at most one block a turn of
  // kTinyThreads x kUnit values, so that a solo column of 262,144 values
  // still spreads over 256 blocks.
  const int smem = tiny_smem_bytes(vmax);
  const int64_t needed = (num_cols * n + kTinyThreads * kUnit - 1) / (kTinyThreads * kUnit);
  static nvt::ResidentCache cache;
  unsigned blocks = 0;
  if (int rc = nvt::cached_resident_blocks(cache, tiny_lookup_kernel<VEC>, kTinyThreads, smem, needed, &blocks))
    return rc;
  tiny_lookup_kernel<VEC><<<blocks, kTinyThreads, smem, s>>>(values, valid, keys, codes, lens, sel, col_off, out, n,
                                                             num_cols, vmax, e);
  return static_cast<int>(cudaGetLastError());
}

inline unsigned int blocks_for(int64_t n, int64_t per_block) {
  return static_cast<unsigned int>((n + per_block - 1) / per_block);
}

}  // namespace

extern "C" int nvt_tiny_lookup(const int32_t* values, const uint8_t* valid, const int32_t* keys,
                               const int32_t* codes, const int32_t* lens, const int32_t* sel,
                               const int32_t* col_off, int32_t* out, int num_cols, int64_t n,
                               int vmax, int miss, int null_code, const int32_t* nbuckets, void* stream) {
  if (vmax < 0 || vmax > kTinyMax) return static_cast<int>(cudaErrorInvalidValue);
  if (num_cols == 0 || n == 0) return 0;
  const bool vec = reinterpret_cast<uintptr_t>(values) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(valid) % 4 == 0;
  const Epilogue e{miss, null_code, nbuckets};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch_tiny<true>(values, valid, keys, codes, lens, sel, col_off, out, num_cols, n, vmax, e, s)
             : launch_tiny<false>(values, valid, keys, codes, lens, sel, col_off, out, num_cols, n, vmax, e, s);
}

extern "C" int nvt_direct_lookup(const int32_t* values, const uint8_t* valid, const int32_t* table,
                                 const int32_t* mins, const int32_t* maxs, const int64_t* lens,
                                 const int64_t* table_off, const int32_t* sel,
                                 const int32_t* col_off, int32_t* out, int num_cols, int64_t n,
                                 int miss, int null_code, const int32_t* nbuckets, void* stream) {
  if (num_cols == 0 || n == 0) return 0;
  const bool vec = reinterpret_cast<uintptr_t>(values) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(valid) % 4 == 0 && n % kUnit == 0;
  const dim3 grid(blocks_for(n, kThreads * kUnit), num_cols);
  const Epilogue e{miss, null_code, nbuckets};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    direct_lookup_kernel<true><<<grid, kThreads, 0, s>>>(values, valid, table, mins, maxs, lens, table_off, sel,
                                                         col_off, out, n, e);
  else
    direct_lookup_kernel<false><<<grid, kThreads, 0, s>>>(values, valid, table, mins, maxs, lens, table_off, sel,
                                                          col_off, out, n, e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nvt_cuckoo_lookup(const int32_t* values, const uint8_t* valid, const int32_t* table,
                                 const int64_t* nbs, const int64_t* row_off, const int32_t* sel,
                                 const int32_t* col_off, int32_t* out, int num_cols, int64_t n,
                                 int miss, int null_code, const int32_t* nbuckets, void* stream) {
  if (num_cols == 0 || n == 0) return 0;
  const bool vec = reinterpret_cast<uintptr_t>(values) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(valid) % 4 == 0;
  const int64_t units = (n * num_cols + kUnit - 1) / kUnit;
  const int64_t needed = (units + kCuckooThreads - 1) / kCuckooThreads;
  unsigned blocks = 0;
  const Epilogue e{miss, null_code, nbuckets};
  const int4* t4 = reinterpret_cast<const int4*>(table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static nvt::ResidentCache cache[2];  // by vec
  if (vec) {
    if (int rc = nvt::cached_resident_blocks(cache[1], cuckoo_lookup_kernel<true>, kCuckooThreads, 0, needed, &blocks))
      return rc;
    cuckoo_lookup_kernel<true><<<blocks, kCuckooThreads, 0, s>>>(values, valid, t4, nbs, row_off, sel, col_off, out,
                                                                n, num_cols, e);
  } else {
    if (int rc = nvt::cached_resident_blocks(cache[0], cuckoo_lookup_kernel<false>, kCuckooThreads, 0, needed,
                                             &blocks))
      return rc;
    cuckoo_lookup_kernel<false><<<blocks, kCuckooThreads, 0, s>>>(values, valid, t4, nbs, row_off, sel, col_off,
                                                                 out, n, num_cols, e);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nvt_stash_lookup(const int32_t* values, const uint8_t* valid, const int32_t* table,
                                const int64_t* nbps, const int64_t* row_off, const int32_t* stash,
                                const int64_t* nbss, const int64_t* stash_off, const int32_t* sel,
                                const int32_t* col_off, int32_t* out, int num_cols, int64_t n, int miss,
                                int null_code, const int32_t* nbuckets, void* stream) {
  if (num_cols == 0 || n == 0) return 0;
  dim3 grid(blocks_for(n, kThreads), num_cols);
  stash_lookup_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      values, valid, reinterpret_cast<const int4*>(table), nbps, row_off, reinterpret_cast<const int4*>(stash),
      nbss, stash_off, sel, col_off, out, n, Epilogue{miss, null_code, nbuckets});
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nvt_sorted_lookup(const float* values, const uint8_t* valid, const float* keys,
                                 const int32_t* codes, const int64_t* starts, const int64_t* lens,
                                 const float* fences, const int64_t* fence_starts, const int32_t* fence_shifts,
                                 const int32_t* sel, const int32_t* col_off, int32_t* out, int num_cols,
                                 int64_t n, int miss, int null_code, const int32_t* nbuckets, void* stream) {
  if (num_cols == 0 || n == 0) return 0;
  cudaError_t err =
      cudaFuncSetAttribute(sorted_lookup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTreeBytes);
  static int resident = 0;  // blocks the card holds at once: the persistent grid
  if (err == cudaSuccess && resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sorted_lookup_kernel, kSortedThreads, kTreeBytes);
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = n * num_cols;
  const int64_t needed = (total + kSortedThreads - 1) / kSortedThreads;
  const unsigned grid = static_cast<unsigned>(needed < resident ? needed : resident);
  sorted_lookup_kernel<<<grid, kSortedThreads, kTreeBytes, static_cast<cudaStream_t>(stream)>>>(
      values, valid, keys, codes, starts, lens, fences, fence_starts, fence_shifts, sel, col_off, out, n, num_cols,
      Epilogue{miss, null_code, nbuckets});
  return static_cast<int>(cudaGetLastError());
}
