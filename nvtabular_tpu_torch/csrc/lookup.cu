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
#include <cstdint>

#include "async.cuh"
#include "hash.cuh"

namespace {

constexpr int kTinyMax = 4096;
constexpr int kThreads = 256;
constexpr int kTinyRowsPerBlock = 4096;

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

// K1: tiny vocabularies. Replaces BatchedTiny.encode_dev
// (nvtabular_tpu/ops/lookup.py:157-167), which compares every value with
// every key of its column and max-reduces the matching code.
//
// Bound: the value reads and code writes (8 B per value); the bin itself is
// a few KB per column. A compare against all <= 4096 keys would make it
// compute-bound (4096 compares per value), so instead each block stages its
// column's keys and codes in shared memory (<= 32 KB, under the 48 KB static
// limit) and each thread binary-searches its value: <= 12 shared-memory
// probes. Vocabulary keys are unique, so the result equals the max-reduce.
// The bin pads each row past lens[b] with the row's FIRST key, so that tail
// is not sorted: the search covers [0, lens[b]) only.
// Grid: (row blocks of kTinyRowsPerBlock rows, C).
__global__ void __launch_bounds__(kThreads)
tiny_lookup_kernel(const int32_t* __restrict__ values, const uint8_t* __restrict__ valid,
                   const int32_t* __restrict__ keys, const int32_t* __restrict__ codes,
                   const int32_t* __restrict__ lens, const int32_t* __restrict__ sel,
                   const int32_t* __restrict__ col_off, int32_t* __restrict__ out,
                   int64_t n, int vmax, Epilogue e) {
  __shared__ int32_t s_keys[kTinyMax];
  __shared__ int32_t s_codes[kTinyMax];
  const int c = blockIdx.y;
  const int b = sel[c];
  const int len = lens[b];
  const int32_t* k = keys + static_cast<int64_t>(b) * vmax;
  const int32_t* cd = codes + static_cast<int64_t>(b) * vmax;
  for (int j = threadIdx.x; j < len; j += blockDim.x) {
    s_keys[j] = k[j];
    s_codes[j] = cd[j];
  }
  __syncthreads();
  const int32_t off = col_off[c];
  const int64_t base = static_cast<int64_t>(c) * n;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kTinyRowsPerBlock;
  const int64_t stop = start + kTinyRowsPerBlock < n ? start + kTinyRowsPerBlock : n;
  for (int64_t r = start + threadIdx.x; r < stop; r += blockDim.x) {
    const int64_t i = base + r;
    const int32_t v = values[i];
    int lo = 0, hi = len;  // first slot whose key is >= v
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_keys[mid] < v) lo = mid + 1; else hi = mid;
    }
    const bool hit = lo < len && s_keys[lo] == v;
    out[i] = epilogue(hit ? s_codes[lo] : 0, hit, v, c, valid, i, off, e);
  }
}

// K2: direct (dense) map. Replaces BatchedDirect.encode_dev
// (nvtabular_tpu/ops/lookup.py:585-601), which on the TPU gathers an 8-lane
// row and selects a lane; here one 4-byte load per value.
//
// Bound: bytes. Values and codes stream (8 B per value); each table read is
// one random 32-byte sector unless L2 (50 MB) holds it. One thread per value.
// v - min is computed in int64: in int32 it overflows for keys far from min.
// The hit test uses v itself, so the codes equal the reference's.
// Grid: (ceil(N / kThreads), C).
__global__ void __launch_bounds__(kThreads)
direct_lookup_kernel(const int32_t* __restrict__ values, const uint8_t* __restrict__ valid,
                     const int32_t* __restrict__ table, const int32_t* __restrict__ mins,
                     const int32_t* __restrict__ maxs, const int64_t* __restrict__ lens,
                     const int64_t* __restrict__ table_off, const int32_t* __restrict__ sel,
                     const int32_t* __restrict__ col_off, int32_t* __restrict__ out, int64_t n,
                     Epilogue e) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int c = blockIdx.y;
  const int b = sel[c];
  const int64_t i = static_cast<int64_t>(c) * n + r;
  const int32_t v = values[i];
  const int32_t mn = mins[b];
  const int32_t mx = maxs[b];
  int64_t idx = static_cast<int64_t>(v) - mn;
  idx = idx < 0 ? 0 : (idx > lens[b] - 1 ? lens[b] - 1 : idx);
  const int32_t code = __ldg(table + table_off[b] + idx);
  const bool hit = v >= mn && v <= mx && code >= 0;
  out[i] = epilogue(code, hit, v, c, valid, i, col_off[c], e);
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
// (nvtabular_tpu/ops/lookup.py:693-708).
//
// Bound: bytes, dominated by two random 32-byte buckets per value from a
// table of ~200 MB at the Criteo-TB profile (four times L2). A bucket row
// [k0..k3, v0..v3] is exactly one 32-byte sector, read as two aligned int4
// loads; both buckets' loads are issued before any compare so their
// latencies overlap. One thread per value.
// Buckets: b = fmix32(u32(v) ^ seed) % nbs[b] + row_off[b], seeds 0 and
// 0x9E3779B9, all in uint32 as in the reference.
// Grid: (ceil(N / kThreads), C).
__global__ void __launch_bounds__(kThreads)
cuckoo_lookup_kernel(const int32_t* __restrict__ values, const uint8_t* __restrict__ valid,
                     const int4* __restrict__ table, const int64_t* __restrict__ nbs,
                     const int64_t* __restrict__ row_off, const int32_t* __restrict__ sel,
                     const int32_t* __restrict__ col_off, int32_t* __restrict__ out, int64_t n,
                     Epilogue e) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int c = blockIdx.y;
  const int b = sel[c];
  const int64_t i = static_cast<int64_t>(c) * n + r;
  const int32_t v = values[i];
  const uint32_t u = static_cast<uint32_t>(v);
  const uint32_t nb = static_cast<uint32_t>(nbs[b]);
  const int64_t ro = row_off[b];
  const int64_t b0 = ro + nvt::fmix32(u) % nb;
  const int64_t b1 = ro + nvt::fmix32(u ^ 0x9E3779B9u) % nb;
  const int4 k0 = __ldg(table + 2 * b0);
  const int4 v0 = __ldg(table + 2 * b0 + 1);
  const int4 k1 = __ldg(table + 2 * b1);
  const int4 v1 = __ldg(table + 2 * b1 + 1);
  int32_t code = 0;
  bool hit = false;
  probe(k0, v0, v, code, hit);
  probe(k1, v1, v, code, hit);
  out[i] = epilogue(code, hit, v, c, valid, i, col_off[c], e);
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

inline unsigned int blocks_for(int64_t n, int64_t per_block) {
  return static_cast<unsigned int>((n + per_block - 1) / per_block);
}

}  // namespace

extern "C" int nvt_tiny_lookup(const int32_t* values, const uint8_t* valid, const int32_t* keys,
                               const int32_t* codes, const int32_t* lens, const int32_t* sel,
                               const int32_t* col_off, int32_t* out, int num_cols, int64_t n,
                               int vmax, int miss, int null_code, const int32_t* nbuckets,
                               void* stream) {
  if (vmax > kTinyMax) return static_cast<int>(cudaErrorInvalidValue);
  if (num_cols == 0 || n == 0) return 0;
  dim3 grid(blocks_for(n, kTinyRowsPerBlock), num_cols);
  tiny_lookup_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      values, valid, keys, codes, lens, sel, col_off, out, n, vmax, Epilogue{miss, null_code, nbuckets});
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nvt_direct_lookup(const int32_t* values, const uint8_t* valid, const int32_t* table,
                                 const int32_t* mins, const int32_t* maxs, const int64_t* lens,
                                 const int64_t* table_off, const int32_t* sel,
                                 const int32_t* col_off, int32_t* out, int num_cols, int64_t n,
                                 int miss, int null_code, const int32_t* nbuckets, void* stream) {
  if (num_cols == 0 || n == 0) return 0;
  dim3 grid(blocks_for(n, kThreads), num_cols);
  direct_lookup_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      values, valid, table, mins, maxs, lens, table_off, sel, col_off, out, n,
      Epilogue{miss, null_code, nbuckets});
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nvt_cuckoo_lookup(const int32_t* values, const uint8_t* valid, const int32_t* table,
                                 const int64_t* nbs, const int64_t* row_off, const int32_t* sel,
                                 const int32_t* col_off, int32_t* out, int num_cols, int64_t n,
                                 int miss, int null_code, const int32_t* nbuckets, void* stream) {
  if (num_cols == 0 || n == 0) return 0;
  dim3 grid(blocks_for(n, kThreads), num_cols);
  cuckoo_lookup_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      values, valid, reinterpret_cast<const int4*>(table), nbs, row_off, sel, col_off, out, n,
      Epilogue{miss, null_code, nbuckets});
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
