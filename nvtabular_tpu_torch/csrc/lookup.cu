// Column-batched Categorify lookups for Hopper (sm_90a): kernels K1-K3 and K8
// with the Categorify epilogue K4 fused into each.
//
// K1-K3 read the stacked int32 values of C columns ([C, N], row-major), K8
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

// K8: sorted float vocabularies. Replaces the searchsorted branch of
// _Vocab.encode_device (nvtabular_tpu/ops/categorify.py:570-585), which XLA
// lowers to a loop of gathers over one column's sorted float32 keys.
//
// One thread per value runs a lower-bound search over its column's keys
// [starts[b], starts[b] + lens[b]) of the concatenated table: the first key
// >= v (float compares, so -0.0 and 0.0 find the same key), a hit when that
// key equals v. An empty vocabulary takes the OOV code with no search; a NaN
// or invalid row takes the null code whatever it would have found. XLA
// flushes subnormals to zero on the reference's device path, so a subnormal
// value searches as 0.0 (the table's keys are flushed when it is built); a
// missed value hashes its own bits, as the reference's bitcast does.
//
// Bound: bytes. Values and codes stream (8 B per value); the table is read
// where the searches land: at Criteo's float columns, ~126K keys a column
// (1 MB with their codes, ~13 MB for 13 columns), which L2 (50 MB) holds
// after the first touches. The ~17 probes a value are dependent loads, so a
// thread waits on L2 latency 17 times; the block is one column
// (blockIdx.y), so its threads share the first probes' sectors in L1, and
// the card keeps enough warps in flight to cover the rest. The hashed miss
// uses the float32 bits, as the reference's device hash does.
// Grid: (ceil(N / kThreads), C).
__global__ void __launch_bounds__(kThreads)
sorted_lookup_kernel(const float* __restrict__ values, const uint8_t* __restrict__ valid,
                     const float* __restrict__ keys, const int32_t* __restrict__ codes,
                     const int64_t* __restrict__ starts, const int64_t* __restrict__ lens,
                     const int32_t* __restrict__ sel, const int32_t* __restrict__ col_off,
                     int32_t* __restrict__ out, int64_t n, Epilogue e) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int c = blockIdx.y;
  const int64_t i = static_cast<int64_t>(c) * n + r;
  const float v = values[i];
  if (isnan(v) || (valid != nullptr && valid[i] == 0)) {
    out[i] = e.null + col_off[c];
    return;
  }
  const int b = sel[c];
  const float* k = keys + starts[b];
  const int64_t len = lens[b];
  const float x = fabsf(v) < kFloatMinNormal ? 0.0f : v;
  int64_t lo = 0, hi = len;  // first slot whose key is >= x
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(k + mid) < x) lo = mid + 1; else hi = mid;
  }
  int32_t code;
  if (lo < len && __ldg(k + lo) == x) {
    code = __ldg(codes + starts[b] + lo);
  } else {
    code = miss_code(__float_as_uint(v), 0u, c, e);
  }
  out[i] = code + col_off[c];
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

extern "C" int nvt_sorted_lookup(const float* values, const uint8_t* valid, const float* keys,
                                 const int32_t* codes, const int64_t* starts, const int64_t* lens,
                                 const int32_t* sel, const int32_t* col_off, int32_t* out, int num_cols,
                                 int64_t n, int miss, int null_code, const int32_t* nbuckets,
                                 void* stream) {
  if (num_cols == 0 || n == 0) return 0;
  dim3 grid(blocks_for(n, kThreads), num_cols);
  sorted_lookup_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      values, valid, keys, codes, starts, lens, sel, col_off, out, n, Epilogue{miss, null_code, nbuckets});
  return static_cast<int>(cudaGetLastError());
}
