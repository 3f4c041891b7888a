// The exchange sort of the sharded vocabulary count for Hopper (sm_90a):
// kernel K15a.
//
// Replaces the per-device body of exchange_and_sort in
// nvtabular_tpu/parallel/sharded_vocab.py:98-121 (the owner hash _mix32 at
// :33-42), which the mesh fit runs once per column:
//
//   routing  owner = fmix32(key) % ndev (uint32 arithmetic), a pad
//            (INT32_MAX) owned by device 0; a key's rank is the number of
//            earlier rows with the same owner (pads count too, as the
//            reference's one-hot cumsum counts them); a key at rank < cap
//            goes to send[owner, rank], a key at rank >= cap is dropped and
//            counted as overflow, a pad is dropped; the rest of the [ndev,
//            cap] send buffer holds pads.
//   sorting  jnp.sort of the [ndev * cap] keys an owner receives from the
//            all_to_all (:118): pads sort last.
//
// Both are one stable counting pass over buckets: the owner for routing,
// an 8-bit digit for each of the four passes of an LSD radix sort of the
// keys with their sign bit flipped. A pass is three launches:
//
//   hist     each warp counts its tile of kTile keys (in row order) per
//            bucket in shared memory: hist[bucket][tile];
//   scan     one block per bucket turns its row of hist into exclusive
//            prefixes over the tiles, and writes the bucket's total; the
//            sort adds a one-block launch that turns the totals into each
//            digit's start in the output;
//   scatter  each warp walks its tile 32 keys at a time, in row order: the
//            lanes holding one bucket find each other with
//            __match_any_sync, a key's rank is the bucket's running count
//            in shared memory plus the lanes of its bucket below it, and
//            the lowest of those lanes advances the count.
//
// So every rank is the stable rank in row order, never an atomic's order:
// the send buffer and the sorted keys equal the reference's bit for bit,
// overflow included.
//
// Bound: bytes. Routing reads the keys twice (hist, scatter) and writes the
// send buffer; each radix pass reads its input twice and writes it once.
// The counts in shared memory keep the per-key work off device memory.

#include <cuda_runtime.h>
#include <cstdint>

#include "hash.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 1024;  // keys a warp owns (kernels/exchange.py TILE)
constexpr int kScanThreads = 1024;
constexpr int32_t kPad = 0x7fffffff;  // sharded_vocab.py:31, _PAD
constexpr int kRadixBuckets = 256;

struct RouteBucket {
  uint32_t ndev;
  __device__ __forceinline__ int operator()(int32_t k) const {
    return k == kPad ? 0 : static_cast<int>(nvt::fmix32(static_cast<uint32_t>(k)) % ndev);
  }
};

struct DigitBucket {
  int shift;
  __device__ __forceinline__ int operator()(int32_t k) const {
    return static_cast<int>(((static_cast<uint32_t>(k) ^ 0x80000000u) >> shift) & 0xFFu);
  }
};

__global__ void fill_kernel(int32_t* __restrict__ out, int64_t count, int32_t value) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < count;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    out[i] = value;
}

// hist[b * ntiles + tile] = the keys of `tile` in bucket b.
template <class Bucket>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const int32_t* __restrict__ keys, int64_t n, int nbuckets, int64_t ntiles, Bucket bucket,
            int32_t* __restrict__ hist) {
  extern __shared__ int32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (tile >= ntiles) return;  // whole warps only; no block-wide barrier follows
  int32_t* counts = smem + warp * nbuckets;
  for (int b = lane; b < nbuckets; b += 32) counts[b] = 0;
  __syncwarp();
  const int64_t lo = tile * kTile;
  const int64_t hi = lo + kTile < n ? lo + kTile : n;
  for (int64_t i = lo + lane; i < hi; i += 32) atomicAdd(&counts[bucket(keys[i])], 1);
  __syncwarp();
  for (int b = lane; b < nbuckets; b += 32) hist[static_cast<int64_t>(b) * ntiles + tile] = counts[b];
}

// Exclusive scan of one bucket's row hist[b, :ntiles] in place; totals[b]
// = its sum. One block of kScanThreads per bucket.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(int32_t* __restrict__ hist, int64_t ntiles, int32_t* __restrict__ totals) {
  __shared__ int32_t warp_sums[kScanThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int32_t* row = hist + static_cast<int64_t>(blockIdx.x) * ntiles;
  int32_t carry = 0;
  for (int64_t start = 0; start < ntiles; start += kScanThreads) {
    const int64_t i = start + threadIdx.x;
    const int32_t v = i < ntiles ? row[i] : 0;
    int32_t x = v;  // inclusive scan within the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {  // inclusive scan of the warps' sums
      int32_t s = warp_sums[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int32_t y = __shfl_up_sync(0xffffffffu, s, d);
        if (lane >= d) s += y;
      }
      warp_sums[lane] = s;
    }
    __syncthreads();
    if (i < ntiles) row[i] = carry + (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
    carry += warp_sums[kScanThreads / 32 - 1];
    __syncthreads();  // warp_sums is rewritten by the next chunk
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// totals → each digit's first output position (exclusive scan of 256).
__global__ void digit_base_kernel(int32_t* __restrict__ totals) {
  __shared__ int32_t s[kRadixBuckets];
  s[threadIdx.x] = totals[threadIdx.x];
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t acc = 0;
    for (int b = 0; b < kRadixBuckets; ++b) {
      const int32_t t = s[b];
      s[b] = acc;
      acc += t;
    }
  }
  __syncthreads();
  totals[threadIdx.x] = s[threadIdx.x];
}

// kRoute: out[b * cap + rank] = key for a non-pad key at rank < cap, and
// overflow += the non-pad keys at rank >= cap. Otherwise out[base[b] +
// rank] = key.
template <class Bucket, bool kRoute>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const int32_t* __restrict__ keys, int64_t n, int nbuckets, int64_t ntiles, Bucket bucket,
               const int32_t* __restrict__ hist, const int32_t* __restrict__ base, int64_t cap,
               int32_t* __restrict__ out, int32_t* __restrict__ overflow) {
  extern __shared__ int32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (tile >= ntiles) return;  // whole warps only
  int32_t* running = smem + warp * nbuckets;
  for (int b = lane; b < nbuckets; b += 32)
    running[b] = hist[static_cast<int64_t>(b) * ntiles + tile] + (kRoute ? 0 : base[b]);
  __syncwarp();
  const unsigned below = (1u << lane) - 1u;
  const int64_t lo = tile * kTile;
  const int64_t hi = lo + kTile < n ? lo + kTile : n;
  int32_t dropped = 0;
  for (int64_t chunk = lo; chunk < hi; chunk += 32) {
    const int64_t i = chunk + lane;
    const bool valid = i < hi;
    const int32_t k = valid ? keys[i] : 0;
    const int b = valid ? bucket(k) : -1;  // -1 matches no bucket
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    const int32_t rank = valid ? running[b] + __popc(peers & below) : 0;
    __syncwarp();  // every lane has read its bucket's count
    if (valid && lane == __ffs(peers) - 1) running[b] += __popc(peers);
    __syncwarp();
    if (!valid) continue;
    if constexpr (kRoute) {
      if (k == kPad) continue;
      if (rank < cap) out[static_cast<int64_t>(b) * cap + rank] = k;
      else ++dropped;
    } else {
      out[rank] = k;
    }
  }
  if constexpr (kRoute) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) dropped += __shfl_down_sync(0xffffffffu, dropped, d);
    if (lane == 0 && dropped) atomicAdd(overflow, dropped);
  }
}

template <class Bucket, bool kRoute>
cudaError_t counting_pass(const int32_t* keys, int64_t n, int nbuckets, Bucket bucket, int32_t* hist,
                          int32_t* totals, int64_t cap, int32_t* out, int32_t* overflow, cudaStream_t stream) {
  const int64_t ntiles = (n + kTile - 1) / kTile;
  const unsigned blocks = static_cast<unsigned>((ntiles + kWarps - 1) / kWarps);
  const size_t smem = static_cast<size_t>(kWarps) * nbuckets * sizeof(int32_t);
  hist_kernel<Bucket><<<blocks, kThreads, smem, stream>>>(keys, n, nbuckets, ntiles, bucket, hist);
  scan_kernel<<<nbuckets, kScanThreads, 0, stream>>>(hist, ntiles, totals);
  if (!kRoute) digit_base_kernel<<<1, kRadixBuckets, 0, stream>>>(totals);
  scatter_kernel<Bucket, kRoute><<<blocks, kThreads, smem, stream>>>(
      keys, n, nbuckets, ntiles, bucket, hist, totals, cap, out, overflow);
  return cudaGetLastError();
}

unsigned fill_blocks(int64_t count) {
  const int64_t blocks = (count + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < 4096 ? (blocks > 0 ? blocks : 1) : 4096);
}

}  // namespace

// keys int32 [n] → send int32 [ndev, cap], overflow int32 [1]. Scratch:
// hist int32 [ndev * ceil(n / kTile)], totals int32 [ndev]. ndev <= 1024
// (the wrapper checks it: kWarps * ndev counts in shared memory).
extern "C" int nvt_exchange_route(const int32_t* keys, int64_t n, int ndev, int64_t cap, int32_t* hist,
                                  int32_t* totals, int32_t* send, int32_t* overflow, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  fill_kernel<<<fill_blocks(static_cast<int64_t>(ndev) * cap), kThreads, 0, stream>>>(
      send, static_cast<int64_t>(ndev) * cap, kPad);
  fill_kernel<<<1, kThreads, 0, stream>>>(overflow, 1, 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  return static_cast<int>(counting_pass<RouteBucket, true>(
      keys, n, ndev, RouteBucket{static_cast<uint32_t>(ndev)}, hist, totals, cap, send, overflow, stream));
}

// keys int32 [n] → out int32 [n] ascending (signed order). Scratch: tmp
// int32 [n], hist int32 [256 * ceil(n / kTile)], totals int32 [256]. Four
// passes of 8 bits: keys → tmp → out → tmp → out.
extern "C" int nvt_radix_sort_i32(const int32_t* keys, int64_t n, int32_t* tmp, int32_t* out, int32_t* hist,
                                  int32_t* totals, void* stream_ptr) {
  if (n == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int32_t* src[4] = {keys, tmp, out, tmp};
  int32_t* dst[4] = {tmp, out, tmp, out};
  for (int pass = 0; pass < 4; ++pass) {
    const cudaError_t err = counting_pass<DigitBucket, false>(
        src[pass], n, kRadixBuckets, DigitBucket{8 * pass}, hist, totals, 0, dst[pass], nullptr, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
