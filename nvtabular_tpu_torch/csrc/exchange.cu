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
// Routing is one stable counting pass over the owners, three launches:
//
//   hist     each warp counts its tile of kTile keys (in row order) per
//            owner in shared memory: hist[owner][tile];
//   scan     one block per owner turns its row of hist into exclusive
//            prefixes over the tiles;
//   scatter  each warp walks its tile 32 keys at a time, in row order: the
//            lanes holding one owner find each other with __match_any_sync,
//            a key's rank is the owner's running count in shared memory plus
//            the lanes of its owner below it.
//
// So every rank is the stable rank in row order, never an atomic's order:
// the send buffer equals the reference's bit for bit, overflow included.
//
// Sorting is an LSD radix sort of the keys with their sign bit flipped, in
// onesweep form (one read and one write of the keys a pass):
//
//   histogram  one launch reads the keys once and counts the digit of every
//              pass (8-bit digits, 4 passes) in shared memory, kHistItems
//              loads in flight a thread;
//   scan       one block turns the counts into each pass's digit starts and
//              marks a pass trivial where one digit holds every key (a
//              stable pass over it moves nothing: it is skipped, and the
//              passes that run alternate between tmp and out so that the
//              last writes out);
//   pass       one launch a pass. A block takes the next tile id from a
//              counter (never blockIdx: a block waits only on tiles handed
//              out before its own, so the look-back always progresses),
//              loads kSortItems keys a thread and ranks them by digit in
//              shared memory in key order (a warp's lanes of one digit find
//              each other with one ballot a digit bit). It publishes its
//              per-digit counts in a status word per (tile, digit), marked
//              aggregate, then walks back over the earlier tiles' words,
//              kLookback at a time, to its exclusive prefix and publishes the
//              inclusive one. It writes its keys into shared memory in digit
//              order, then out: consecutive threads write consecutive
//              addresses of a digit's run.
//
// A status word is 32 bits: 2 flag bits and a 30-bit count, so a sort takes
// at most kMaxSortKeys keys (the wrapper refuses more). The caller zeroes the
// scratch (counts, tile counters, status words) on the stream before the
// launches.
//
// Bound: bytes: each pass reads and writes the keys once, with coalesced
// writes, and the histogram adds one read for all passes (the design it
// replaced, four launches a pass, read the keys twice a pass and scattered
// from a warp walking 32 keys, lanes of different digits writing far
// apart). What is left is latency: a tile's ranking, look-back and write
// run one after the other, so a pass is held to kSortMinBlocks blocks an SM
// (85 registers a thread) to keep more tiles in flight.

#include <cuda_runtime.h>
#include <cstdint>

#include "hash.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 1024;  // keys a warp owns in routing (kernels/exchange.py TILE)
constexpr int kScanThreads = 1024;
constexpr int32_t kPad = 0x7fffffff;  // sharded_vocab.py:31, _PAD

struct RouteBucket {
  uint32_t ndev;
  __device__ __forceinline__ int operator()(int32_t k) const {
    return k == kPad ? 0 : static_cast<int>(nvt::fmix32(static_cast<uint32_t>(k)) % ndev);
  }
};

__global__ void fill_kernel(int32_t* __restrict__ out, int64_t count, int32_t value) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < count;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    out[i] = value;
}

// hist[b * ntiles + tile] = the keys of `tile` owned by b.
__global__ void __launch_bounds__(kThreads)
route_hist_kernel(const int32_t* __restrict__ keys, int64_t n, int nbuckets, int64_t ntiles, RouteBucket bucket,
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

// Exclusive scan of one owner's row hist[b, :ntiles] in place. One block of
// kScanThreads per owner.
__global__ void __launch_bounds__(kScanThreads)
route_scan_kernel(int32_t* __restrict__ hist, int64_t ntiles) {
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
}

// send[b * cap + rank] = key for a non-pad key at rank < cap; overflow +=
// the non-pad keys at rank >= cap.
__global__ void __launch_bounds__(kThreads)
route_scatter_kernel(const int32_t* __restrict__ keys, int64_t n, int nbuckets, int64_t ntiles, RouteBucket bucket,
                     const int32_t* __restrict__ hist, int64_t cap, int32_t* __restrict__ out,
                     int32_t* __restrict__ overflow) {
  extern __shared__ int32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (tile >= ntiles) return;  // whole warps only
  int32_t* running = smem + warp * nbuckets;
  for (int b = lane; b < nbuckets; b += 32) running[b] = hist[static_cast<int64_t>(b) * ntiles + tile];
  __syncwarp();
  const unsigned below = (1u << lane) - 1u;
  const int64_t lo = tile * kTile;
  const int64_t hi = lo + kTile < n ? lo + kTile : n;
  int32_t dropped = 0;
  for (int64_t chunk = lo; chunk < hi; chunk += 32) {
    const int64_t i = chunk + lane;
    const bool valid = i < hi;
    const int32_t k = valid ? keys[i] : 0;
    const int b = valid ? bucket(k) : -1;  // -1 matches no owner
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    const int32_t rank = valid ? running[b] + __popc(peers & below) : 0;
    __syncwarp();  // every lane has read its owner's count
    if (valid && lane == __ffs(peers) - 1) running[b] += __popc(peers);
    __syncwarp();
    if (!valid || k == kPad) continue;
    if (rank < cap) out[static_cast<int64_t>(b) * cap + rank] = k;
    else ++dropped;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) dropped += __shfl_down_sync(0xffffffffu, dropped, d);
  if (lane == 0 && dropped) atomicAdd(overflow, dropped);
}

unsigned fill_blocks(int64_t count) {
  const int64_t blocks = (count + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < 4096 ? (blocks > 0 ? blocks : 1) : 4096);
}

// --- the onesweep radix sort ---------------------------------------------------

constexpr int kSortItems = 15;                  // keys a thread ranks
constexpr int kSortTile = kThreads * kSortItems;  // keys a block sorts: 3,840
constexpr int kLookback = 8;                    // earlier tiles' status words a look-back step reads at once
constexpr int kHistItems = 8;                   // keys a thread of the histogram loads at once
constexpr int kSortMinBlocks = 3;               // blocks of a pass an SM holds: at most 85 registers a thread
constexpr int64_t kMaxSortKeys = (1 << 30) - 1;  // a status word's count (kernels/exchange.py SORT_MAX_KEYS)
constexpr uint32_t kFlagAggregate = 1u << 30;
constexpr uint32_t kFlagPrefix = 2u << 30;
constexpr uint32_t kCountMask = (1u << 30) - 1u;
constexpr int kHistBlocks = 132 * 4;

constexpr int kDigitBits = 8;  // 4 passes (11-bit digits in 3 passes measured slower: PERF.md)
constexpr int kDigits = 1 << kDigitBits;
constexpr int kPasses = 32 / kDigitBits;
constexpr int kDigitsPerThread = kDigits / kThreads;  // digits a thread scans and looks back for
static_assert(kDigitsPerThread >= 1 && kDigits % kThreads == 0, "a digit count that is a multiple of the block");

__device__ __forceinline__ int digit(uint32_t u, int pass) {
  return static_cast<int>((u >> (pass * kDigitBits)) & (kDigits - 1));
}

// The scratch of one sort, in int32 words: counts [kPasses][kDigits],
// starts [kPasses][kDigits], meta [2 * kPasses + 1] (a pass's trivial flag
// and the count of passes run before it, then the count of passes run),
// tile counters [kPasses], status [kPasses][ntiles][kDigits].
struct SortScratch {
  uint32_t* counts;
  uint32_t* starts;
  int32_t* meta;
  uint32_t* tile_counter;
  uint32_t* status;
};

int64_t sort_scratch_words(int64_t ntiles) {
  return 2LL * kPasses * kDigits + 2 * kPasses + 1 + kPasses + static_cast<int64_t>(kPasses) * ntiles * kDigits;
}

SortScratch sort_scratch(int32_t* base) {
  SortScratch s;
  s.counts = reinterpret_cast<uint32_t*>(base);
  s.starts = s.counts + kPasses * kDigits;
  s.meta = reinterpret_cast<int32_t*>(s.starts + kPasses * kDigits);
  s.tile_counter = reinterpret_cast<uint32_t*>(s.meta + 2 * kPasses + 1);
  s.status = s.tile_counter + kPasses;
  return s;
}

__device__ __forceinline__ uint32_t load_relaxed(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// The lanes of the warp whose digit equals this lane's: one
// ballot a bit (__match_any_sync is several times slower).
__device__ __forceinline__ unsigned match_digit(int d) {
  unsigned peers = 0xffffffffu;
#pragma unroll
  for (int b = 0; b < kDigitBits; ++b) {
    const bool set = (d >> b) & 1;
    const unsigned ones = __ballot_sync(0xffffffffu, set);
    peers &= set ? ones : ~ones;
  }
  return peers;
}

// Exclusive scan of one value a thread over the block; *total = the sum.
// Every thread of the block calls it.
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v, uint32_t* warp_sums, uint32_t* total) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  uint32_t before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t s = warp_sums[w];
    before += w < warp ? s : 0;
    all += s;
  }
  __syncthreads();  // warp_sums may be reused by the caller's next scan
  *total = all;
  return before + x - v;
}

// counts[pass][digit] += the keys with that digit, for every pass. A
// thread loads kHistItems keys at once (kHistItems loads in flight), then
// adds each to the shared counts: the card serves a warp's atomics on one
// address (a run of pads) faster than __match_any_sync would group them.
__global__ void __launch_bounds__(kThreads)
sort_hist_kernel(const int32_t* __restrict__ keys, int64_t n, uint32_t* __restrict__ counts) {
  __shared__ uint32_t s[kPasses * kDigits];
  for (int i = threadIdx.x; i < kPasses * kDigits; i += kThreads) s[i] = 0;
  __syncthreads();
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads * kHistItems; base < n;
       base += static_cast<int64_t>(gridDim.x) * kThreads * kHistItems) {
    uint32_t u[kHistItems];
#pragma unroll
    for (int j = 0; j < kHistItems; ++j) {
      const int64_t i = base + j * kThreads + threadIdx.x;
      u[j] = i < n ? static_cast<uint32_t>(keys[i]) ^ 0x80000000u : 0u;
    }
#pragma unroll
    for (int j = 0; j < kHistItems; ++j) {
      if (base + j * kThreads + threadIdx.x >= n) break;
#pragma unroll
      for (int p = 0; p < kPasses; ++p) atomicAdd(&s[p * kDigits + digit(u[j], p)], 1u);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kPasses * kDigits; i += kThreads)
    if (s[i]) atomicAdd(&counts[i], s[i]);
}

// starts[pass] = the exclusive scan of counts[pass]; meta as SortScratch
// says. One block.
__global__ void __launch_bounds__(kThreads)
sort_scan_kernel(int64_t n, SortScratch s) {
  __shared__ uint32_t warp_sums[kWarps];
  __shared__ int trivial[kPasses];
  if (threadIdx.x < kPasses) trivial[threadIdx.x] = 0;
  __syncthreads();
  for (int p = 0; p < kPasses; ++p) {
    const uint32_t* c = s.counts + p * kDigits + threadIdx.x * kDigitsPerThread;
    uint32_t mine = 0;
#pragma unroll
    for (int j = 0; j < kDigitsPerThread; ++j) {
      mine += c[j];
      if (c[j] == static_cast<uint32_t>(n)) trivial[p] = 1;
    }
    uint32_t total;
    uint32_t run = block_exclusive_scan(mine, warp_sums, &total);
    uint32_t* st = s.starts + p * kDigits + threadIdx.x * kDigitsPerThread;
#pragma unroll
    for (int j = 0; j < kDigitsPerThread; ++j) {
      st[j] = run;
      run += c[j];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int p = 0; p < kPasses; ++p) {
      s.meta[2 * p] = trivial[p];
      s.meta[2 * p + 1] = run;
      run += trivial[p] ? 0 : 1;
    }
    s.meta[2 * kPasses] = run;
  }
}

// Shared memory of one pass: each warp's digit counts, the tile's keys in
// digit order, and each digit's output offset.
constexpr size_t sort_pass_smem() {
  return (static_cast<size_t>(kWarps) * kDigits + kSortTile + kDigits) * 4;
}

__global__ void __launch_bounds__(kThreads, kSortMinBlocks)
sort_pass_kernel(const int32_t* __restrict__ keys, int32_t* __restrict__ tmp, int32_t* __restrict__ out, int64_t n,
                 int64_t ntiles, int pass, SortScratch s) {
  constexpr int D = kDigits;
  extern __shared__ int32_t smem[];
  uint32_t* warp_counts = reinterpret_cast<uint32_t*>(smem);     // [kWarps][D]
  uint32_t* tile_keys = warp_counts + kWarps * D;                // [kSortTile], sign-flipped
  int32_t* goff = reinterpret_cast<int32_t*>(tile_keys + kSortTile);  // [D]
  __shared__ uint32_t warp_sums[kWarps];
  __shared__ uint32_t s_tile;

  const int ran = s.meta[2 * kPasses];
  if (s.meta[2 * pass]) {
    // one digit holds every key: the pass moves nothing. Where no pass runs
    // at all (every key equal), the last one copies the keys to out.
    if (pass == kPasses - 1 && ran == 0)
      for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
           i += static_cast<int64_t>(gridDim.x) * kThreads)
        out[i] = keys[i];
    return;
  }
  const int before = s.meta[2 * pass + 1];
  int32_t* dst = ((ran - 1 - before) & 1) ? tmp : out;  // the last pass run writes out
  const int32_t* src = before == 0 ? keys : (dst == out ? tmp : out);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) s_tile = atomicAdd(s.tile_counter + pass, 1u);
  for (int i = threadIdx.x; i < kWarps * D; i += kThreads) warp_counts[i] = 0;
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t tile_base = tile * kSortTile;
  const int tile_n = static_cast<int>(n - tile_base < kSortTile ? n - tile_base : kSortTile);

  // a warp owns kSortItems * 32 consecutive keys of the tile, loaded 32 at a time
  uint32_t u[kSortItems];
  uint32_t rank[kSortItems];
  const int wpos = warp * kSortItems * 32 + lane;
#pragma unroll
  for (int i = 0; i < kSortItems; ++i) {
    const int pos = wpos + i * 32;
    u[i] = pos < tile_n ? static_cast<uint32_t>(src[tile_base + pos]) ^ 0x80000000u : 0u;
  }
  // rank each key among the warp's earlier keys of its digit
  uint32_t* wc = warp_counts + warp * D;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < kSortItems; ++i) {
    const bool valid = wpos + i * 32 < tile_n;
    const int d = digit(u[i], pass);
    const unsigned peers = match_digit(d) & __ballot_sync(0xffffffffu, valid);
    const int leader = __ffs(peers) - 1;
    uint32_t old = 0;
    if (valid && lane == leader) old = atomicAdd(wc + d, static_cast<uint32_t>(__popc(peers)));
    rank[i] = __shfl_sync(0xffffffffu, old, valid ? leader : lane) + __popc(peers & below);
  }
  __syncthreads();

  // per digit: each warp's first rank among the tile's keys of the digit,
  // and the tile's count of the digit, published at once
  uint32_t count[kDigitsPerThread];
  uint32_t* my_status = s.status + (static_cast<int64_t>(pass) * ntiles + tile) * D;
#pragma unroll
  for (int j = 0; j < kDigitsPerThread; ++j) {
    const int d = threadIdx.x * kDigitsPerThread + j;
    uint32_t run = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t c = warp_counts[w * D + d];
      warp_counts[w * D + d] = run;
      run += c;
    }
    count[j] = run;
    store_relaxed(my_status + d, (tile == 0 ? kFlagPrefix : kFlagAggregate) | run);
  }
  uint32_t mine = 0;
#pragma unroll
  for (int j = 0; j < kDigitsPerThread; ++j) mine += count[j];
  uint32_t total;
  uint32_t local = block_exclusive_scan(mine, warp_sums, &total);  // the digit's first position in the tile
#pragma unroll
  for (int j = 0; j < kDigitsPerThread; ++j) {
    const int d = threadIdx.x * kDigitsPerThread + j;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) warp_counts[w * D + d] += local;
    goff[d] = static_cast<int32_t>(s.starts[pass * D + d] - local);
    local += count[j];
  }
  __syncthreads();

  // the tile's keys into shared memory in digit order
#pragma unroll
  for (int i = 0; i < kSortItems; ++i) {
    if (wpos + i * 32 < tile_n) tile_keys[warp_counts[warp * D + digit(u[i], pass)] + rank[i]] = u[i];
  }

  // look back over the earlier tiles for each digit's exclusive prefix
  if (tile > 0) {
#pragma unroll
    for (int j = 0; j < kDigitsPerThread; ++j) {
      const int d = threadIdx.x * kDigitsPerThread + j;
      // kLookback earlier words are read at once; a word not yet published
      // is read again until it is (tile 0 always holds a prefix)
      const uint32_t* col = s.status + static_cast<int64_t>(pass) * ntiles * D + d;
      uint32_t excl = 0;
      bool found = false;
      for (int64_t t = tile - 1; !found; t -= kLookback) {
        uint32_t word[kLookback];
#pragma unroll
        for (int q = 0; q < kLookback; ++q) word[q] = t - q >= 0 ? load_relaxed(col + (t - q) * D) : kFlagPrefix;
#pragma unroll
        for (int q = 0; q < kLookback; ++q) {
          if (found) break;
          while ((word[q] & ~kCountMask) == 0) word[q] = load_relaxed(col + (t - q) * D);
          excl += word[q] & kCountMask;
          found = (word[q] & kFlagPrefix) != 0;
        }
      }
      store_relaxed(my_status + d, kFlagPrefix | (excl + count[j]));
      goff[d] += static_cast<int32_t>(excl);
    }
  }
  __syncthreads();

  // out: position p of the tile goes to its digit's start + the earlier
  // tiles' keys of the digit + its rank within the tile's run
  for (int p = threadIdx.x; p < tile_n; p += kThreads) {
    const uint32_t v = tile_keys[p];
    dst[goff[digit(v, pass)] + p] = static_cast<int32_t>(v ^ 0x80000000u);
  }
}

cudaError_t radix_sort(const int32_t* keys, int64_t n, int32_t* tmp, int32_t* out, int32_t* scratch,
                       cudaStream_t stream) {
  const int64_t ntiles = (n + kSortTile - 1) / kSortTile;
  const SortScratch s = sort_scratch(scratch);
  const int64_t hist_blocks = (n + kThreads * kHistItems - 1) / (kThreads * kHistItems);
  sort_hist_kernel<<<static_cast<unsigned>(hist_blocks < kHistBlocks ? hist_blocks : kHistBlocks), kThreads, 0,
                     stream>>>(keys, n, s.counts);
  sort_scan_kernel<<<1, kThreads, 0, stream>>>(n, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t smem = sort_pass_smem();
  static_assert(smem <= 48 * 1024, "a pass's shared memory within the default 48 KB");
  for (int pass = 0; pass < kPasses; ++pass) {
    sort_pass_kernel<<<static_cast<unsigned>(ntiles), kThreads, smem, stream>>>(keys, tmp, out, n, ntiles, pass, s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// keys int32 [n] → send int32 [ndev, cap], overflow int32 [1]. Scratch:
// hist int32 [ndev * ceil(n / kTile)]. ndev <= 1024 (the wrapper checks
// it: kWarps * ndev counts in shared memory).
extern "C" int nvt_exchange_route(const int32_t* keys, int64_t n, int ndev, int64_t cap, int32_t* hist,
                                  int32_t* send, int32_t* overflow, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  fill_kernel<<<fill_blocks(static_cast<int64_t>(ndev) * cap), kThreads, 0, stream>>>(
      send, static_cast<int64_t>(ndev) * cap, kPad);
  fill_kernel<<<1, kThreads, 0, stream>>>(overflow, 1, 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  const RouteBucket bucket{static_cast<uint32_t>(ndev)};
  const int64_t ntiles = (n + kTile - 1) / kTile;
  const unsigned blocks = static_cast<unsigned>((ntiles + kWarps - 1) / kWarps);
  const size_t smem = static_cast<size_t>(kWarps) * ndev * sizeof(int32_t);
  route_hist_kernel<<<blocks, kThreads, smem, stream>>>(keys, n, ndev, ntiles, bucket, hist);
  route_scan_kernel<<<ndev, kScanThreads, 0, stream>>>(hist, ntiles);
  route_scatter_kernel<<<blocks, kThreads, smem, stream>>>(keys, n, ndev, ntiles, bucket, hist, cap, send, overflow);
  return static_cast<int>(cudaGetLastError());
}

// The int32 words of zeroed scratch a sort of n keys needs.
extern "C" int64_t nvt_radix_sort_scratch_words(int64_t n) {
  return sort_scratch_words((n + kSortTile - 1) / kSortTile);
}

// keys int32 [n] → out int32 [n] ascending (signed order), 0 < n <=
// kMaxSortKeys. tmp int32 [n]; scratch: nvt_radix_sort_scratch_words(n)
// int32 words, zeroed on the stream before this call.
extern "C" int nvt_radix_sort_i32(const int32_t* keys, int64_t n, int32_t* tmp, int32_t* out, int32_t* scratch,
                                  void* stream_ptr) {
  if (n < 0 || n > kMaxSortKeys) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  return static_cast<int>(radix_sort(keys, n, tmp, out, scratch, static_cast<cudaStream_t>(stream_ptr)));
}
