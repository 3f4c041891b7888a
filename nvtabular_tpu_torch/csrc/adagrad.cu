// The training step's Adagrad update for Hopper (sm_90a): kernel K18.
//
// Replaces the optimizer update of the jitted JAX train step,
// nvtabular_tpu/models/training.py:25-26 (make_step_fns) and 69-70
// (make_chunk_train_fn's scan body) and nvtabular_tpu/parallel/train.py:55-56
// (make_train_step): optax.adagrad(lr), i.e. scale_by_rss then the learning
// rate and apply_updates, which XLA fuses into one elementwise pass a
// parameter. For each element of every tensor the optimizer holds:
//
//   s = g * g + acc;  scale = s > 0 ? rsqrt(s + EPS) : 0;
//   p = p + (-lr) * (scale * g);  acc = s
//
// rounded as the plain PyTorch step (kernels/adagrad.py
// adagrad_update_plain: addcmul_, add, rsqrt_, masked_fill_, mul_, add_ with
// alpha) rounds on the card, so that the two agree bit for bit:
// s = fma(g, g, acc), scale = rsqrtf(fl(s + EPS)) with EPS = 1e-7 rounded to
// float32, u = fl(scale * g), p = fma(-lr, u, p) with -lr rounded to
// float32: ATen's addcmul and add(alpha) compile to multiply-adds, and its
// rsqrt to rsqrtf (tests/test_torch_gpu.py holds the kernel bit for bit
// against the plain version on the card; a separate multiply and add for s
// or p, or a correctly rounded square root, differ in the last bit). A NaN
// s gives scale 0, and 0 * inf stays NaN, as in the plain step.
//
// The zero skip. The gradient of an embedding table is dense and mostly
// zero: a DLRM step at batch 65,536 writes at most 65,536 x 26 of the
// 22,343,004 Criteo rows. For g = +0.0 the rule leaves p and acc as they
// are (0 * 0 + acc == acc; (-lr) * (scale * +0) is -0.0, or NaN where scale
// is; p + -0.0 == p for every p, -0.0 included), so a unit of four floats
// whose gradient bits are all zero is neither read nor written beyond g.
// The test is on the bits: for g = -0.0 the plain step turns p = -0.0 into
// +0.0, so such a unit is computed. A skipped unit keeps the bits it had
// where the plain step's add would rewrite them to an equal value: a NaN's
// payload (the card's adds give the canonical NaN), and an accumulator of
// -0.0 (+0 + -0 is +0.0). No optimizer step makes either: an accumulator
// starts at 0.1 and never falls.
//
// Layout: one launch updates up to kMaxSegments tensors (segments), given
// by value in a __grid_constant__ table: their p, acc and g pointers and
// lengths, and the flat 64-bit prefix of their 4-float units (ceil(n / 4)
// a segment, every segment nonempty), which the host plans
// (kernels/adagrad.py adagrad_plan) and the entry point checks. A
// persistent grid walks chunks of kUpdateThreads x kUnits units; thread t of
// a chunk takes units t, t + kUpdateThreads, .. (neighbouring threads on
// neighbouring 16-byte vectors), finds the first one's segment by a binary
// search over the prefix and the next ones' by walking forward. A thread
// first loads the g of all its units with streaming loads (read once,
// evict first), then issues the p and acc loads of all its nonzero units
// before it uses any of them, then computes and stores. The touched rows
// lie scattered through the table, so those loads are latency-bound: what
// keeps the card busy is the number of loads in flight on an SM, and one
// unit a thread (32 registers, 2,048 threads an SM) keeps more than 2 or 4
// units a thread (51 or 83 registers: kernel_ab.py's adagrad case on
// `.%kUnits=2` and `.%kUnits=4`). A
// unit of a segment whose three pointers are 16-byte aligned, with four
// floats, moves as float4; a unit of an unaligned segment, and a
// segment's last unit of 1-3 floats, move float by float. Indexes are
// unsigned 64-bit: the tables of a sharded or multihot configuration pass
// 2^31 floats.
//
// Bound: bytes. The update reads g in full and, for each element of a
// nonzero unit, reads and writes p and acc (16 B); a few flops an element,
// far below the float32 rate. At the Criteo table [22343004, 16] that is
// 1.43 GB of g and at most 1,703,936 rows x 64 B x 4.

#include <cuda_runtime.h>
#include <cstdint>

#include "chunks.cuh"

namespace {

constexpr int kMaxSegments = 64;
constexpr int kUpdateThreads = 256;
constexpr int kUnits = 1;  // units of 4 floats a thread takes at once
constexpr uint64_t kChunk = static_cast<uint64_t>(kUpdateThreads) * kUnits;
constexpr float kEps = 1e-7f;  // optax.adagrad's eps, inside the square root

struct Segments {
  float* p[kMaxSegments];
  float* acc[kMaxSegments];
  const float* g[kMaxSegments];
  uint64_t n[kMaxSegments];              // floats, >= 1
  uint64_t start[kMaxSegments + 1];      // the prefix of ceil(n / 4) units
  unsigned char vec[kMaxSegments];       // p, acc and g 16-byte aligned
};

__device__ __forceinline__ void step(float& p, float& acc, float g, float neg_lr) {
  const float s = __fmaf_rn(g, g, acc);
  const float scale = s > 0.0f ? rsqrtf(__fadd_rn(s, kEps)) : 0.0f;
  p = __fmaf_rn(neg_lr, __fmul_rn(scale, g), p);
  acc = s;
}

__device__ __forceinline__ bool all_zero_bits(const float4& v) {
  return (__float_as_uint(v.x) | __float_as_uint(v.y) | __float_as_uint(v.z) | __float_as_uint(v.w)) == 0u;
}

// The segment of unit u: the last k with start[k] <= u.
__device__ __forceinline__ int segment_of(const Segments& s, int m, uint64_t u) {
  int lo = 0, hi = m - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (s.start[mid] <= u) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// The cnt (1-4) floats at q as a float4, lanes past cnt zero: one float4
// access when whole, else one a float.
template <bool kStream>
__device__ __forceinline__ float4 load_unit(const float* q, int cnt, bool whole) {
  if (whole) return kStream ? __ldcs(reinterpret_cast<const float4*>(q)) : *reinterpret_cast<const float4*>(q);
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  v.x = kStream ? __ldcs(q) : q[0];
  if (cnt > 1) v.y = kStream ? __ldcs(q + 1) : q[1];
  if (cnt > 2) v.z = kStream ? __ldcs(q + 2) : q[2];
  if (cnt > 3) v.w = kStream ? __ldcs(q + 3) : q[3];
  return v;
}

__device__ __forceinline__ void store_unit(float* q, const float4& v, int cnt, bool whole) {
  if (whole) {
    *reinterpret_cast<float4*>(q) = v;
    return;
  }
  q[0] = v.x;
  if (cnt > 1) q[1] = v.y;
  if (cnt > 2) q[2] = v.z;
  if (cnt > 3) q[3] = v.w;
}

__global__ void __launch_bounds__(kUpdateThreads)
adagrad_kernel(const __grid_constant__ Segments s, int m, uint64_t total, float neg_lr) {
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * kChunk;
  for (uint64_t base = static_cast<uint64_t>(blockIdx.x) * kChunk; base < total; base += stride) {
    const uint64_t u0 = base + threadIdx.x;
    if (u0 >= total) break;  // no barrier: a thread's units all lie past u0
    int k = segment_of(s, m, u0);
    int seg[kUnits], cnt[kUnits];  // cnt 0: past the end, or all-zero gradient bits
    uint64_t off[kUnits];          // the unit's first float in its segment
    float4 g[kUnits];
#pragma unroll
    for (int j = 0; j < kUnits; ++j) {
      const uint64_t u = u0 + static_cast<uint64_t>(j) * kUpdateThreads;
      cnt[j] = 0;
      seg[j] = k;
      off[j] = 0;
      if (u < total) {
        while (k + 1 < m && s.start[k + 1] <= u) ++k;
        seg[j] = k;
        off[j] = (u - s.start[k]) * 4;
        const uint64_t left = s.n[k] - off[j];
        const int c = left < 4 ? static_cast<int>(left) : 4;
        g[j] = load_unit<true>(s.g[k] + off[j], c, c == 4 && s.vec[k]);
        cnt[j] = all_zero_bits(g[j]) ? 0 : c;
      }
    }
    float4 p[kUnits], a[kUnits];
#pragma unroll
    for (int j = 0; j < kUnits; ++j) {
      if (cnt[j]) {
        const bool whole = cnt[j] == 4 && s.vec[seg[j]];
        p[j] = load_unit<false>(s.p[seg[j]] + off[j], cnt[j], whole);
        a[j] = load_unit<false>(s.acc[seg[j]] + off[j], cnt[j], whole);
      }
    }
#pragma unroll
    for (int j = 0; j < kUnits; ++j) {
      if (cnt[j]) {
        step(p[j].x, a[j].x, g[j].x, neg_lr);
        step(p[j].y, a[j].y, g[j].y, neg_lr);
        step(p[j].z, a[j].z, g[j].z, neg_lr);
        step(p[j].w, a[j].w, g[j].w, neg_lr);
        const bool whole = cnt[j] == 4 && s.vec[seg[j]];
        store_unit(s.p[seg[j]] + off[j], p[j], cnt[j], whole);
        store_unit(s.acc[seg[j]] + off[j], a[j], cnt[j], whole);
      }
    }
  }
}

bool aligned(const void* q, unsigned bytes) { return reinterpret_cast<uintptr_t>(q) % bytes == 0; }

}  // namespace

// One launch over m (1 to kMaxSegments) tensors: p, acc and g their
// pointers (float32, 4-byte aligned, none null), n their lengths (>= 1
// floats), start the prefix of their 4-float units (m + 1 entries: 0, then
// start[k] + ceil(n[k] / 4)), lr the learning rate. p and acc are updated
// in place.
extern "C" int nvt_adagrad_update(float* const* p, float* const* acc, const float* const* g, const int64_t* n,
                                  const uint64_t* start, int m, double lr, void* stream) {
  if (m < 1 || m > kMaxSegments || start[0] != 0) return static_cast<int>(cudaErrorInvalidValue);
  Segments s;
  s.start[0] = 0;
  for (int k = 0; k < m; ++k) {
    if (n[k] < 1 || !p[k] || !acc[k] || !g[k] || !aligned(p[k], 4) || !aligned(acc[k], 4) || !aligned(g[k], 4))
      return static_cast<int>(cudaErrorInvalidValue);
    const uint64_t len = static_cast<uint64_t>(n[k]);
    if (start[k + 1] < start[k] || start[k + 1] - start[k] != (len + 3) / 4)
      return static_cast<int>(cudaErrorInvalidValue);
    s.p[k] = p[k];
    s.acc[k] = acc[k];
    s.g[k] = g[k];
    s.n[k] = len;
    s.start[k + 1] = start[k + 1];
    s.vec[k] = aligned(p[k], 16) && aligned(acc[k], 16) && aligned(g[k], 16);
  }
  const uint64_t total = start[m];
  static nvt::ResidentCache cache;
  const uint64_t chunks = (total + kChunk - 1) / kChunk;
  unsigned blocks = 0;
  if (int rc = nvt::cached_resident_blocks(cache, adagrad_kernel, kUpdateThreads, 0,
                                           chunks > INT64_MAX ? INT64_MAX : static_cast<int64_t>(chunks), &blocks))
    return rc;
  adagrad_kernel<<<blocks, kUpdateThreads, 0, static_cast<cudaStream_t>(stream)>>>(s, m, total,
                                                                            -static_cast<float>(lr));
  return static_cast<int>(cudaGetLastError());
}
