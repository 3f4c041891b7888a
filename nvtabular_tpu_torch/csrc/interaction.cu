// DLRM dot interaction and its gradient for Hopper (sm_90a): kernel K13b.
//
// Replaces nvtabular_tpu/models/layers.py:97-117 (dot_product_interaction):
// the batched [B, F, D] x [B, D, F] dot_general, then the gather of the
// strict lower triangle in np.tril_indices(F, -1) order (flat index
// rows * F + cols, pair k = i * (i - 1) / 2 + j for i > j), and the
// transpose XLA derives for it. With self_mode (self_interaction=True) the
// triangle keeps its diagonal, np.tril_indices(F, 0): P = F (F + 1) / 2
// pairs, k = i * (i + 1) / 2 + j for i >= j; the mode is a template
// parameter, so the strict kernels compile as they would without it. DLRM
// concatenates the bottom output in front of the result
// (nvtabular_tpu/models/dlrm.py:135); the forward writes straight into that
// [B, D + P] buffer through a row stride.
//
// Both kernels run a persistent grid (as many blocks as the card holds at
// once, each walking groups of G samples) and stage a group's rows in
// shared memory by bulk copies of the tensor memory accelerator, which
// complete on an mbarrier: the 16-byte-aligned body of a row goes by one
// bulk copy, its first and last 0-3 floats by 4-byte cp.async. Two stages
// where they fit, so that the next group's copies run while this group
// computes, else one; the forward also takes one where two would leave an
// SM few warps (phase 22's [4, 64]: 3 warps, against 6 blocks of one warp
// with one stage each). The host's plan (kernels/interaction.py) picks G,
// the block's threads and the stages.
//
// nvt_interaction_fwd: out[b, k] = sum_d X[b, i, d] * X[b, j, d] for the
// P pairs only (not the F x F product). The triangle is cut into tiles of
// 4 rows i x 4 rows j, T = nb (nb + 1) / 2 of them (nb = ceil(F / 4)); a
// diagonal tile keeps i > j, or i >= j in the self mode. A thread takes a
// tile of one sample and keeps its 16 sums in registers: a step reads the
// 8 rows' float4 chunk of d (C = 4; one float where D % 4 != 0 or x is not
// 16-byte aligned) and does 64 fmaf, over d in order, so each pair's sum is
// the plain version's fmaf steps. Thread t = slot * G + s takes sample s:
// the 8 lanes of a quarter-warp read 8 samples' slots, whose stride in
// 16-byte units is odd, so 8 distinct groups of banks. A thread's tiles
// are slot, slot + S, ... (S = threads / G), walked in the triangle's
// order with no division. The sums land in the sample's output slot, at a
// pad that puts the 16-byte-aligned body of its destination row on a
// 16-byte boundary, and leave by one bulk store a sample; the 0-3 floats
// at each end by 4-byte stores (DLRM's [B, D + P] rows are only 4-byte
// aligned).
//
// nvt_interaction_bwd: dX[b, i, d] = sum_{j != i} g[b, pair(i, j)] X[b, j, d]
// (pair(i, j) = pair(j, i), both of X's operands being X); in self_mode the
// diagonal pair adds 2 g[b, pair(i, i)] X[b, i, d], its product's two
// factors both being X[b, i]. Blocks of kBwdThreads (two an SM at DLRM's
// [27, 16]) walk groups of G samples (16 there); a stage holds a group's X
// rows and gradient rows (rows of DLRM's [B, D + P] buffer). A thread keeps
// the sums of kBwdRows rows and C = 4 columns (1 where D % 4 != 0) of one
// sample in registers, over j in order with fmaf, so one float4 read of an
// x_j chunk serves 8 rows (X is read ceil(F / 8) times a sample, not F
// times). The weights' addresses follow from j's range, so that no step
// chooses one: below the rows w(i, j) sits at row_base(i) + j (8 steps at a
// time, unrolled: a pointer a row plus a constant), in the diagonal block
// (unrolled) each row's form is known at compile time, and above the rows
// it sits at row_base(j) + i. The sums go back into the stage's X slots and
// leave by one bulk store a sample. Where a sample's items (row blocks x
// column chunks) outnumber the block's threads, a group is one sample, a
// thread takes items t, t + kBwdThreads, ... and stores each item's sums
// to dx directly.
//
// Where one stage of one sample passes the 227 KB a block can opt into (at
// [120, 1024] a sample's X alone is 480 KB), both directions take a
// streamed path of their own, with the same sums in the same order: the
// forward's block takes a sample and stages its rows in chunks of Dc columns
// (the host's plan), a thread's 4 x 4 pair tile keeping its sums in
// registers across the chunks, so each pair's fmaf steps run over d in
// order (a sample's tiles past the block's threads take further rounds,
// each streaming the chunks again), and the sums go to the output row
// directly; the backward's block takes a sample and kStreamCols columns, a
// thread kBwdRows rows of one column, and streams x_j's columns and the rows'
// weights w(i, j) in chunks of kStreamRows steps j, in order (a sample's row
// blocks past the block's warps take further rounds).
//
// The plain versions (kernels/interaction.py) compute the same fmaf steps
// in the same order, each exactly (the product and the sum in float64,
// rounded once to float32), so a model step through the kernels and
// through the plain versions sees the same float32 values before its
// bfloat16 casts, where a last-bit difference would become a bfloat16 step.
//
// Bound: bytes. The forward reads X (F * D * 4 B a sample) and writes P * 4
// B; its 2 * P * D flops a sample are ~1/6 of the byte time at the float32
// rate without tensor cores, and its shared-memory reads half a float a
// fmaf. The backward reads X and g and writes dX; its F (F - 1) D fmaf a
// sample take about a quarter of the byte time, which the double-buffered
// staging overlaps with the next group's copies.

#include <cuda_runtime.h>
#include <cstdint>

#include "chunks.cuh"

namespace {

constexpr int kFwdMaxThreads = 256;     // the forward's block, at most
constexpr int kFwdTile = 4;             // rows i and rows j of a forward tile
constexpr int kBwdThreads = 256;        // the backward's persistent block
constexpr int kBwdRows = 8;             // rows of a sample a backward thread sums
constexpr int kSmemOptIn = 227 * 1024;  // the shared memory an H100 block can opt into

// The pair index of the triangle's row i: i (i - 1) / 2, or i (i + 1) / 2
// with the diagonal.
__host__ __device__ __forceinline__ int row_base(int i, int self_mode) {
  return self_mode ? i * (i + 1) / 2 : i * (i - 1) / 2;
}

__host__ __device__ __forceinline__ int num_pairs(int F, int self_mode) { return row_base(F, self_mode); }

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

// A row of n floats at src (4-byte aligned): `head` floats up to the first
// 16-byte boundary, a body of a multiple of 4 floats, then the rest; the
// row sits in its slot at `pad` floats, so that its body is 16-byte
// aligned there too.
struct RowSplit {
  int head, body, pad;
  __device__ __forceinline__ RowSplit(const float* src, int n) {
    const int h = static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15) / 4);
    head = h < n ? h : n;
    body = (n - head) & ~3;
    pad = (4 - head) & 3;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\tmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\tselp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One row into its slot: the body by one bulk copy of the tensor memory
// accelerator, counted on `bar`; the head and the rest by 4-byte cp.async.
__device__ __forceinline__ void stage_row(float* slot, const float* src, int n, uint64_t* bar) {
  const RowSplit r(src, n);
  float* dst = slot + r.pad;
  for (int e = 0; e < r.head; ++e) cp_async4(dst + e, src + e);
  if (r.body)
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
                 ::"r"(smem_addr(dst + r.head)), "l"(src + r.head), "r"(4 * r.body), "r"(smem_addr(bar))
                 : "memory");
  for (int e = r.head + r.body; e < n; ++e) cp_async4(dst + e, src + e);
}

// --- the forward -----------------------------------------------------------------------

// A slot of n floats at a pad of up to 3, in an odd number of 16-byte units.
__host__ __device__ __forceinline__ int odd_slot(int n) {
  const int units = (n + 3 + 3) / 4;
  return 4 * (units % 2 ? units : units + 1);
}

// A forward stage: G X slots of F * D floats, then G output slots of P.
__host__ __device__ __forceinline__ int64_t fwd_stage_floats(int F, int D, int G, int self_mode) {
  return static_cast<int64_t>(G) * (odd_slot(F * D) + odd_slot(num_pairs(F, self_mode)));
}

// Warp 0 stages group grp's X rows into `stage` (lane l the samples l, l +
// 32, ...): lane 0 arms `bar` with the bodies' bytes before any copy goes
// out; the heads and rests are each lane's cp.async group.
__device__ __forceinline__ void stage_fwd_group(const float* __restrict__ x, int64_t B, int F, int D, int G,
                                                int xs, int64_t grp, float* stage, uint64_t* bar) {
  const int64_t b0 = grp * G;
  const int ns = static_cast<int>(B - b0 < G ? B - b0 : G);
  const int lane = threadIdx.x;
  const int n = F * D;
  int bytes = 0;
  for (int s = lane; s < ns; s += 32) bytes += 4 * RowSplit(x + (b0 + s) * n, n).body;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) bytes += __shfl_xor_sync(0xffffffffu, bytes, o);
  if (lane == 0)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes)
                 : "memory");
  __syncwarp();
  for (int s = lane; s < ns; s += 32) stage_row(stage + s * xs, x + (b0 + s) * n, n, bar);
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// The next tile of the triangle n tiles on: tile (I, J), J <= I, row by row.
__device__ __forceinline__ void tile_advance(int n, int& I, int& J) {
  J += n;
  while (J > I) {
    J -= I + 1;
    ++I;
  }
}

// One tile of one sample: rows i = 4 I + r and j = 4 J + q (clamped to F - 1
// for the reads; those pairs are not kept), each pair's sum over d in order.
template <int C>
__device__ __forceinline__ void fwd_tile_sums(const float* __restrict__ xb, int F, int D, int I, int J,
                                              float (&acc)[kFwdTile][kFwdTile]) {
  const float* ri[kFwdTile];
  const float* rj[kFwdTile];
#pragma unroll
  for (int r = 0; r < kFwdTile; ++r) {
    const int i = kFwdTile * I + r, j = kFwdTile * J + r;
    ri[r] = xb + (i < F ? i : F - 1) * D;
    rj[r] = xb + (j < F ? j : F - 1) * D;
  }
#pragma unroll
  for (int r = 0; r < kFwdTile; ++r)
#pragma unroll
    for (int q = 0; q < kFwdTile; ++q) acc[r][q] = 0.0f;
  if constexpr (C == 4) {
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 a[kFwdTile], b[kFwdTile];
#pragma unroll
      for (int r = 0; r < kFwdTile; ++r) a[r] = *reinterpret_cast<const float4*>(ri[r] + d);
#pragma unroll
      for (int q = 0; q < kFwdTile; ++q) b[q] = *reinterpret_cast<const float4*>(rj[q] + d);
#pragma unroll
      for (int r = 0; r < kFwdTile; ++r)
#pragma unroll
        for (int q = 0; q < kFwdTile; ++q) {
          float t = fmaf(a[r].x, b[q].x, acc[r][q]);
          t = fmaf(a[r].y, b[q].y, t);
          t = fmaf(a[r].z, b[q].z, t);
          acc[r][q] = fmaf(a[r].w, b[q].w, t);
        }
    }
  } else {
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[kFwdTile], b[kFwdTile];
#pragma unroll
      for (int r = 0; r < kFwdTile; ++r) a[r] = ri[r][d];
#pragma unroll
      for (int q = 0; q < kFwdTile; ++q) b[q] = rj[q][d];
#pragma unroll
      for (int r = 0; r < kFwdTile; ++r)
#pragma unroll
        for (int q = 0; q < kFwdTile; ++q) acc[r][q] = fmaf(a[r], b[q], acc[r][q]);
    }
  }
}

// The tile's kept pairs into the sample's output slot, at pair k.
template <int SELF>
__device__ __forceinline__ void fwd_tile_store(float* __restrict__ ob, int F, int I, int J,
                                               const float (&acc)[kFwdTile][kFwdTile]) {
#pragma unroll
  for (int r = 0; r < kFwdTile; ++r) {
    const int i = kFwdTile * I + r;
    if (i >= F) break;
    float* o = ob + row_base(i, SELF) + kFwdTile * J;
#pragma unroll
    for (int q = 0; q < kFwdTile; ++q) {
      if (I == J && (SELF ? q > r : q >= r)) continue;
      o[q] = acc[r][q];
    }
  }
}

// One group a turn: wait for its stage, the tiles' sums into the output
// slots, then a bulk store of each sample's body and 4-byte stores of its
// ends; the next group's copies go out at the turn's start (two stages) or
// once this stage's X rows are read (one).
template <int C, int SELF>
__global__ void __launch_bounds__(kFwdMaxThreads, 2)
interaction_fwd_kernel(const float* __restrict__ x, int64_t B, int F, int D, int G, int stages,
                       float* __restrict__ out, int64_t out_row_stride) {
  extern __shared__ float4 smem4[];
  __shared__ uint64_t bars[2];  // the bulk copies of each stage
  float* smem = reinterpret_cast<float*>(smem4);
  const int P = num_pairs(F, SELF);
  const int xs = odd_slot(F * D), os = odd_slot(P);
  const int stage_floats = static_cast<int>(fwd_stage_floats(F, D, G, SELF));
  const int nb = (F + kFwdTile - 1) / kFwdTile;
  const int S = blockDim.x / G;  // tile slots a sample
  const int s = threadIdx.x % G, slot = threadIdx.x / G;
  const int64_t groups = (B + G - 1) / G;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&bars[0])) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&bars[1])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  int64_t grp = blockIdx.x;
  if (threadIdx.x < 32) {
    stage_fwd_group(x, B, F, D, G, xs, grp, smem, &bars[0]);
    asm volatile("cp.async.wait_group 0;" ::: "memory");
  }
  __syncthreads();
  for (int iter = 0; grp < groups; grp += gridDim.x, ++iter) {
    const int buf = stages == 2 ? iter & 1 : 0;
    const int64_t next = grp + gridDim.x;
    if (stages == 2 && threadIdx.x < 32 && next < groups)
      stage_fwd_group(x, B, F, D, G, xs, next, smem + (buf ^ 1) * stage_floats, &bars[buf ^ 1]);
    mbar_wait(&bars[buf], stages == 2 ? (iter >> 1) & 1 : iter & 1);
    float* xst = smem + buf * stage_floats;
    float* ost = xst + G * xs;
    const int64_t b0 = grp * G;
    const int ns = static_cast<int>(B - b0 < G ? B - b0 : G);
    if (s < ns) {
      const int n = F * D;
      const float* xb = xst + s * xs + RowSplit(x + (b0 + s) * n, n).pad;
      float* ob = ost + s * os + RowSplit(out + (b0 + s) * out_row_stride, P).pad;
      int I = 0, J = 0;
      tile_advance(slot, I, J);
      for (; I < nb; tile_advance(S, I, J)) {
        float acc[kFwdTile][kFwdTile];
        fwd_tile_sums<C>(xb, F, D, I, J, acc);
        fwd_tile_store<SELF>(ob, F, I, J, acc);
      }
    }
    // the sums' generic writes come before the bulk stores' reads, and the
    // X rows' reads before the bulk copies that refill the stage
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (stages == 1 && threadIdx.x < 32 && next < groups) {
      if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      __syncwarp();
      stage_fwd_group(x, B, F, D, G, xs, next, smem, &bars[0]);
    }
    for (int t = threadIdx.x; t < ns; t += blockDim.x) {  // each row's ends
      float* dst = out + (b0 + t) * out_row_stride;
      const RowSplit r(dst, P);
      const float* src = ost + t * os + r.pad;
      for (int e = 0; e < r.head; ++e) dst[e] = src[e];
      for (int e = r.head + r.body; e < P; ++e) dst[e] = src[e];
    }
    if (threadIdx.x == 0) {  // each row's body a bulk store
      for (int t = 0; t < ns; ++t) {
        float* dst = out + (b0 + t) * out_row_stride;
        const RowSplit r(dst, P);
        if (r.body)
          asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                       ::"l"(dst + r.head), "r"(smem_addr(ost + t * os + r.pad + r.head)), "r"(4 * r.body)
                       : "memory");
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      // the stores of the group before have read their stage, which the next turn's sums overwrite
      if (stages == 2) asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      else asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
    if (threadIdx.x < 32) asm volatile("cp.async.wait_group 0;" ::: "memory");  // the next group's heads and rests
    __syncthreads();
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// --- the backward ----------------------------------------------------------------------

// A group's staging in shared memory: G samples' X rows, then their P
// gradient values, each row in a 16-byte-aligned slot at a pad of 0-3 floats
// that puts the row's 16-byte-aligned body on a 16-byte boundary
// (RowSplit); a gradient slot keeps a float past the row for the reads of
// rows clamped to F - 1. A warp's lanes take the D / C column chunks of
// consecutive samples (the chunk fastest), so 8 lanes of a quarter-warp
// read x from ceil(8 / chunks) samples: an X slot's stride in 16-byte units
// is the chunks' count mod 8, which puts those reads in 8 distinct groups
// of banks. A weight read is one address a sample, a broadcast to its
// chunks' lanes; a gradient slot's odd stride in 16-byte units spreads 8
// samples over 8 groups of banks.
__host__ __device__ __forceinline__ int bwd_x_stride(int F, int D, int chunks) {
  int units = (F * D + 3 + 3) / 4;
  while ((units - chunks) % 8 != 0) ++units;
  return 4 * units;
}

__host__ __device__ __forceinline__ int bwd_g_stride(int F, int self_mode) {
  const int units = (num_pairs(F, self_mode) + 1 + 3 + 3) / 4;
  return 4 * (units % 2 ? units : units + 1);
}

__host__ __device__ __forceinline__ int64_t bwd_stage_floats(int F, int D, int C, int G, int self_mode) {
  return static_cast<int64_t>(G) * (bwd_x_stride(F, D, D / C) + bwd_g_stride(F, self_mode));
}

// Warp 0 stages group grp into `stage` (lane l the samples l, l + 32, ...):
// lane 0 arms `bar` with the bodies' bytes before any copy goes out; the
// heads and rests are each lane's cp.async group.
__device__ __forceinline__ void stage_bwd_group(const float* __restrict__ x, const float* __restrict__ g,
                                                int64_t g_row_stride, int64_t B, int F, int D, int G, int P,
                                                int xs, int gs, int64_t grp, float* stage, uint64_t* bar) {
  const int64_t b0 = grp * G;
  const int ns = static_cast<int>(B - b0 < G ? B - b0 : G);
  const int lane = threadIdx.x;
  int bytes = 0;
  for (int s = lane; s < ns; s += 32)
    bytes += 4 * (RowSplit(x + (b0 + s) * F * D, F * D).body + RowSplit(g + (b0 + s) * g_row_stride, P).body);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) bytes += __shfl_xor_sync(0xffffffffu, bytes, o);
  if (lane == 0)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes)
                 : "memory");
  __syncwarp();
  float* gst = stage + G * xs;
  for (int s = lane; s < ns; s += 32) {
    stage_row(stage + s * xs, x + (b0 + s) * F * D, F * D, bar);
    stage_row(gst + s * gs, g + (b0 + s) * g_row_stride, P, bar);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// x_j's C floats of a thread's columns: a float4 (C = 4) or a float.
template <int C>
__device__ __forceinline__ void load_chunk(const float* p, float (&v)[C]) {
  if constexpr (C == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = *p;
  }
}

// Step j's weights above the rows [i0, i0 + kBwdRows) (every row i < j:
// w(i, j) at row_base(j) + i, consecutive in i) and x_j's chunk.
template <int C, int SELF>
__device__ __forceinline__ void fetch_above(const float* xcol, int D, const float* gsamp, int i0, int j,
                                            float (&w)[kBwdRows], float (&v)[C]) {
  load_chunk<C>(xcol + j * D, v);
  const float* wj = gsamp + row_base(j, SELF) + i0;
#pragma unroll
  for (int r = 0; r < kBwdRows; ++r) w[r] = wj[r];
}

template <int C>
__device__ __forceinline__ void step_sums(const float (&w)[kBwdRows], const float (&v)[C],
                                          float (&acc)[kBwdRows][C]) {
#pragma unroll
  for (int r = 0; r < kBwdRows; ++r)
#pragma unroll
    for (int k = 0; k < C; ++k) acc[r][k] = fmaf(w[r], v[k], acc[r][k]);
}

// The steps below the rows, j < i0, kBwdRows at a time (i0 is a multiple
// of kBwdRows), unrolled: every row i > j, w(i, j) at row_base(i) + j, the
// row's pointer plus a constant offset.
template <int C>
__device__ __forceinline__ void below_sums(const float* xcol, int D, int i0, const float* const (&rows)[kBwdRows],
                                           float (&acc)[kBwdRows][C]) {
  for (int j0 = 0; j0 < i0; j0 += kBwdRows) {
#pragma unroll
    for (int d = 0; d < kBwdRows; ++d) {
      float w[kBwdRows], v[C];
      load_chunk<C>(xcol + (j0 + d) * D, v);
#pragma unroll
      for (int r = 0; r < kBwdRows; ++r) w[r] = rows[r][j0 + d];
      step_sums<C>(w, v, acc);
    }
  }
}

// The diagonal block's steps j = i0 + d, unrolled: row r takes w(i, j) at
// row_base(j) + i for r < d, 2 g_ii (self mode; the strict mode skips it) for
// r == d, and its own row's w(i, j) for r > d.
template <int C, int SELF>
__device__ __forceinline__ void diagonal_sums(const float* xcol, int D, const float* gsamp, int F, int i0,
                                              const float* const (&rows)[kBwdRows], float (&acc)[kBwdRows][C]) {
#pragma unroll
  for (int d = 0; d < kBwdRows; ++d) {
    const int j = i0 + d;
    if (j >= F) break;
    float v[C];
    load_chunk<C>(xcol + j * D, v);
    const float* wj = gsamp + row_base(j, SELF) + i0;
#pragma unroll
    for (int r = 0; r < kBwdRows; ++r) {
      if (r == d && !SELF) continue;
      const float w = r < d ? wj[r] : (r == d ? 2.0f * wj[r] : rows[r][j]);
#pragma unroll
      for (int k = 0; k < C; ++k) acc[r][k] = fmaf(w, v[k], acc[r][k]);
    }
  }
}

// The steps above the rows, [j0, F), in order: step j + 1's reads issued
// before step j's products, two steps a turn in two sets of registers.
template <int C, int SELF>
__device__ __forceinline__ void above_sums(const float* xcol, int D, const float* gsamp, int i0, int j0, int F,
                                           float (&acc)[kBwdRows][C]) {
  if (j0 >= F) return;
  float wa[kBwdRows], va[C], wb[kBwdRows], vb[C];
  fetch_above<C, SELF>(xcol, D, gsamp, i0, j0, wa, va);
  int j = j0;
  for (; j + 1 < F; j += 2) {
    fetch_above<C, SELF>(xcol, D, gsamp, i0, j + 1, wb, vb);
    step_sums<C>(wa, va, acc);
    fetch_above<C, SELF>(xcol, D, gsamp, i0, j + 2 < F ? j + 2 : j + 1, wa, va);
    step_sums<C>(wb, vb, acc);
  }
  if (j < F) step_sums<C>(wa, va, acc);
}

// A thread's work item: rows [i0, i0 + kBwdRows) (those below F) and C
// columns of one sample; each row's sums run over j in order with fmaf.
template <int C, int SELF>
__device__ __forceinline__ void bwd_sums(const float* __restrict__ xcol, int D, const float* __restrict__ gsamp,
                                         int F, int i0, float (&acc)[kBwdRows][C]) {
  const float* rows[kBwdRows];  // each row's weights below it; rows past F clamped to F - 1 (their sums are not kept)
#pragma unroll
  for (int r = 0; r < kBwdRows; ++r) rows[r] = gsamp + row_base(i0 + r < F ? i0 + r : F - 1, SELF);
#pragma unroll
  for (int r = 0; r < kBwdRows; ++r)
#pragma unroll
    for (int k = 0; k < C; ++k) acc[r][k] = 0.0f;
  below_sums<C>(xcol, D, i0, rows, acc);
  diagonal_sums<C, SELF>(xcol, D, gsamp, F, i0, rows, acc);
  above_sums<C, SELF>(xcol, D, gsamp, i0, i0 + kBwdRows, F, acc);
}

// One group a turn: the work items' sums over j, then dX. Where the items
// fit the block (G * items a sample <= kBwdThreads: one a thread), the sums
// go back into the X slots and leave by bulk stores (C = 4) or one float a
// thread; else (direct: one sample a group) each thread takes items t, t +
// kBwdThreads, ... and stores their sums to dx. The next group's copies go
// out at the turn's start (two stages) or once this stage is read (one).
template <int C, int SELF>
__global__ void __launch_bounds__(kBwdThreads, 2)
interaction_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g, int64_t g_row_stride, int64_t B,
                       int F, int D, int G, int stages, float* __restrict__ dx) {
  extern __shared__ float4 smem4[];
  __shared__ uint64_t bars[2];  // the bulk copies of each stage
  float* smem = reinterpret_cast<float*>(smem4);
  const int P = num_pairs(F, SELF);
  const int chunks = D / C;
  const int xs = bwd_x_stride(F, D, chunks), gs = bwd_g_stride(F, SELF);
  const int stage_floats = static_cast<int>(bwd_stage_floats(F, D, C, G, SELF));
  const int items = (F + kBwdRows - 1) / kBwdRows * G * chunks;  // row block, then sample, then chunk fastest
  const bool direct = items > kBwdThreads;
  const int n = F * D;
  const int64_t groups = (B + G - 1) / G;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&bars[0])) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&bars[1])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  int64_t grp = blockIdx.x;
  if (threadIdx.x < 32) {
    stage_bwd_group(x, g, g_row_stride, B, F, D, G, P, xs, gs, grp, smem, &bars[0]);
    asm volatile("cp.async.wait_group 0;" ::: "memory");
  }
  __syncthreads();
  for (int iter = 0; grp < groups; grp += gridDim.x, ++iter) {
    const int buf = stages == 2 ? iter & 1 : 0;
    const int64_t next = grp + gridDim.x;
    // the next group's copies go out before this group's are awaited, once
    // the bulk stores of the group before have read that stage
    if (stages == 2 && threadIdx.x < 32 && next < groups) {
      if constexpr (C == 4) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      stage_bwd_group(x, g, g_row_stride, B, F, D, G, P, xs, gs, next, smem + (buf ^ 1) * stage_floats,
                      &bars[buf ^ 1]);
    }
    mbar_wait(&bars[buf], stages == 2 ? (iter >> 1) & 1 : iter & 1);
    float* xst = smem + buf * stage_floats;
    const float* gst = xst + G * xs;
    const int64_t b0 = grp * G;
    const int ns = static_cast<int>(B - b0 < G ? B - b0 : G);
    float* out = dx + b0 * n;
    if (direct) {  // G == 1
      const float* xslot = xst + RowSplit(x + b0 * n, n).pad;
      const float* gsamp = gst + RowSplit(g + b0 * g_row_stride, P).pad;
      for (int it = threadIdx.x; it < items; it += kBwdThreads) {
        const int c = it % chunks, i0 = it / chunks * kBwdRows;
        float acc[kBwdRows][C];
        bwd_sums<C, SELF>(xslot + c * C, D, gsamp, F, i0, acc);
#pragma unroll
        for (int r = 0; r < kBwdRows; ++r) {
          if (i0 + r >= F) break;
          float* o = out + (i0 + r) * D + c * C;
          if constexpr (C == 4) {
            *reinterpret_cast<float4*>(o) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
          } else {
            *o = acc[r][0];
          }
        }
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the X rows' reads before their refill
    } else {
      const int it = threadIdx.x;
      const int c = it % chunks;
      const int blk = it / chunks / G;
      const int s = it / chunks - blk * G;
      const bool active = it < items && s < ns;
      float acc[kBwdRows][C];
      float* xslot = xst + s * xs;
      if (active) {
        xslot += RowSplit(x + (b0 + s) * n, n).pad;
        bwd_sums<C, SELF>(xslot + c * C, D, gst + s * gs + RowSplit(g + (b0 + s) * g_row_stride, P).pad, F,
                          blk * kBwdRows, acc);
      }
      __syncthreads();  // every thread is done reading the group's X rows, which the sums overwrite
      if (active) {
#pragma unroll
        for (int r = 0; r < kBwdRows; ++r) {
          if (blk * kBwdRows + r >= F) break;
          float* o = xslot + (blk * kBwdRows + r) * D + c * C;
          if constexpr (C == 4) {
            *reinterpret_cast<float4*>(o) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
          } else {
            *o = acc[r][0];
          }
        }
      }
      // the sums' generic writes come before the bulk stores' reads, and this
      // stage's reads before the bulk copies that refill it
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();  // the group's sums are in the X slots
      if constexpr (C == 4) {  // a sample's dX rows a bulk store
        if (threadIdx.x < 32) {
          for (int t = threadIdx.x; t < ns; t += 32)
            asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                         ::"l"(out + t * n), "r"(smem_addr(xst + t * xs)), "r"(4 * n) : "memory");
          asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        }
      } else {
        for (int e = threadIdx.x; e < ns * n; e += kBwdThreads) {
          const int t = e / n;
          out[e] = xst[t * xs + RowSplit(x + (b0 + t) * n, n).pad + (e - t * n)];
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      }
    }
    if (stages == 1 && next < groups) {  // refill the one stage once it is read
      __syncthreads();
      if (threadIdx.x < 32) {
        if constexpr (C == 4) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
        stage_bwd_group(x, g, g_row_stride, B, F, D, G, P, xs, gs, next, smem, &bars[0]);
      }
    }
    if (threadIdx.x < 32) asm volatile("cp.async.wait_group 0;" ::: "memory");  // the next group's heads and rests
    __syncthreads();
  }
  if (C == 4 && threadIdx.x < 32) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// --- the streamed paths (one sample past 227 KB) ---------------------------------------

constexpr int kStreamThreads = 256;  // both streamed kernels' block
constexpr int kStreamCols = 32;      // the backward's columns a block (a warp's lanes)
constexpr int kStreamRows = 64;      // the backward's steps j a chunk
constexpr int kStreamRowBlocks = kStreamThreads / kStreamCols;  // row blocks of kBwdRows a round

// A block a sample (samples strided by the grid): the sample's F rows in
// chunks of Dc columns in shared memory ([F][ld], ld = Dc | 1 floats: a
// warp's rows at one column in distinct banks); a thread a tile of 4 x 4
// rows a round, its sums over every chunk in d order, then the tile's kept
// pairs to the output row.
template <int SELF>
__global__ void __launch_bounds__(kStreamThreads)
interaction_fwd_stream_kernel(const float* __restrict__ x, int64_t B, int F, int D, int Dc,
                              float* __restrict__ out, int64_t out_row_stride) {
  extern __shared__ float xs[];
  const int ld = Dc | 1;
  const int nb = (F + kFwdTile - 1) / kFwdTile;
  const int tiles = nb * (nb + 1) / 2;
  for (int64_t b = blockIdx.x; b < B; b += gridDim.x) {
    const float* xb = x + b * F * D;
    float* ob = out + b * out_row_stride;
    for (int t0 = 0; t0 < tiles; t0 += kStreamThreads) {
      int I = 0, J = 0;
      tile_advance(t0 + threadIdx.x, I, J);
      const bool active = I < nb;
      int ri[kFwdTile], rj[kFwdTile];
#pragma unroll
      for (int r = 0; r < kFwdTile; ++r) {
        const int i = kFwdTile * I + r, j = kFwdTile * J + r;
        ri[r] = (i < F ? i : F - 1) * ld;
        rj[r] = (j < F ? j : F - 1) * ld;
      }
      float acc[kFwdTile][kFwdTile];
#pragma unroll
      for (int r = 0; r < kFwdTile; ++r)
#pragma unroll
        for (int q = 0; q < kFwdTile; ++q) acc[r][q] = 0.0f;
      for (int d0 = 0; d0 < D; d0 += Dc) {
        const int dc = D - d0 < Dc ? D - d0 : Dc;
        __syncthreads();  // the chunk before is read
        for (int e = threadIdx.x; e < F * dc; e += kStreamThreads) {
          const int r = e / dc;
          xs[r * ld + e - r * dc] = xb[static_cast<int64_t>(r) * D + d0 + e - r * dc];
        }
        __syncthreads();
        if (active) {
          for (int d = 0; d < dc; ++d) {
            float a[kFwdTile], c[kFwdTile];
#pragma unroll
            for (int r = 0; r < kFwdTile; ++r) {
              a[r] = xs[ri[r] + d];
              c[r] = xs[rj[r] + d];
            }
#pragma unroll
            for (int r = 0; r < kFwdTile; ++r)
#pragma unroll
              for (int q = 0; q < kFwdTile; ++q) acc[r][q] = fmaf(a[r], c[q], acc[r][q]);
          }
        }
      }
      if (active) fwd_tile_store<SELF>(ob, F, I, J, acc);
    }
  }
}

// The weight of step j for row i: g's pair (i, j) (either order), 2 g_ii on
// the self mode's diagonal.
template <int SELF>
__device__ __forceinline__ float pair_weight(const float* __restrict__ gb, int i, int j) {
  if (i == j) return SELF ? 2.0f * gb[row_base(i, SELF) + i] : 0.0f;
  return i > j ? gb[row_base(i, SELF) + j] : gb[row_base(j, SELF) + i];
}

// A block a (sample, kStreamCols columns) work item (items strided by the
// grid): a warp's lanes the columns, warp w the row blocks w, w +
// kStreamRowBlocks, .. (a round each); in a round the steps j stream in
// chunks of kStreamRows: x_j's columns and the round's rows' weights staged
// in shared memory, each row's sum over j in order with fmaf (the strict
// mode skips j == i, as the staged kernel does).
template <int SELF>
__global__ void __launch_bounds__(kStreamThreads)
interaction_bwd_stream_kernel(const float* __restrict__ x, const float* __restrict__ g, int64_t g_row_stride,
                              int64_t B, int F, int D, float* __restrict__ dx) {
  constexpr int kRoundRows = kStreamRowBlocks * kBwdRows;
  __shared__ float xs[kStreamRows][kStreamCols];
  __shared__ float ws[kRoundRows][kStreamRows + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ctiles = (D + kStreamCols - 1) / kStreamCols;
  const int nbi = (F + kBwdRows - 1) / kBwdRows;
  for (int64_t item = blockIdx.x; item < B * ctiles; item += gridDim.x) {
    const int64_t b = item / ctiles;
    const int d0 = static_cast<int>(item - b * ctiles) * kStreamCols;
    const int d = d0 + lane;
    const float* xb = x + b * F * D;
    const float* gb = g + b * g_row_stride;
    for (int rb0 = 0; rb0 < nbi; rb0 += kStreamRowBlocks) {
      const int i_base = rb0 * kBwdRows;
      const int i0 = i_base + warp * kBwdRows;
      float acc[kBwdRows];
#pragma unroll
      for (int r = 0; r < kBwdRows; ++r) acc[r] = 0.0f;
      for (int j0 = 0; j0 < F; j0 += kStreamRows) {
        const int jn = F - j0 < kStreamRows ? F - j0 : kStreamRows;
        __syncthreads();  // the chunk before is read
        for (int e = threadIdx.x; e < kStreamRows * kStreamCols; e += kStreamThreads) {
          const int jj = e / kStreamCols, c = e - jj * kStreamCols;
          xs[jj][c] = (jj < jn && d0 + c < D) ? xb[static_cast<int64_t>(j0 + jj) * D + d0 + c] : 0.0f;
        }
        for (int e = threadIdx.x; e < kRoundRows * kStreamRows; e += kStreamThreads) {
          const int ri = e / kStreamRows, jj = e - ri * kStreamRows;
          const int i = i_base + ri;
          ws[ri][jj] = (i < F && jj < jn) ? pair_weight<SELF>(gb, i, j0 + jj) : 0.0f;
        }
        __syncthreads();
        if (d < D && i0 < F) {
          for (int jj = 0; jj < jn; ++jj) {
            const float v = xs[jj][lane];
            const int j = j0 + jj;
#pragma unroll
            for (int r = 0; r < kBwdRows; ++r)
              if (SELF || i0 + r != j) acc[r] = fmaf(ws[warp * kBwdRows + r][jj], v, acc[r]);
          }
        }
      }
      if (d < D) {
#pragma unroll
        for (int r = 0; r < kBwdRows; ++r)
          if (i0 + r < F) dx[(b * F + i0 + r) * D + d] = acc[r];
      }
    }
  }
}

bool bad_shape(int64_t B, int F, int D, int G, int stages, int self_mode) {
  return B < 0 || F < (self_mode ? 1 : 2) || D <= 0 || G <= 0 || (stages != 1 && stages != 2) ||
         (self_mode != 0 && self_mode != 1);
}

template <int C, int SELF>
int launch_fwd(const float* x, int64_t B, int F, int D, int G, int threads, int stages, float* out,
               int64_t out_row_stride, cudaStream_t stream) {
  const int smem = static_cast<int>(stages * fwd_stage_floats(F, D, G, SELF) * sizeof(float));
  unsigned blocks = 0;
  if (int rc = nvt::resident_blocks(interaction_fwd_kernel<C, SELF>, threads, smem, (B + G - 1) / G, &blocks))
    return rc;
  interaction_fwd_kernel<C, SELF><<<blocks, threads, smem, stream>>>(x, B, F, D, G, stages, out, out_row_stride);
  return static_cast<int>(cudaGetLastError());
}

template <int C, int SELF>
int launch_bwd(const float* x, const float* g, int64_t g_row_stride, int64_t B, int F, int D, int G, int stages,
               float* dx, cudaStream_t stream) {
  const int smem = static_cast<int>(stages * bwd_stage_floats(F, D, C, G, SELF) * sizeof(float));
  unsigned blocks = 0;
  if (int rc = nvt::resident_blocks(interaction_bwd_kernel<C, SELF>, kBwdThreads, smem, (B + G - 1) / G, &blocks))
    return rc;
  interaction_bwd_kernel<C, SELF><<<blocks, kBwdThreads, smem, stream>>>(x, g, g_row_stride, B, F, D, G, stages, dx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// G samples a group, `threads` a block (a multiple of 32 and of G, at most
// kFwdMaxThreads), `cols` columns a step (4: D a multiple of 4 and x
// 16-byte aligned; or 1) and `stages` (1 or 2), from the wrapper's plan.
extern "C" int nvt_interaction_fwd(const float* x, int64_t B, int F, int D, int G, int threads, int cols, int stages,
                                   int self_mode, float* out, int64_t out_row_stride, void* stream) {
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (bad_shape(B, F, D, G, stages, self_mode) || threads < 32 || threads > kFwdMaxThreads || threads % 32 != 0 ||
      threads % G != 0 || !(cols == 1 || (cols == 4 && vec && D % 4 == 0)) ||
      stages * fwd_stage_floats(F, D, G, self_mode) * 4 + 16 > kSmemOptIn)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (self_mode)
    return cols == 4 ? launch_fwd<4, 1>(x, B, F, D, G, threads, stages, out, out_row_stride, s)
                     : launch_fwd<1, 1>(x, B, F, D, G, threads, stages, out, out_row_stride, s);
  return cols == 4 ? launch_fwd<4, 0>(x, B, F, D, G, threads, stages, out, out_row_stride, s)
                   : launch_fwd<1, 0>(x, B, F, D, G, threads, stages, out, out_row_stride, s);
}

// G samples a group (1 where a sample's items pass kBwdThreads), `cols`
// columns a thread (4: D a multiple of 4 and x, dx 16-byte aligned; or 1)
// and `stages` (1 or 2), from the wrapper's plan.
extern "C" int nvt_interaction_bwd(const float* x, const float* g, int64_t g_row_stride, int64_t B,
                                   int F, int D, int G, int cols, int stages, int self_mode, float* dx,
                                   void* stream) {
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  if (bad_shape(B, F, D, G, stages, self_mode) || !(cols == 1 || (cols == 4 && vec)) || D % cols != 0 ||
      (G > 1 && (F + kBwdRows - 1) / kBwdRows * (D / cols) * G > kBwdThreads) ||
      stages * bwd_stage_floats(F, D, cols, G, self_mode) * 4 + 16 > kSmemOptIn)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (self_mode)
    return cols == 4 ? launch_bwd<4, 1>(x, g, g_row_stride, B, F, D, G, stages, dx, s)
                     : launch_bwd<1, 1>(x, g, g_row_stride, B, F, D, G, stages, dx, s);
  return cols == 4 ? launch_bwd<4, 0>(x, g, g_row_stride, B, F, D, G, stages, dx, s)
                   : launch_bwd<1, 0>(x, g, g_row_stride, B, F, D, G, stages, dx, s);
}

// The streamed forward (one sample past 227 KB): a block a sample, its rows
// in chunks of Dc columns (the wrapper's plan: F * (Dc | 1) floats within
// the opt-in limit).
extern "C" int nvt_interaction_fwd_stream(const float* x, int64_t B, int F, int D, int Dc, int self_mode,
                                          float* out, int64_t out_row_stride, void* stream) {
  const int64_t smem = static_cast<int64_t>(F) * (Dc | 1) * 4;
  if (B < 0 || F < (self_mode ? 1 : 2) || D <= 0 || Dc < 1 || Dc > D || smem > kSmemOptIn ||
      (self_mode != 0 && self_mode != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned blocks = 0;
  if (self_mode) {
    if (int rc = nvt::resident_blocks(interaction_fwd_stream_kernel<1>, kStreamThreads, static_cast<int>(smem), B,
                                      &blocks))
      return rc;
    interaction_fwd_stream_kernel<1><<<blocks, kStreamThreads, smem, s>>>(x, B, F, D, Dc, out, out_row_stride);
  } else {
    if (int rc = nvt::resident_blocks(interaction_fwd_stream_kernel<0>, kStreamThreads, static_cast<int>(smem), B,
                                      &blocks))
      return rc;
    interaction_fwd_stream_kernel<0><<<blocks, kStreamThreads, smem, s>>>(x, B, F, D, Dc, out, out_row_stride);
  }
  return static_cast<int>(cudaGetLastError());
}

// The streamed backward: a block a (sample, kStreamCols columns) item.
extern "C" int nvt_interaction_bwd_stream(const float* x, const float* g, int64_t g_row_stride, int64_t B, int F,
                                          int D, int self_mode, float* dx, void* stream) {
  if (B < 0 || F < (self_mode ? 1 : 2) || D <= 0 || (self_mode != 0 && self_mode != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t items = B * ((D + kStreamCols - 1) / kStreamCols);
  unsigned blocks = 0;
  if (self_mode) {
    if (int rc = nvt::resident_blocks(interaction_bwd_stream_kernel<1>, kStreamThreads, 0, items, &blocks)) return rc;
    interaction_bwd_stream_kernel<1><<<blocks, kStreamThreads, 0, s>>>(x, g, g_row_stride, B, F, D, dx);
  } else {
    if (int rc = nvt::resident_blocks(interaction_bwd_stream_kernel<0>, kStreamThreads, 0, items, &blocks)) return rc;
    interaction_bwd_stream_kernel<0><<<blocks, kStreamThreads, 0, s>>>(x, g, g_row_stride, B, F, D, dx);
  }
  return static_cast<int>(cudaGetLastError());
}
