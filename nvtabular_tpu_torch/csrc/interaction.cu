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
// streamed path of their own, with the same sums in the same order. The
// forward is a tiled Gram product on the lower triangle: an item is a row
// block's diagonal triangle (120 rows) or a strip of 64 columns below it, at
// most 120 tiles of 8 x 8 pairs, one a thread with its sums in registers;
// the item's rows stream through a ring of 3 stages in chunks of 32 columns
// by 16-byte cp.async (the next chunks' copies run while one is summed), so
// at F <= 120 a sample's X is read once. A thread's 16 float4 reads of a
// unit (4 columns) feed 256 fmaf, and a swizzle by tile puts the lanes that
// read one row of several tiles in distinct banks. The backward computes dX =
// W X a sample (W the symmetric weight matrix): an item is a 64 x 256 tile
// of dX, its steps j in chunks of 16 through the ring, the chunk's weights staged from g by coalesced runs (a row's weights
// below the diagonal, a step's on and above it) and x_j's columns by
// 16-byte cp.async; a warp's lanes share 8 rows (broadcast weights, the
// diagonal's steps the warp's own) and keep 8 columns each. Every pair
// offset of the streamed kernels is 64-bit (row_base64): their F passes
// 46,341, where i (i + 1) / 2 passes int32; the staged kernels stop near F =
// 340 and keep row_base.
//
// The plain versions (kernels/interaction.py) compute the same fmaf steps
// in the same order, each exactly (the product and the sum in float64,
// rounded once to float32), so a model step through the kernels and
// through the plain versions sees the same float32 values before its
// bfloat16 casts, where a last-bit difference would become a bfloat16 step.
//
// Non-finite x: the reference's autograd forms dX from two dense products
// with the scattered [F, F] pair gradient, zeros included, so one
// non-finite x[b, j, d] makes dX[b, i, d] NaN for every i != j (some zero
// weight times inf), and, in the strict mode, for i == j too (the absent
// pair (i, i) weighs 0); the self mode's own row of a lone inf keeps 2 g_ii
// * inf + the rest. Both backward kernels and the plain version follow it.
// A sum over j that takes x[b, j, d] with any weight is not finite where
// x[b, j, d] is not (w * inf is +-inf, 0 * inf NaN, and neither goes back
// to finite), so a work item tests one row's sums of its columns (the
// strict mode, which skips j == i, two rows, or one row and its own x);
// only where one is not finite does it scan the column for its non-finite
// x and store NaN where the reference has it (column_nonfinite,
// reference_value). Finite data pays a few isfinite tests an item.
//
// Bound: bytes for the staged kernels. The forward reads X (F * D * 4 B a
// sample) and writes P * 4 B; its 2 * P * D flops a sample are ~1/6 of the
// byte time at the float32 rate without tensor cores, and its shared-memory
// reads half a float a fmaf. The backward reads X and g and writes dX; its
// F (F - 1) D fmaf a sample take about a quarter of the byte time, which the
// double-buffered staging overlaps with the next group's copies. The
// streamed kernels (F = 120, D = 1024) are bound by operations: 2 P D flops
// a sample forward, 2 F (F - 1) D (F^2 in the self mode) backward.

#include <cuda_runtime.h>
#include <cstdint>

#include "async.cuh"
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

// The non-finite x of a column (xcol = x[b, 0, d], its rows D apart): -1
// where there is none, -2 where there are several, else the row of the one.
__device__ __noinline__ int column_nonfinite(const float* xcol, int64_t D, int F) {
  int row = -1;
  for (int j = 0; j < F; ++j) {
    if (!isfinite(xcol[j * D])) {
      if (row >= 0) return -2;
      row = j;
    }
  }
  return row;
}

// dX[b, i, d] as the reference gives it, from its sum s and its column's
// column_nonfinite: NaN where some x[b, j != i, d] is not finite, and in the
// strict mode also where x[b, i, d] itself is not; else s.
template <int SELF>
__device__ __forceinline__ float reference_value(float s, int nonfinite, int i) {
  const bool nan = SELF ? nonfinite == -2 || (nonfinite >= 0 && nonfinite != i) : nonfinite != -1;
  return nan ? __int_as_float(0x7fc00000) : s;
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

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\tmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\tselp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(nvt::smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One row into its slot: the body by one bulk copy of the tensor memory
// accelerator, counted on `bar`; the head and the rest by 4-byte cp.async.
__device__ __forceinline__ void stage_row(float* slot, const float* src, int n, uint64_t* bar) {
  const RowSplit r(src, n);
  float* dst = slot + r.pad;
  for (int e = 0; e < r.head; ++e) nvt::cp_async4(dst + e, src + e);
  if (r.body)
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
                 ::"r"(nvt::smem_addr(dst + r.head)), "l"(src + r.head), "r"(4 * r.body), "r"(nvt::smem_addr(bar))
                 : "memory");
  for (int e = r.head + r.body; e < n; ++e) nvt::cp_async4(dst + e, src + e);
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
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(nvt::smem_addr(bar)), "r"(bytes)
                 : "memory");
  __syncwarp();
  for (int s = lane; s < ns; s += 32) stage_row(stage + s * xs, x + (b0 + s) * n, n, bar);
  nvt::cp_async_commit();
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
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(nvt::smem_addr(&bars[0])) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(nvt::smem_addr(&bars[1])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  int64_t grp = blockIdx.x;
  if (threadIdx.x < 32) {
    stage_fwd_group(x, B, F, D, G, xs, grp, smem, &bars[0]);
    nvt::cp_async_wait<0>();
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
                       ::"l"(dst + r.head), "r"(nvt::smem_addr(ost + t * os + r.pad + r.head)), "r"(4 * r.body)
                       : "memory");
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      // the stores of the group before have read their stage, which the next turn's sums overwrite
      if (stages == 2) asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      else asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
    if (threadIdx.x < 32) nvt::cp_async_wait<0>();  // the next group's heads and rests
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
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(nvt::smem_addr(bar)), "r"(bytes)
                 : "memory");
  __syncwarp();
  float* gst = stage + G * xs;
  for (int s = lane; s < ns; s += 32) {
    stage_row(stage + s * xs, x + (b0 + s) * F * D, F * D, bar);
    stage_row(gst + s * gs, g + (b0 + s) * g_row_stride, P, bar);
  }
  nvt::cp_async_commit();
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

// A work item's sums as the reference gives them at non-finite x (xcol:
// the item's columns of the sample's staged X rows). Row i0's sums take
// every x_j but x_i0 in the strict mode, so there row i0 + 1's, or x_i0
// itself where the item has one row, are tested too.
template <int C, int SELF>
__device__ __forceinline__ void item_follow_reference(const float* xcol, int D, int F, int i0,
                                                      float (&acc)[kBwdRows][C]) {
  bool bad = false;
#pragma unroll
  for (int k = 0; k < C; ++k) bad |= !isfinite(acc[0][k]);
  if (!SELF) {
    if (i0 + 1 < F) {
#pragma unroll
      for (int k = 0; k < C; ++k) bad |= !isfinite(acc[1][k]);
    } else {
#pragma unroll
      for (int k = 0; k < C; ++k) bad |= !isfinite(xcol[i0 * D + k]);
    }
  }
  if (bad) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int nonfinite = column_nonfinite(xcol + k, D, F);
#pragma unroll
      for (int r = 0; r < kBwdRows; ++r) acc[r][k] = reference_value<SELF>(acc[r][k], nonfinite, i0 + r);
    }
  }
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
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(nvt::smem_addr(&bars[0])) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(nvt::smem_addr(&bars[1])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  int64_t grp = blockIdx.x;
  if (threadIdx.x < 32) {
    stage_bwd_group(x, g, g_row_stride, B, F, D, G, P, xs, gs, grp, smem, &bars[0]);
    nvt::cp_async_wait<0>();
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
        item_follow_reference<C, SELF>(xslot + c * C, D, F, i0, acc);
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
        item_follow_reference<C, SELF>(xslot + c * C, D, F, blk * kBwdRows, acc);
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
                         ::"l"(out + t * n), "r"(nvt::smem_addr(xst + t * xs)), "r"(4 * n) : "memory");
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
    if (threadIdx.x < 32) nvt::cp_async_wait<0>();  // the next group's heads and rests
    __syncthreads();
  }
  if (C == 4 && threadIdx.x < 32) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// --- the streamed paths (one sample past 227 KB) ---------------------------------------

constexpr int kStreamStages = 3;  // both streamed kernels' ring of chunks in shared memory

// The pair index of row i in 64 bits: a streamed sample's F reaches past
// 46,341, where i (i + 1) / 2 passes int32 (the staged kernels stop near F =
// 340 and keep row_base).
__device__ __forceinline__ int64_t row_base64(int64_t i, int self_mode) {
  return self_mode ? i * (i + 1) / 2 : i * (i - 1) / 2;
}

// The streamed forward. The F x F triangle is cut into row blocks of kSfRows
// rows; row block I is a diagonal item (its own triangle: 15 x 16 / 2 = 120
// tiles of 8 x 8 pairs) and ceil(120 I / 64) strips of kSfStrip columns
// below it (120 x 64 pairs: 15 x 8 tiles), so every item is at most 120
// tiles for the block's kSfThreads threads, one tile a thread with its 64
// sums in registers. At F <= 120 a sample is one item and its X is read once.
constexpr int kSfThreads = 128;
constexpr int kSfTile = 8;                // rows i and rows j of a thread's tile
constexpr int kSfRows = 120;              // a row block: 15 tiles
constexpr int kSfStrip = 64;              // a strip's columns: 8 tiles
constexpr int kSfCols = 32;               // columns d of a chunk: 8 units of 16 bytes a row
constexpr int kSfUnits = kSfCols / 4;

__host__ __device__ __forceinline__ int64_t sf_block_items(int I) {
  return 1 + (static_cast<int64_t>(kSfRows) * I + kSfStrip - 1) / kSfStrip;
}

// A sample's items.
__host__ __device__ inline int64_t sf_items(int F) {
  int64_t n = 0;
  for (int I = 0; static_cast<int64_t>(I) * kSfRows < F; ++I) n += sf_block_items(I);
  return n;
}

// The rows of a stage: slots below 8 ceil(F / 8) where a sample is one
// diagonal item (F <= 120), else a row block's 120 and a strip's 64.
__host__ __device__ __forceinline__ int sf_rows(int F) {
  return F <= kSfRows ? kSfTile * ((F + kSfTile - 1) / kSfTile) : kSfRows + kSfStrip;
}

// An item: sample b, rows i [row0, row0 + nrow) in slots [0, nrow); a
// strip's rows j [col0, col0 + ncol) in slots [kSfRows, kSfRows + ncol)
// (ncol = 0: the diagonal item).
struct SfItem {
  int64_t b;
  int row0, nrow, col0, ncol;
};

__device__ __forceinline__ SfItem sf_item(int64_t it, int64_t per_sample, int F) {
  SfItem s;
  s.b = it / per_sample;
  int64_t r = it - s.b * per_sample;
  int I = 0;
  while (r >= sf_block_items(I)) r -= sf_block_items(I++);
  s.row0 = I * kSfRows;
  s.nrow = F - s.row0 < kSfRows ? F - s.row0 : kSfRows;
  s.col0 = r == 0 ? 0 : static_cast<int>(r - 1) * kSfStrip;
  s.ncol = r == 0 ? 0 : (s.row0 - s.col0 < kSfStrip ? s.row0 - s.col0 : kSfStrip);
  return s;
}

// Slot s's unit u (a row's 16 bytes) sits at unit u ^ ((s >> 3) & 7) of its
// row: a tile's 8 rows share the key, so the lanes that read one row of
// several tiles at once meet distinct banks, and a thread finds unit u of
// all its rows by one XOR.
__device__ __forceinline__ int sf_at(int slot, int u) { return slot * kSfCols + ((u ^ ((slot >> 3) & 7)) << 2); }

// A chunk of an item's rows (columns [d0, d0 + 32)): 16-byte cp.async
// (VEC: x 16-byte aligned, D % 4 == 0), else 4-byte; units past D are not
// copied (and not read).
template <int VEC>
__device__ __forceinline__ void sf_stage(const float* __restrict__ xb, int D, const SfItem& it, int d0, float* st) {
  const int dc = D - d0 < kSfCols ? D - d0 : kSfCols;
  const int n = (it.nrow + it.ncol) * kSfUnits;
  for (int e = threadIdx.x; e < n; e += kSfThreads) {
    const int k = e / kSfUnits, u = e % kSfUnits;
    if (4 * u >= dc) continue;
    const int slot = k < it.nrow ? k : kSfRows + k - it.nrow;
    const int64_t row = k < it.nrow ? it.row0 + k : it.col0 + k - it.nrow;
    const float* src = xb + row * D + d0 + 4 * u;
    float* dst = st + sf_at(slot, u);
    if constexpr (VEC) {
      nvt::cp_async16(dst, src);
    } else {
      for (int c = 0; c < 4 && 4 * u + c < dc; ++c) nvt::cp_async4(dst + c, src + c);
    }
  }
}

// One unit (4 columns d) of a thread's tile: its rows i at pa + 32 r and rows
// j at pb + 32 q, each pointer at its rows' unit; each pair's 4 fmaf in d order.
__device__ __forceinline__ void sf_unit(const float* pa, const float* pb, float (&acc)[kSfTile][kSfTile]) {
  float4 a[kSfTile];
#pragma unroll
  for (int r = 0; r < kSfTile; ++r) a[r] = *reinterpret_cast<const float4*>(pa + r * kSfCols);
#pragma unroll
  for (int q = 0; q < kSfTile; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(pb + q * kSfCols);
#pragma unroll
    for (int r = 0; r < kSfTile; ++r) {
      float t = fmaf(a[r].x, v.x, acc[r][q]);
      t = fmaf(a[r].y, v.y, t);
      t = fmaf(a[r].z, v.z, t);
      acc[r][q] = fmaf(a[r].w, v.w, t);
    }
  }
}

// The first n (< 4) columns of a unit.
__device__ __forceinline__ void sf_part(const float* pa, const float* pb, int n, float (&acc)[kSfTile][kSfTile]) {
  for (int c = 0; c < n; ++c) {
    float a[kSfTile], v[kSfTile];
#pragma unroll
    for (int r = 0; r < kSfTile; ++r) {
      a[r] = pa[r * kSfCols + c];
      v[r] = pb[r * kSfCols + c];
    }
#pragma unroll
    for (int r = 0; r < kSfTile; ++r)
#pragma unroll
      for (int q = 0; q < kSfTile; ++q) acc[r][q] = fmaf(a[r], v[q], acc[r][q]);
  }
}

// A thread's tile over one chunk of dc columns: rows in slots sa + r and
// sb + q (sa, sb multiples of 8).
__device__ __forceinline__ void sf_chunk(const float* st, int sa, int sb, int dc, float (&acc)[kSfTile][kSfTile]) {
  const int ma = (sa >> 3) & 7, mb = (sb >> 3) & 7;
  const float* ra = st + sa * kSfCols;
  const float* rb = st + sb * kSfCols;
  const int nu = dc >> 2;  // whole units, one a turn (a compact loop: its code stays in the instruction cache)
#pragma unroll 1
  for (int u = 0; u < nu; ++u) sf_unit(ra + ((u ^ ma) << 2), rb + ((u ^ mb) << 2), acc);
  if (4 * nu < dc) sf_part(ra + ((nu ^ ma) << 2), rb + ((nu ^ mb) << 2), dc - 4 * nu, acc);
}

// The tile's kept pairs to the sample's output row, at 64-bit pair offsets:
// a diagonal tile keeps j < i (j <= i in the self mode), a strip the
// columns below its end.
template <int SELF>
__device__ __forceinline__ void sf_store(float* __restrict__ ob, int F, const SfItem& it, int ta, int tb,
                                         const float (&acc)[kSfTile][kSfTile]) {
  const bool diag = it.ncol == 0;
  const int j0 = (diag ? it.row0 : it.col0) + kSfTile * tb;
  const int j_end = diag ? F : it.col0 + it.ncol;
#pragma unroll
  for (int r = 0; r < kSfTile; ++r) {
    const int i = it.row0 + kSfTile * ta + r;
    if (i >= F) break;
    float* o = ob + row_base64(i, SELF) + j0;
#pragma unroll
    for (int q = 0; q < kSfTile; ++q) {
      if (diag ? ta == tb && (SELF ? q > r : q >= r) : j0 + q >= j_end) continue;
      o[q] = acc[r][q];
    }
  }
}

// A persistent block walks items blockIdx.x, + gridDim.x, ...; the chunks of
// its items (ceil(D / 32) each, in d order) stream through a ring of
// kStreamStages stages, chunk s + 2's copies going out while chunk s is
// summed (one barrier a chunk). A thread's 64 sums stay in registers over
// an item's chunks, so each pair's fmaf steps run over d in order from 0.
template <int VEC, int SELF>
__global__ void __launch_bounds__(kSfThreads, 4)
interaction_fwd_stream_kernel(const float* __restrict__ x, int64_t B, int F, int D, int rows, int64_t per_sample,
                              float* __restrict__ out, int64_t out_row_stride) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int stage = rows * kSfCols;
  const int64_t total = B * per_sample;
  const int chunks = (D + kSfCols - 1) / kSfCols;
  const int t = threadIdx.x;
  int dta = 0;  // the thread's tile of a diagonal item, row by row; of a strip, row t / 8, column t % 8
  while ((dta + 1) * (dta + 2) / 2 <= t) ++dta;
  const int dtb = t - dta * (dta + 1) / 2;
  int64_t p_it = blockIdx.x;  // the next chunk to copy: item and chunk
  int p_c = 0;
  SfItem p = sf_item(p_it, per_sample, F);
  const SfItem first = p;
  auto produce = [&](int buf) {
    if (p_it < total) {
      sf_stage<VEC>(x + p.b * F * D, D, p, p_c * kSfCols, smem + buf * stage);
      if (++p_c == chunks) {
        p_c = 0;
        p_it += gridDim.x;
        if (p_it < total) p = sf_item(p_it, per_sample, F);
      }
    }
    nvt::cp_async_commit();
  };
  produce(0);
  produce(1);
  SfItem c = first;
  int c_c = 0;
  float acc[kSfTile][kSfTile];
#pragma unroll
  for (int r = 0; r < kSfTile; ++r)
#pragma unroll
    for (int q = 0; q < kSfTile; ++q) acc[r][q] = 0.0f;
  int buf = 0;
  for (int64_t c_it = blockIdx.x; c_it < total;) {
    nvt::cp_async_wait<kStreamStages - 2>();
    __syncthreads();  // chunk c_c is in every thread's view; the stage of the chunk before is read
    produce(buf == 0 ? kStreamStages - 1 : buf - 1);
    const bool diag = c.ncol == 0;
    const int ta = diag ? dta : t / kSfTile, tb = diag ? dtb : t % kSfTile;
    const bool live = t < kSfRows && kSfTile * ta < c.nrow && (diag || kSfTile * tb < c.ncol);
    const int d0 = c_c * kSfCols;
    if (live)
      sf_chunk(smem + buf * stage, kSfTile * ta, (diag ? 0 : kSfRows) + kSfTile * tb,
               D - d0 < kSfCols ? D - d0 : kSfCols, acc);
    buf = buf == kStreamStages - 1 ? 0 : buf + 1;
    if (++c_c == chunks) {
      if (live) sf_store<SELF>(out + c.b * out_row_stride, F, c, ta, tb, acc);
#pragma unroll
      for (int r = 0; r < kSfTile; ++r)
#pragma unroll
        for (int q = 0; q < kSfTile; ++q) acc[r][q] = 0.0f;
      c_c = 0;
      c_it += gridDim.x;
      if (c_it < total) c = sf_item(c_it, per_sample, F);
    }
  }
  nvt::cp_async_wait<0>();
}

// The streamed backward: dX = W X a sample, W the symmetric weight matrix. A
// tile of dX is kRows rows x kCols columns; its steps j stream in chunks of
// kSbSteps through a ring of kStreamStages stages of x_j's columns, and the
// chunk's weights w(i, j) are staged from g by coalesced runs (below the
// diagonal a row's weights are contiguous in j, on and above it a step's are
// contiguous in i). Where a row block's weights fit beside the ring with two
// blocks an SM (F <= 240) and D spans several column blocks, an item is a
// sample's row block, its column blocks in turn, and its weights are staged
// once into a tile of their own (g read once a sample); else an item is one
// tile, its weights in the ring beside x_j's (g read D / kCols times). A
// thread sums 8 rows x 8 columns in registers over j in order; the strict
// mode skips j == i, the self mode takes 2 g_ii there. A warp's lanes share
// 8 rows (their weights are broadcasts, and the diagonal's steps are the
// warp's), each lane two float4 of columns 128 apart.
constexpr int kSbThreads = 256;
constexpr int kSbSteps = 16;  // steps j of a chunk

struct Sb {
  static constexpr int kRowsT = 8;                  // rows of a thread, and of its warp
  static constexpr int kRows = 64;                  // rows of a tile: 8 a warp
  static constexpr int kHalves = 2;                 // a thread's float4 of columns, 128 apart
  static constexpr int kCols = 256;                 // columns of a tile
  static constexpr int kWs = kRows + 4;             // a step's weights in the stage: 16-byte aligned, 4 banks on
  static constexpr int kWChunk = kSbSteps * kWs;    // a chunk's weights
  static constexpr int kXChunk = kSbSteps * kCols;  // a chunk's x_j columns
};

constexpr int kSmemTwoBlocks = 228 * 1024 / 2 - 1024;  // a block's shared memory where two fit an SM

// The chunks of a tile, and whether a row block's weights are staged once
// (several column blocks, at least 3 chunks so that the next item's first
// copies miss the weights being read, and the tile beside the ring within
// two blocks an SM).
__host__ __device__ __forceinline__ int sb_chunks(int F) { return (F + kSbSteps - 1) / kSbSteps; }
__host__ __device__ __forceinline__ int64_t sb_smem_bytes(int F, int once) {
  return 4 * (once ? static_cast<int64_t>(sb_chunks(F)) * Sb::kWChunk + kStreamStages * Sb::kXChunk
                   : kStreamStages * (Sb::kWChunk + Sb::kXChunk));
}
__host__ __device__ __forceinline__ int sb_once(int F, int D) {
  return D > Sb::kCols && sb_chunks(F) >= 3 && sb_smem_bytes(F, 1) <= kSmemTwoBlocks;
}

// A chunk of x_j's columns [d0, d0 + kCols) for steps [j0, j0 + 16): 16-byte
// cp.async (VEC) or 4-byte.
template <int VEC>
__device__ __forceinline__ void sb_stage_x(const float* __restrict__ xb, int F, int D, int d0, int j0, float* xs) {
  const int jn = F - j0 < kSbSteps ? F - j0 : kSbSteps;
  if constexpr (VEC) {
    constexpr int units = Sb::kCols / 4;
    for (int e = threadIdx.x; e < kSbSteps * units; e += kSbThreads) {
      const int jj = e / units, d = d0 + 4 * (e % units);
      if (jj < jn && d < D) nvt::cp_async16(xs + 4 * e, xb + static_cast<int64_t>(j0 + jj) * D + d);
    }
  } else {
    for (int e = threadIdx.x; e < kSbSteps * Sb::kCols; e += kSbThreads) {
      const int jj = e / Sb::kCols, d = d0 + e % Sb::kCols;
      if (jj < jn && d < D) nvt::cp_async4(xs + e, xb + static_cast<int64_t>(j0 + jj) * D + d);
    }
  }
}

// A chunk's weights for rows [i0, i0 + kRows) by 4-byte cp.async in two
// coalesced passes (each only where the chunk has such pairs). The strict
// mode's diagonal is not staged (there is no such pair).
template <int SELF>
__device__ __forceinline__ void sb_stage_w(const float* __restrict__ gb, int F, int i0, int j0, float* ws) {
  const int jn = F - j0 < kSbSteps ? F - j0 : kSbSteps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i_end = i0 + Sb::kRows < F ? i0 + Sb::kRows : F;
  if (j0 < i_end - 1) {  // below the diagonal: a half-warp's lanes the steps of one row i > j
    const int jj = lane & 15, j = j0 + jj;
    for (int ii = threadIdx.x >> 4; ii < Sb::kRows; ii += kSbThreads / 16) {
      const int i = i0 + ii;
      if (i < F && j < i) nvt::cp_async4(ws + jj * Sb::kWs + ii, gb + row_base64(i, SELF) + j);
    }
  }
  if (j0 + jn - 1 >= i0) {  // on and above it: a warp's lanes the rows i <= j (i < j strict) of one step
    for (int jj = warp; jj < jn; jj += kSbThreads / 32) {
      const int j = j0 + jj;
      const float* gj = gb + row_base64(j, SELF);
      for (int ii = lane; ii < Sb::kRows; ii += 32) {
        const int i = i0 + ii;
        if (i < F && (SELF ? i <= j : i < j)) nvt::cp_async4(ws + jj * Sb::kWs + ii, gj + i);
      }
    }
  }
}

// Step jj of a chunk for a thread's R rows: `diag` is the row whose own step
// this is (-1: none), which the strict mode skips and the self mode weighs by
// 2 g_ii.
template <int SELF, int R, int H>
__device__ __forceinline__ void sb_step(const float* wrow, const float* xrow, const int (&cloc)[H], int diag,
                                        float (&acc)[R][4 * H]) {
  float w[R];
#pragma unroll
  for (int r = 0; r < R; r += 4) {
    const float4 q = *reinterpret_cast<const float4*>(wrow + r);
    w[r] = q.x;
    w[r + 1] = q.y;
    w[r + 2] = q.z;
    w[r + 3] = q.w;
  }
  float4 v[H];
#pragma unroll
  for (int h = 0; h < H; ++h) v[h] = *reinterpret_cast<const float4*>(xrow + cloc[h]);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (!SELF && r == diag) continue;
    const float wr = SELF && r == diag ? 2.0f * w[r] : w[r];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      acc[r][4 * h] = fmaf(wr, v[h].x, acc[r][4 * h]);
      acc[r][4 * h + 1] = fmaf(wr, v[h].y, acc[r][4 * h + 1]);
      acc[r][4 * h + 2] = fmaf(wr, v[h].z, acc[r][4 * h + 2]);
      acc[r][4 * h + 3] = fmaf(wr, v[h].w, acc[r][4 * h + 3]);
    }
  }
}

// A thread's sums over one chunk of jn steps (lo: the thread's first row's
// step within the chunk; its warp's rows are its own). A chunk that meets
// none of its rows' own steps runs without a check; else each step finds the
// row whose own step it is.
template <int SELF>
__device__ __forceinline__ void sb_chunk(const float* wst, const float* xs, int rloc, const int (&cloc)[Sb::kHalves],
                                         int jn, int lo, float (&acc)[Sb::kRowsT][4 * Sb::kHalves]) {
  constexpr int R = Sb::kRowsT;
  const float* ws = wst + rloc;
  if (lo + R <= 0 || lo >= jn) {
#pragma unroll 2
    for (int jj = 0; jj < jn; ++jj) sb_step<SELF>(ws + jj * Sb::kWs, xs + jj * Sb::kCols, cloc, -1, acc);
  } else {
#pragma unroll 2
    for (int jj = 0; jj < jn; ++jj) {
      const int k = jj - lo;
      sb_step<SELF>(ws + jj * Sb::kWs, xs + jj * Sb::kCols, cloc, k >= 0 && k < R ? k : -1, acc);
    }
  }
}

// A thread's tile of dX as the reference gives it at non-finite x (xb: the
// sample's X in global memory; rows r0 .., columns d0 + cloc[h] + 0..3):
// item_follow_reference's tests on row r0 (and r0 + 1, or x_r0), then the
// columns' scans where one fails.
template <int SELF>
__device__ __forceinline__ void tile_follow_reference(const float* __restrict__ xb, int D, int F, int r0, int d0,
                                                      const int (&cloc)[Sb::kHalves],
                                                      float (&acc)[Sb::kRowsT][4 * Sb::kHalves]) {
  bool bad = false;
#pragma unroll
  for (int h = 0; h < Sb::kHalves; ++h)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int d = d0 + cloc[h] + k;
      if (d >= D) continue;
      bad |= !isfinite(acc[0][4 * h + k]);
      if (!SELF) bad |= !isfinite(r0 + 1 < F ? acc[1][4 * h + k] : xb[static_cast<int64_t>(r0) * D + d]);
    }
  if (!bad) return;
#pragma unroll
  for (int h = 0; h < Sb::kHalves; ++h)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int d = d0 + cloc[h] + k;
      if (d >= D) continue;
      const int nonfinite = column_nonfinite(xb + d, D, F);
#pragma unroll
      for (int r = 0; r < Sb::kRowsT; ++r)
        acc[r][4 * h + k] = reference_value<SELF>(acc[r][4 * h + k], nonfinite, r0 + r);
    }
}

// Items: a sample's row block (its column blocks in turn; `once`), else
// (sample, column block, row block), the row block fastest, so that the
// row blocks of a column block run together and share x_j's columns in L2.
// A persistent block walks items blockIdx.x, + gridDim.x, ...; the chunks of
// its tiles (ceil(F / 16) each, in j order) stream through the ring as in
// the forward.
template <int VEC, int SELF>
__global__ void __launch_bounds__(kSbThreads, 2)
interaction_bwd_stream_kernel(const float* __restrict__ x, const float* __restrict__ g, int64_t g_row_stride,
                              int64_t B, int F, int D, int once, int64_t per_sample, float* __restrict__ dx) {
  constexpr int H = Sb::kHalves, R = Sb::kRowsT;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rloc = R * warp;  // the warp's first row
  int cloc[H];
#pragma unroll
  for (int h = 0; h < H; ++h) cloc[h] = 4 * lane + 128 * h;
  const int nrb = (F + Sb::kRows - 1) / Sb::kRows;
  const int chunks = sb_chunks(F);
  const int tiles = once ? (D + Sb::kCols - 1) / Sb::kCols : 1;  // column blocks an item
  const int stage = once ? Sb::kXChunk : Sb::kWChunk + Sb::kXChunk;
  float* ring = smem + (once ? chunks * Sb::kWChunk : 0);  // once: the row block's weights first
  const int64_t total = B * per_sample;
  auto item = [&](int64_t it, int64_t& b, int& i0, int& d0) {
    b = it / per_sample;
    const int rem = static_cast<int>(it - b * per_sample);
    i0 = rem % nrb * Sb::kRows;
    d0 = rem / nrb * Sb::kCols;
  };
  int64_t p_it = blockIdx.x, p_b;
  int p_c = 0, p_t = 0, p_i0, p_d0;
  item(p_it, p_b, p_i0, p_d0);
  auto produce = [&](int buf) {
    if (p_it < total) {
      float* st = ring + buf * stage;
      sb_stage_x<VEC>(x + p_b * F * D, F, D, p_d0 + p_t * Sb::kCols, p_c * kSbSteps, once ? st : st + Sb::kWChunk);
      if (!once || p_t == 0)
        sb_stage_w<SELF>(g + p_b * g_row_stride, F, p_i0, p_c * kSbSteps, once ? smem + p_c * Sb::kWChunk : st);
      if (++p_c == chunks) {
        p_c = 0;
        if (++p_t == tiles) {
          p_t = 0;
          p_it += gridDim.x;
          if (p_it < total) item(p_it, p_b, p_i0, p_d0);
        }
      }
    }
    nvt::cp_async_commit();
  };
  int64_t c_b = p_b;
  int c_i0 = p_i0, c_d0 = p_d0, c_c = 0;
  produce(0);
  produce(1);
  float acc[R][4 * H];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int k = 0; k < 4 * H; ++k) acc[r][k] = 0.0f;
  int buf = 0, c_t = 0;
  for (int64_t c_it = blockIdx.x; c_it < total;) {
    nvt::cp_async_wait<kStreamStages - 2>();
    __syncthreads();  // chunk c_c is in every thread's view; the stage of the chunk before is read
    produce(buf == 0 ? kStreamStages - 1 : buf - 1);
    const int r0 = c_i0 + rloc, j0 = c_c * kSbSteps, d0 = c_d0 + c_t * Sb::kCols;
    const bool live = r0 < F && d0 + cloc[0] < D;  // the warp's rows, the lane's first columns
    const float* st = ring + buf * stage;
    if (live)
      sb_chunk<SELF>(once ? smem + c_c * Sb::kWChunk : st, once ? st : st + Sb::kWChunk, rloc, cloc,
                     F - j0 < kSbSteps ? F - j0 : kSbSteps, r0 - j0, acc);
    buf = buf == kStreamStages - 1 ? 0 : buf + 1;
    if (++c_c == chunks) {
      if (live) tile_follow_reference<SELF>(x + c_b * F * D, D, F, r0, d0, cloc, acc);
      if (live) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r0 + r >= F) break;
          float* o = dx + (c_b * F + r0 + r) * D;
#pragma unroll
          for (int h = 0; h < H; ++h) {
            const int d = d0 + cloc[h];
            if constexpr (VEC) {
              if (d < D)
                __stcs(reinterpret_cast<float4*>(o + d),
                       make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2], acc[r][4 * h + 3]));
            } else {
#pragma unroll
              for (int k = 0; k < 4; ++k)
                if (d + k < D) o[d + k] = acc[r][4 * h + k];
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int k = 0; k < 4 * H; ++k) acc[r][k] = 0.0f;
      c_c = 0;
      if (++c_t == tiles) {
        c_t = 0;
        c_it += gridDim.x;
        if (c_it < total) item(c_it, c_b, c_i0, c_d0);
      }
    }
  }
  nvt::cp_async_wait<0>();
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

template <int VEC, int SELF>
int launch_fwd_stream(const float* x, int64_t B, int F, int D, int rows, int stages, int64_t per_sample, float* out,
                      int64_t out_row_stride, cudaStream_t stream) {
  const int smem = stages * rows * kSfCols * static_cast<int>(sizeof(float));
  unsigned blocks = 0;
  if (int rc = nvt::resident_blocks(interaction_fwd_stream_kernel<VEC, SELF>, kSfThreads, smem, B * per_sample,
                                    &blocks))
    return rc;
  interaction_fwd_stream_kernel<VEC, SELF><<<blocks, kSfThreads, smem, stream>>>(x, B, F, D, rows, per_sample, out,
                                                                                  out_row_stride);
  return static_cast<int>(cudaGetLastError());
}

template <int VEC, int SELF>
int launch_bwd_stream(const float* x, const float* g, int64_t g_row_stride, int64_t B, int F, int D, int once,
                      int64_t per_sample, float* dx, cudaStream_t stream) {
  const int smem = static_cast<int>(sb_smem_bytes(F, once));
  unsigned blocks = 0;
  if (int rc = nvt::resident_blocks(interaction_bwd_stream_kernel<VEC, SELF>, kSbThreads, smem, B * per_sample,
                                    &blocks))
    return rc;
  interaction_bwd_stream_kernel<VEC, SELF><<<blocks, kSbThreads, smem, stream>>>(x, g, g_row_stride, B, F, D, once,
                                                                                  per_sample, dx);
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

// The streamed forward (one sample past 227 KB), with the wrapper's plan:
// `cols` 4 (x 16-byte aligned, D % 4 == 0: 16-byte copies) or 1, `rows` a
// stage (sf_rows), `stages` (kStreamStages) and `items` a sample (sf_items).
extern "C" int nvt_interaction_fwd_stream(const float* x, int64_t B, int F, int D, int cols, int rows, int stages,
                                          int64_t items, int self_mode, float* out, int64_t out_row_stride,
                                          void* stream) {
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && D % 4 == 0;
  if (B < 0 || F < (self_mode ? 1 : 2) || D <= 0 || (self_mode != 0 && self_mode != 1) ||
      !(cols == 1 || (cols == 4 && vec)) || rows != sf_rows(F) || stages != kStreamStages || items != sf_items(F) ||
      static_cast<int64_t>(stages) * rows * kSfCols * 4 > kSmemOptIn)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (self_mode)
    return cols == 4 ? launch_fwd_stream<1, 1>(x, B, F, D, rows, stages, items, out, out_row_stride, s)
                     : launch_fwd_stream<0, 1>(x, B, F, D, rows, stages, items, out, out_row_stride, s);
  return cols == 4 ? launch_fwd_stream<1, 0>(x, B, F, D, rows, stages, items, out, out_row_stride, s)
                   : launch_fwd_stream<0, 0>(x, B, F, D, rows, stages, items, out, out_row_stride, s);
}

// The streamed backward, with the wrapper's plan: `cols` 4 (x and dx 16-byte
// aligned, D % 4 == 0) or 1, `stages` (kStreamStages), `once` (sb_once) and
// `items` a sample (row blocks, times column blocks unless once).
extern "C" int nvt_interaction_bwd_stream(const float* x, const float* g, int64_t g_row_stride, int64_t B, int F,
                                          int D, int cols, int stages, int once, int64_t items, int self_mode,
                                          float* dx, void* stream) {
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(dx) % 16 == 0 &&
                   D % 4 == 0;
  if (B < 0 || F < (self_mode ? 1 : 2) || D <= 0 || (self_mode != 0 && self_mode != 1) ||
      !(cols == 1 || (cols == 4 && vec)) || stages != kStreamStages || once != sb_once(F, D) ||
      sb_smem_bytes(F, once) > kSmemOptIn)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t want =
      static_cast<int64_t>((F + Sb::kRows - 1) / Sb::kRows) * (once ? 1 : (D + Sb::kCols - 1) / Sb::kCols);
  if (items != want) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (self_mode)
    return cols == 4 ? launch_bwd_stream<1, 1>(x, g, g_row_stride, B, F, D, once, items, dx, s)
                     : launch_bwd_stream<0, 1>(x, g, g_row_stride, B, F, D, once, items, dx, s);
  return cols == 4 ? launch_bwd_stream<1, 0>(x, g, g_row_stride, B, F, D, once, items, dx, s)
                   : launch_bwd_stream<0, 0>(x, g, g_row_stride, B, F, D, once, items, dx, s);
}
