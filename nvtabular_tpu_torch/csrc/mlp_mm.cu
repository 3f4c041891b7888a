// The MLP and DCN cross-layer products of the training step on Hopper
// (sm_90a): kernel K21.
//
// Replaces the matrix-unit half of the fusions XLA makes of each layer of
// mlp_apply, nvtabular_tpu/models/layers.py:59-62 (jnp.dot of the
// compute_dtype-rounded input and weight, preferred_element_type float32),
// and of DCN's cross products, nvtabular_tpu/models/deepfm.py:126-131, with
// the transposes of both in the jitted train step. The layer's epilogue
// (bias, ReLU, round; its gradient and the rounds are K19's,
// mlp_epilogue.cu) is fused into the store.
//
// nvt_mlp_mm computes C[M, N] = A[M, K] B[K, N] with float32 sums, A and B
// float32 tensors read through their strides (element (r, k) of an operand
// at p[r sr + k sk], its r a row of A or a column of B; one of the strides
// is 1), so one entry serves the three products of a layer:
//   * forward, h [B, in] w [in, out], the store out = round_c(relu(z)) of z
//     = y + bias and the byte mask z > 0 where ReLU applies, which K19's
//     backward reads (relu is jax.nn.relu's: -0.0 and z <= 0 give +0.0, NaN
//     stays NaN; round_c the round trip through bfloat16 or float16), or any
//     of bias, ReLU and round off (the last layer; a cross layer stores xw);
//   * dgrad, dz [B, out] w^T, launched only where autograd needs the
//     input's gradient;
//   * wgrad, h^T dz, whose depth is the batch: split along K into planned
//     splits, each split's tile written to partial[split]; the last split of
//     a group of kSplitGroup to arrive (an integer ticket, as K19's db) sums
//     the group's partials in order, and the last group to arrive sums the
//     groups' in order: the same bits from run to run, a function of the
//     shape alone.
//
// Two paths, picked by the shape alone (kernels/mlp_mm.py mm_plan: the
// narrow path where min(M, N, K) <= NARROW_MAX = 16).
//
// The narrow path (mm_narrow) runs on the CUDA cores: each product a
// float32 fmaf over the operands as they are, summed in increasing k within
// a split. fmaf keeps the product exact and rounds only the sum, so it
// computes the function the tensor cores compute below, in another order,
// with no bfloat16 pieces; non-finite values follow IEEE arithmetic. A
// block of 128 or 256 threads stages its operands' tiles 16 deep (32 where N
// is the small side) in shared memory, loaded 16 bytes a thread in each
// operand's own layout (a K-major A kept row-major, so that its pieces are
// stored whole and read 4 deep at a time) while the stage before is summed;
// each thread sums a TM x 4 block of C and stores it as 16-byte row pieces
// with the epilogue. A padded depth is +0.0 in A and -0.0 in B: its product
// -0.0 leaves every sum as it is, -0.0 included. These products move bytes
// and do little arithmetic; their bound is the float32 bytes at 3.35 TB/s
// or the products at float32's 67 TFLOP/s, whichever is larger.
//
// The wide path (mm_wide) runs on the tensor cores: wgmma m64nNk16 in
// bfloat16 with float32 sums. An operand that holds bfloat16-rounded values
// (the compute_dtype casts of the input and the weights, K19's round of a
// hidden layer and of its gradient) converts to bfloat16 exactly, and a
// product of two bfloat16 values is exact in float32, so the sums are the
// MXU's in another order. A float32 operand that is not bfloat16-valued
// takes three pieces: hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi -
// mid), each rounded to nearest even. hi + mid + lo == x exactly for every
// finite |x| >= 2^-110; below that lo's bits fall under bfloat16's least
// subnormal 2^-133 and the split loses at most 2^-134 of x. A value above
// bfloat16's largest finite value takes hi rounded toward zero, a
// non-finite x is hi alone. Every product of a piece with a bfloat16 value
// is exact: the sum is over 3K exact terms (9K with both split). Which
// operands take it (kernels/mlp_mm.py operand_pieces): DCN's cross gradient
// x0 * g (kernels/cross.py), the gradient after a wide last layer (DCN's
// deep tower) and every operand where compute_dtype is float32 or float16;
// TF32 touches none of them. Non-finite values reach C as the float32
// product gives them: the products hi x hi sum into one accumulator and the
// other pieces' into a second; C = main + rest where main is finite, else
// main (a zero piece times an inf lands in rest alone). Padded rows,
// columns and depths are zero in shared memory on both sides, and a padded
// row or column, which may meet an inf, is never stored.
//
// Its design: a persistent grid of one block an SM walks the units (an
// output tile and a split of K) in order, so that consecutive blocks take
// the column tiles of one row tile and A comes from L2 after its first
// read. A block is two consumer warpgroups and one or two producer
// warpgroups (setmaxnreg moves registers to the consumers). B is packed
// once a launch where it is read again for every row tile (a forward's or
// input gradient's weights) or splits into pieces (pack_b: bfloat16 or
// pieces, in the stage layout), and a stage of it then arrives by one bulk
// copy of the tensor memory accelerator; the producers load A (and an
// unpacked B) as float32 tiles 16 bytes a thread, 8 chunks in flight, in
// each operand's own layout (K-major or MN-major: no transpose in
// registers), convert them to bfloat16 or split them into pieces, and store
// them in the 128-byte swizzle layout the wgmma descriptors read, into a
// ring of 4-8 stages 64 deep, each with a full and an empty mbarrier. The
// consumers wait on a stage's full barrier, issue its wgmmas (an MN-major
// operand with the transpose bit; the warpgroup index is made warp-uniform
// for ptxas, which serializes wgmmas on a path it takes for divergent) and
// release it on its empty barrier once the next stage's products are
// issued and this one's have completed: no __syncthreads in the main loop.
// A tile is 128 x 128 or 128 x 256 with bfloat16 operands; with a split
// operand that operand's side is 64 and each warpgroup keeps a second
// accumulator (64 x 128 or 128 x 64; 64 x 64 with both split, the second
// warpgroup computing the same sums and storing nothing). The epilogue
// stages 64 columns of the accumulators in shared memory at a time and
// stores C and the mask as 16-byte row pieces, while the producers fill the
// ring for the next unit.
//
// Bound: bytes for most shapes (the float32 operands read once, C and the
// mask written once): at DLRM's shapes (batch 65536) about 0.065 ms for a
// 512 x 256 forward at 3.35 TB/s against 0.017 ms of bfloat16 operations at
// 989 TFLOP/s; a split operand multiplies the operations by 3.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "wgmma.cuh"

namespace {

constexpr int kMaxSplits = 65535;  // the narrow path's gridDim.y
constexpr int kSplitGroup = 16;    // splits a group's ticket sums before the tile's ticket sums the groups

// The wide path
constexpr int kStageDepth = 64;            // a stage's depth: one 128-byte swizzle row of bfloat16
constexpr int kAtom = 1024;                // a swizzle atom: 8 rows of 128 bytes
constexpr int kMinStages = 4;
constexpr int kMaxStages = 8;
constexpr int kEpiCols = 64;               // columns a consumer warpgroup stages for its store at a time
constexpr int kEpiStride = 68;             // floats between staged rows (64 + 4: float4 rows, fewer conflicts)
constexpr int kEpiBytes = 2 * 64 * kEpiStride * 4;  // both consumer warpgroups' staging
constexpr int kBarBytes = 2 * kMaxStages * 8 + 16;  // the full and empty barriers and the ticket flag
constexpr int kSmemLimit = 232448;         // an H100 block's shared memory after the opt-in
// A block is two consumer warpgroups, then one producer warpgroup beside 128 x 256 tiles (a consumer thread holds
// 128 sums: 384 threads, 168 registers each, the most ptxas gives a path of the kernel) or two elsewhere (512
// threads, 128 registers each: twice the rate of loads and conversions). setmaxnreg moves registers between
// them within what the block was launched with: 128 x producers x kProducerRegsN + 256 x kConsumerRegsN <=
// 65536 (ptxas allocates a path at most the launch's count, and lowers it for the producers)
constexpr int kProducerRegs1 = 152;
constexpr int kConsumerRegs1 = 176;
constexpr int kProducerRegs2 = 96;
constexpr int kConsumerRegs2 = 160;
constexpr int kLoadBatch = 8;              // 16-byte chunks a producer thread loads before converting them
constexpr int kWaitPolls = 1 << 22;       // an mbarrier wait's polls before it traps

// The narrow path
constexpr int kNarrowDepth = 16;           // a stage's depth
constexpr int kNDepth = 32;                // the stage depth of the tiles where N is the small side

struct Operand {
  const float* p;
  int64_t sr, sk;  // element (r, k) at p[r sr + k sk]
  int64_t rows;    // M for A, N for B
  int kcontig;     // sk == 1 (K-major), else sr == 1 (MN-major)
  int vec;         // 16-byte loads along the contiguous dimension: p and the other stride 16-byte aligned
};

struct Params {
  Operand a, b;
  int64_t M, K;
  int N;
  int col_tiles;
  int64_t tiles;
  int splits, groups;    // groups: ceil(splits / kSplitGroup)
  int64_t k_split;       // the depth of a split, a multiple of the path's stage depth
  float* c;              // [M, N] contiguous
  const float* bias;     // [N] or null
  unsigned char* mask;   // [M, N] where relu
  int relu, round;       // round: 0 none, 1 bfloat16, 2 float16 (K19's round_c)
  float* partial;        // [splits, M, N] where splits > 1
  int* tickets;          // tiles x (groups + 1) counters, all zero
  char* packed;          // the wide path's B, packed: col_tiles x ksteps stages (pack_b)
  int64_t ksteps;        // B's stages a column tile: ceil(K / kStageDepth), at least 1
};

// --- the store and the split sums, shared by both paths ------------------------------------------------------------

template <int kRound>
__device__ __forceinline__ float round_c(float x) {
  if constexpr (kRound == 1) return __bfloat162float(__float2bfloat16_rn(x));
  else if constexpr (kRound == 2) return __half2float(__float2half_rn(x));
  else return x;
}

// The bias at columns n .. n + 3 (those below N; none where the launch has no bias)
__device__ __forceinline__ void load_bias4(const Params& q, int n, float (&bv)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) bv[j] = q.bias && n + j < q.N ? __ldg(q.bias + n + j) : 0.0f;
}

// The layer's epilogue on y [4] with the bias bv [4] of their columns: z = y + bias, mask z > 0, round_c(relu(z))
__device__ __forceinline__ uint32_t epilogue4(const Params& q, const float (&bv)[4], float (&y)[4]) {
  uint32_t mk = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float z = q.bias ? __fadd_rn(y[j], bv[j]) : y[j];
    mk |= static_cast<uint32_t>(z > 0.0f) << (8 * j);
    const float r = q.relu && z <= 0.0f ? 0.0f : z;
    y[j] = q.round == 1 ? round_c<1>(r) : q.round == 2 ? round_c<2>(r) : r;
  }
  return mk;
}

// y [4] into row m, columns n .. n + 3 (those below N) of an [M, N] array: one 16-byte store where the row is whole
__device__ __forceinline__ void store4(float* out, const Params& q, int64_t m, int n, const float (&y)[4]) {
  float* p = out + m * q.N + n;
  if ((q.N & 3) == 0 && n + 4 <= q.N) {
    *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n + j < q.N) p[j] = y[j];
  }
}

// The mask bytes mk of columns n .. n + 3 of row m
__device__ __forceinline__ void store_mask4(const Params& q, int64_t m, int n, uint32_t mk) {
  unsigned char* p = q.mask + m * q.N + n;
  if ((q.N & 3) == 0 && n + 4 <= q.N) {
    *reinterpret_cast<uint32_t*>(p) = mk;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n + j < q.N) p[j] = static_cast<unsigned char>(mk >> (8 * j));
  }
}

// C's row m, columns n .. n + 3 from the sums y: the epilogue and the mask where the launch has them
__device__ __forceinline__ void store_c4(const Params& q, int64_t m, int n, float (&y)[4]) {
  float bv[4];
  load_bias4(q, n, bv);
  const uint32_t mk = epilogue4(q, bv, y);
  store4(q.c, q, m, n, y);
  if (q.relu) store_mask4(q, m, n, mk);
}

__device__ __forceinline__ void load4(const float* p, const Params& q, int n, float (&v)[4]) {
  if ((q.N & 3) == 0 && n + 4 <= q.N) {
    const float4 x = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = n + j < q.N ? __ldcg(p + j) : 0.0f;
  }
}

// Partial slots s0, s0 + stride, ... (count of them) summed in that order over the tile [m0, m0 + bm) x [n0, n0 +
// bn) by thread t of nt: into C with the epilogue where `final`, else into slot s0 as they are.
__device__ void tile_sum(const Params& q, int64_t m0, int bm, int n0, int bn, int s0, int count, int stride,
                         bool final, int t, int nt) {
  const int64_t MN = q.M * q.N;
  const int rows = static_cast<int>(q.M - m0 < bm ? q.M - m0 : bm);
  const int cols = q.N - n0 < bn ? q.N - n0 : bn;
  const int c4 = (cols + 3) / 4;
  for (int e = t; e < rows * c4; e += nt) {
    const int64_t m = m0 + e / c4;
    const int n = n0 + 4 * (e % c4);
    const float* p = q.partial + s0 * MN + m * q.N + n;
    float s[4];
    load4(p, q, n, s);
#pragma unroll 4
    for (int i = 1; i < count; ++i) {
      float v[4];
      load4(p + static_cast<int64_t>(i) * stride * MN, q, n, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j] = __fadd_rn(s[j], v[j]);
    }
    if (final) store_c4(q, m, n, s);
    else store4(q.partial + s0 * MN, q, m, n, s);
  }
}

// After a split's partial tile is written: the last split of its group to arrive sums the group's slots into the
// group's first slot, and the last group to arrive sums the groups' slots into C (one level where the splits make
// one group). Run by the nt threads t of the block's `sync`.
template <class Sync>
__device__ void split_tickets(const Params& q, int64_t tile, int split, int64_t m0, int bm, int n0, int bn, int t,
                              int nt, volatile int* flag, Sync sync) {
  const int G = q.groups;
  int* tk = q.tickets + tile * (G + 1);
  const int g = split / kSplitGroup;
  const int gs = q.splits - g * kSplitGroup < kSplitGroup ? q.splits - g * kSplitGroup : kSplitGroup;
  __threadfence();
  sync();
  if (t == 0) *flag = atomicAdd(tk + g, 1) == gs - 1;
  sync();
  if (!*flag) return;
  __threadfence();
  if (G == 1) {
    tile_sum(q, m0, bm, n0, bn, 0, q.splits, 1, true, t, nt);
    if (t == 0) tk[0] = 0;
    return;
  }
  tile_sum(q, m0, bm, n0, bn, g * kSplitGroup, gs, 1, false, t, nt);
  __threadfence();
  sync();
  if (t == 0) {
    tk[g] = 0;
    *flag = atomicAdd(tk + G, 1) == G - 1;
  }
  sync();
  if (!*flag) return;
  __threadfence();
  tile_sum(q, m0, bm, n0, bn, 0, G, kSplitGroup, true, t, nt);
  if (t == 0) tk[G] = 0;
}

// --- the narrow path -------------------------------------------------------------------------------------------

// A stage of one operand: R rows by KD, held by the block's kT threads as 4-float pieces along its contiguous
// dimension between their load and their store; kFill past the depth K (+0.0 in A, -0.0 in B).
template <int R, int KD, int kFillBits, int kT>
struct NarrowStage {
  static constexpr int kUnits = R * KD / 4;
  static constexpr int kPer = (kUnits + kT - 1) / kT;
  float v[kPer][4];

  __device__ __forceinline__ static float fill() { return __int_as_float(kFillBits); }

  // piece u's row and depth in the tile: consecutive threads on consecutive pieces along the contiguous dimension
  // (coalesced loads)
  __device__ __forceinline__ static void where(const Operand& o, int u, int& r, int& k) {
    if (o.kcontig) {
      r = u / (KD / 4);
      k = 4 * (u % (KD / 4));
    } else {
      k = u / (R / 4);
      r = 4 * (u % (R / 4));
    }
  }

  __device__ __forceinline__ void load(const Operand& o, int64_t r0, int64_t k0, int64_t k_end) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int u = threadIdx.x + i * kT;
      float* t = v[i];
      if (kUnits % kT != 0 && u >= kUnits) continue;
      int r, k;
      where(o, u, r, k);
      const int64_t gr = r0 + r, gk = k0 + k;
      if (o.kcontig) {  // 4 along the depth
        if (gr >= o.rows) {
          t[0] = t[1] = t[2] = t[3] = 0.0f;
          continue;
        }
        const float* p = o.p + gr * o.sr + gk;
        if (o.vec && gk + 4 <= k_end) {
          const float4 x = __ldg(reinterpret_cast<const float4*>(p));
          t[0] = x.x, t[1] = x.y, t[2] = x.z, t[3] = x.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) t[j] = gk + j < k_end ? __ldg(p + j) : fill();
        }
      } else {  // 4 along the rows
        if (gk >= k_end) {
          t[0] = t[1] = t[2] = t[3] = fill();
          continue;
        }
        const float* p = o.p + gr + gk * o.sk;
        if (o.vec && gr + 4 <= o.rows) {
          const float4 x = __ldg(reinterpret_cast<const float4*>(p));
          t[0] = x.x, t[1] = x.y, t[2] = x.z, t[3] = x.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) t[j] = gr + j < o.rows ? __ldg(p + j) : 0.0f;
        }
      }
    }
  }

  // into dst[r][k] (rows of KD + 4 floats: each piece one 16-byte store; the operand K-major)
  __device__ __forceinline__ void store_rows(const Operand& o, float (*dst)[KD + 4]) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int u = threadIdx.x + i * kT;
      if (kUnits % kT != 0 && u >= kUnits) continue;
      int r, k;
      where(o, u, r, k);
      const float* t = v[i];
      *reinterpret_cast<float4*>(&dst[r][k]) = make_float4(t[0], t[1], t[2], t[3]);
    }
  }

  // into dst[k][r] (rows of R + 4 floats)
  __device__ __forceinline__ void store(const Operand& o, float (*dst)[R + 4]) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int u = threadIdx.x + i * kT;
      if (kUnits % kT != 0 && u >= kUnits) continue;
      int r, k;
      where(o, u, r, k);
      const float* t = v[i];
      if (o.kcontig) {
#pragma unroll
        for (int j = 0; j < 4; ++j) dst[k + j][r] = t[j];
      } else {
        *reinterpret_cast<float4*>(&dst[k][r]) = make_float4(t[0], t[1], t[2], t[3]);
      }
    }
  }
};

constexpr int kPlusZero = 0, kMinusZero = static_cast<int>(0x80000000u);

// C's tile [m0, m0 + BM) x [n0, n0 + BN) over one split of K: thread (tr, tc) sums rows tr + i BM / TM by the 4
// columns 4 tc .. 4 tc + 3 with fmaf, k increasing, from -0.0 (the IEEE sum of the products, -0.0 included).
// A's tile in shared memory: depth-major [KD][BM + 4], or row-major [BM][KD + 4] where A is K-major (kAK: its
// 16-byte pieces stored whole, and read 4 deep at a time, both free of bank conflicts)
template <int BM, int KD, int kAK>
__host__ __device__ constexpr int narrow_a_floats() { return kAK ? BM * (KD + 4) : KD * (BM + 4); }

template <int BM, int BN, int TM, int KD, int kAK>
__global__ void __launch_bounds__(BM / TM * (BN / 4)) mm_narrow(const Params q) {
  constexpr int RT = BM / TM, CT = BN / 4, kT = RT * CT;
  constexpr int kAFloats = narrow_a_floats<BM, KD, kAK>();
  extern __shared__ __align__(16) float narrow_smem[];
  auto sa = reinterpret_cast<float (*)[KD][BM + 4]>(narrow_smem);                   // [2][KD][BM + 4]
  auto sak = reinterpret_cast<float (*)[BM][KD + 4]>(narrow_smem);                  // [2][BM][KD + 4]
  auto sb = reinterpret_cast<float (*)[KD][BN + 4]>(narrow_smem + 2 * kAFloats);  // [2][KD][BN + 4]
  __shared__ int flag;
  const int t = threadIdx.x, tr = t / CT, tc = t % CT;
  const int64_t tile = blockIdx.x;
  const int64_t m0 = tile / q.col_tiles * BM;
  const int n0 = static_cast<int>(tile % q.col_tiles) * BN;
  const int split = blockIdx.y;
  const int64_t kb = split * q.k_split;
  const int64_t ke = q.K < kb + q.k_split ? q.K : kb + q.k_split;
  const int64_t steps = ke > kb ? (ke - kb + KD - 1) / KD : 0;

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = steps ? -0.0f : 0.0f;

  NarrowStage<BM, KD, kPlusZero, kT> la;
  NarrowStage<BN, KD, kMinusZero, kT> lb;
  if (steps) {
    la.load(q.a, m0, kb, ke);
    lb.load(q.b, n0, kb, ke);
    if constexpr (kAK) la.store_rows(q.a, sak[0]);
    else la.store(q.a, sa[0]);
    lb.store(q.b, sb[0]);
  }
  __syncthreads();
  for (int64_t s = 0; s < steps; ++s) {
    const int cur = static_cast<int>(s & 1);
    if (s + 1 < steps) {
      la.load(q.a, m0, kb + (s + 1) * KD, ke);
      lb.load(q.b, n0, kb + (s + 1) * KD, ke);
    }
#pragma unroll
    for (int k0 = 0; k0 < KD; k0 += 4) {
      float a[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        if constexpr (kAK) {
          const float4 x = *reinterpret_cast<const float4*>(&sak[cur][tr + i * RT][k0]);
          a[i][0] = x.x, a[i][1] = x.y, a[i][2] = x.z, a[i][3] = x.w;
        } else {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) a[i][kk] = sa[cur][k0 + kk][tr + i * RT];
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b = *reinterpret_cast<const float4*>(&sb[cur][k0 + kk][4 * tc]);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          acc[i][0] = fmaf(a[i][kk], b.x, acc[i][0]);
          acc[i][1] = fmaf(a[i][kk], b.y, acc[i][1]);
          acc[i][2] = fmaf(a[i][kk], b.z, acc[i][2]);
          acc[i][3] = fmaf(a[i][kk], b.w, acc[i][3]);
        }
      }
    }
    if (s + 1 < steps) {
      if constexpr (kAK) la.store_rows(q.a, sak[cur ^ 1]);
      else la.store(q.a, sa[cur ^ 1]);
      lb.store(q.b, sb[cur ^ 1]);
    }
    __syncthreads();
  }

  const int n = n0 + 4 * tc;
  const bool split_k = gridDim.y > 1;
  float* part = split_k ? q.partial + split * q.M * q.N : nullptr;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t m = m0 + tr + i * RT;
    if (m >= q.M || n >= q.N) continue;
    if (split_k) store4(part, q, m, n, acc[i]);
    else store_c4(q, m, n, acc[i]);
  }
  if (split_k) split_tickets(q, tile, split, m0, BM, n0, BN, t, kT, &flag, [] { __syncthreads(); });
}

// --- the wide path ---------------------------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(nvt::smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(nvt::smem_addr(bar)) : "memory");
}

// Waits for the phase of `bar` with the given parity; traps after kWaitPolls polls (a fault in the ring's
// protocol ends the launch with an error instead of hanging the card)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  int polls = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\tmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\tselp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(nvt::smem_addr(bar)), "r"(parity)
        : "memory");
    if (++polls > kWaitPolls) __trap();
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(nvt::smem_addr(bar)), "r"(bytes)
               : "memory");
}

// bytes from global src to shared dst by the tensor memory accelerator, counted on bar (src, dst and bytes
// 16-byte aligned)
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
               ::"r"(nvt::smem_addr(dst)), "l"(src), "r"(bytes), "r"(nvt::smem_addr(bar))
               : "memory");
}

// A named barrier of n threads
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

template <int WN, int kTA, int kTB>
__device__ __forceinline__ void mma(float (&d)[WN / 2], uint64_t da, uint64_t db) {
  if constexpr (WN == 64) nvt::wgmma64_bf16<kTA, kTB>(d, da, db);
  else if constexpr (WN == 128) nvt::wgmma128<__nv_bfloat16, kTA, kTB>(d, da, db);
  else nvt::wgmma256_bf16<kTA, kTB>(d, da, db);
}

// The 8 floats of a 16-byte bfloat16 chunk: (row r, depth k .. k + 7) of a K-major operand, (rows r .. r + 7,
// depth k) of an MN-major one; zero past its rows and k_end
template <int kMN>
__device__ __forceinline__ void load8(const Operand& o, int64_t r, int64_t k, int64_t k_end, float (&v)[8]) {
  if (kMN ? k >= k_end || r >= o.rows : r >= o.rows || k >= k_end) {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = 0.0f;
    return;
  }
  const float* p = kMN ? o.p + r + k * o.sk : o.p + r * o.sr + k;
  if (o.vec && (kMN ? r + 8 <= o.rows : k + 8 <= k_end)) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    const float4 y = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w, v[4] = y.x, v[5] = y.y, v[6] = y.z, v[7] = y.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = (kMN ? r + j < o.rows : k + j < k_end) ? __ldg(p + j) : 0.0f;
  }
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) { return reinterpret_cast<const uint32_t&>(v); }

// x = hi + mid + lo (exactly for finite |x| >= 2^-110), each rounded to nearest even, for x0 and x1 at once as
// bfloat16 pairs (x0 in the low half): the packed conversions take half the instructions
__device__ __forceinline__ void split3x2(float x0, float x1, uint32_t& h, uint32_t& m, uint32_t& l) {
  __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
  const bool f0 = isfinite(x0), f1 = isfinite(x1);
  if ((f0 && isinf(__low2float(hi))) || (f1 && isinf(__high2float(hi)))) {  // past bfloat16's largest value
    if (f0 && isinf(__low2float(hi))) hi.x = __float2bfloat16_rz(x0);
    if (f1 && isinf(__high2float(hi))) hi.y = __float2bfloat16_rz(x1);
  }
  const float r0 = f0 ? __fsub_rn(x0, __low2float(hi)) : 0.0f, r1 = f1 ? __fsub_rn(x1, __high2float(hi)) : 0.0f;
  const __nv_bfloat162 mid = __floats2bfloat162_rn(r0, r1);
  h = bits(hi);
  m = bits(mid);
  l = bits(__floats2bfloat162_rn(__fsub_rn(r0, __low2float(mid)), __fsub_rn(r1, __high2float(mid))));
}

// A chunk converted to bfloat16 (kP = 1) or its three pieces (kP = 3, pieces kPiece bytes apart) at tile + off
template <int kP, int kPiece>
__device__ __forceinline__ void store8(char* tile, int off, const float (&t)[8]) {
  if constexpr (kP == 1) {
    *reinterpret_cast<uint4*>(tile + off) =
        make_uint4(bits(__floats2bfloat162_rn(t[0], t[1])), bits(__floats2bfloat162_rn(t[2], t[3])),
                   bits(__floats2bfloat162_rn(t[4], t[5])), bits(__floats2bfloat162_rn(t[6], t[7])));
  } else {
    uint32_t h[4], m[4], l[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) split3x2(t[2 * j], t[2 * j + 1], h[j], m[j], l[j]);
    *reinterpret_cast<uint4*>(tile + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(tile + kPiece + off) = make_uint4(m[0], m[1], m[2], m[3]);
    *reinterpret_cast<uint4*>(tile + 2 * kPiece + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// Chunk c of a stage's tile of R rows by kStageDepth: its row and depth offsets r, k in the operand (the chunk
// runs along the depth from k where K-major, along the rows from r where MN-major) and its offset in the tile.
// K-major: row r at r 128 bytes, 8-row atoms stacked. MN-major: depth k's row of 64 MN values at (k % 8) 128 bytes
// within an atom, atoms along MN 1024 bytes apart, 8-deep groups R / 64 atoms apart. Both in the 128-byte swizzle:
// a 16-byte chunk's index within its 128-byte row XOR the row's index within its atom (the tiles start 1024-byte
// aligned, so offsets and addresses swizzle alike).
template <int R, int kMN>
__device__ __forceinline__ void chunk_at(int c, int& r, int& k, int& off) {
  if constexpr (kMN) {
    constexpr int kGroup = R / 64 * kAtom;
    k = c / (R / 8);
    const int rc = c % (R / 8);
    r = rc * 8;
    off = (k >> 3) * kGroup + (rc >> 3) * kAtom + (k & 7) * 128 + (((rc & 7) ^ (k & 7)) << 4);
  } else {
    r = c >> 3;
    const int kc = c & 7;
    k = kc * 8;
    off = r * 128 + ((kc ^ (r & 7)) << 4);
  }
}

// The producers' share (thread t of kPT) of one operand's stage: R rows by kStageDepth from rows r0 and depth k0,
// in kP pieces of R x 128 bytes. Consecutive threads take consecutive chunks along the contiguous dimension
// (coalesced 16-byte loads), kLoadBatch chunks in flight before their conversion; a stage wholly inside the
// operand takes no bounds checks.
template <int R, int kP, int kMN, int kPT>
__device__ __forceinline__ void fill(const Operand& o, int64_t r0, int64_t k0, int64_t k_end, char* tile, int t) {
  constexpr int kPer = R * 8 / kPT;
  constexpr int kBatch = kPer < kLoadBatch ? kPer : kLoadBatch;
  const bool whole = r0 + R <= o.rows && k0 + kStageDepth <= k_end;
  const float* base = whole ? (kMN ? o.p + r0 + k0 * o.sk : o.p + r0 * o.sr + k0) : o.p;
  const int64_t stride = kMN ? o.sk : o.sr;  // between the chunk grid's rows: depths where MN-major, else rows
#pragma unroll 1
  for (int b = 0; b < kPer; b += kBatch) {
    float v[kBatch][8];
    if (whole && o.vec) {
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        int r, k, off;
        chunk_at<R, kMN>(t + (b + i) * kPT, r, k, off);
        const float4* p = reinterpret_cast<const float4*>(base + (kMN ? k * stride + r : r * stride + k));
        const float4 x = __ldg(p), y = __ldg(p + 1);
        v[i][0] = x.x, v[i][1] = x.y, v[i][2] = x.z, v[i][3] = x.w;
        v[i][4] = y.x, v[i][5] = y.y, v[i][6] = y.z, v[i][7] = y.w;
      }
    } else if (whole) {  // rows not 16-byte aligned (an odd width such as 367 or 429): 4-byte loads
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        int r, k, off;
        chunk_at<R, kMN>(t + (b + i) * kPT, r, k, off);
        const float* p = base + (kMN ? k * stride + r : r * stride + k);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[i][j] = __ldg(p + j);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        int r, k, off;
        chunk_at<R, kMN>(t + (b + i) * kPT, r, k, off);
        load8<kMN>(o, r0 + r, k0 + k, k_end, v[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      int r, k, off;
      chunk_at<R, kMN>(t + (b + i) * kPT, r, k, off);
      store8<kP, R * 128>(tile, off, v[i]);
    }
  }
}

// The lead and stride of an operand tile's descriptor and the bytes between its k16 slices
template <int R, int kMN>
struct TileDesc {
  static constexpr uint32_t kLead = kMN ? kAtom : 16;
  static constexpr uint32_t kStride = kMN ? R / 64 * kAtom : kAtom;
  static constexpr int kSlice = kMN ? 2 * R / 64 * kAtom : 32;
};

// One stage's products for a consumer warpgroup: hi x hi into acc, every other pair of pieces into rest
template <int BM, int BN, int WN, int kPA, int kPB, int kTA, int kTB, int kRest>
__device__ __forceinline__ void stage_products(float (&acc)[WN / 2], float (&rest)[kRest], const char* a,
                                               const char* b) {
  using DA = TileDesc<BM, kTA>;
  using DB = TileDesc<BN, kTB>;
  nvt::wgmma_fence();
#pragma unroll
  for (int s = 0; s < kStageDepth / 16; ++s) {
    const char* as = a + s * DA::kSlice;
    const char* bs = b + s * DB::kSlice;
    const uint64_t a0 = nvt::gmma_desc_sw128(as, DA::kLead, DA::kStride);
    const uint64_t b0 = nvt::gmma_desc_sw128(bs, DB::kLead, DB::kStride);
    mma<WN, kTA, kTB>(acc, a0, b0);
    if constexpr (kPB == 3) {
#pragma unroll
      for (int pb = 1; pb < 3; ++pb)
        mma<WN, kTA, kTB>(rest, a0, nvt::gmma_desc_sw128(bs + pb * BN * 128, DB::kLead, DB::kStride));
    }
    if constexpr (kPA == 3) {
#pragma unroll
      for (int pa = 1; pa < 3; ++pa) {
        const uint64_t ad = nvt::gmma_desc_sw128(as + pa * BM * 128, DA::kLead, DA::kStride);
        mma<WN, kTA, kTB>(rest, ad, b0);
        if constexpr (kPB == 3) {
#pragma unroll
          for (int pb = 1; pb < 3; ++pb)
            mma<WN, kTA, kTB>(rest, ad, nvt::gmma_desc_sw128(bs + pb * BN * 128, DB::kLead, DB::kStride));
        }
      }
    }
  }
  nvt::wgmma_commit();
}

// B packed once a launch into each column tile's stages, each as fill leaves a stage of B in shared memory
// (bfloat16 or three pieces, swizzled), so that the producers move a stage of B by one bulk copy: a forward's or
// input gradient's weights are converted once, not once a row tile
template <int BN, int kPB, int kTB>
__global__ void __launch_bounds__(128) pack_b(const Params q) {
  const int64_t ct = blockIdx.x / q.ksteps, s = blockIdx.x % q.ksteps;
  fill<BN, kPB, kTB, 128>(q.b, ct * BN, s * kStageDepth, q.K, q.packed + blockIdx.x * (kPB * BN * 128), threadIdx.x);
}

// A warpgroup's sums: hi x hi in acc, the rest's in rest; C = main + rest where main is finite
template <bool kSplit, int kN, int kRest>
__device__ __forceinline__ float sum_of(const float (&acc)[kN], const float (&rest)[kRest], int i) {
  if constexpr (kSplit) return isfinite(acc[i]) ? __fadd_rn(acc[i], rest[i]) : acc[i];
  else return acc[i];
}

// The persistent product: BM x BN tiles, the consumer warpgroups each 64 x WN of it (kActive of them: rows 64 wg
// where BM is 128, else columns WN wg), operands in kPA and kPB pieces, MN-major where kTA / kTB.
template <int BM, int BN, int WN, int kActive, int kPA, int kPB, int kTA, int kTB, int kPackB>
__global__ void __launch_bounds__(WN == 256 ? 384 : 512, 1) mm_wide(const Params q, const int stages) {
  constexpr int kPT = WN == 256 ? 128 : 256;  // producer threads
  constexpr int kProducerRegs = WN == 256 ? kProducerRegs1 : kProducerRegs2;
  constexpr int kConsumerRegs = WN == 256 ? kConsumerRegs1 : kConsumerRegs2;
  extern __shared__ __align__(1024) char smem[];
  constexpr int kAPiece = BM * 128, kBPiece = BN * 128;
  constexpr int kBStage = kPB * kBPiece;
  constexpr int kStage = kPA * kAPiece + kBStage;
  constexpr bool kSplit = kPA > 1 || kPB > 1;
  constexpr int kRest = kSplit ? WN / 2 : 1;
  float* epi = reinterpret_cast<float*>(smem + stages * kStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * kStage + kEpiBytes);
  uint64_t* empty = full + kMaxStages;
  int* flag = reinterpret_cast<int*>(empty + kMaxStages);
  if (threadIdx.x == 0) {
    if (nvt::smem_addr(smem) % kAtom) __trap();  // the swizzle needs 1024-byte-aligned tiles
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, kPT);  // the producers' threads, each after its chunks
      mbar_init(empty + s, 256);  // the consumers' threads, each after the stage's products
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // the warpgroup, warp-uniform to the compiler (a wgmma on a path it takes for divergent is serialized)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  const int64_t units = q.tiles * q.splits;

  if (wg >= 2) {  // the producers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    const int t = threadIdx.x - 256;
    int slot = 0;
    uint32_t phase = 0;
    for (int64_t u = blockIdx.x; u < units; u += gridDim.x) {
      const int64_t tile = u / q.splits;
      const int64_t m0 = tile / q.col_tiles * BM;
      const int n0 = static_cast<int>(tile % q.col_tiles) * BN;
      const int64_t kb = u % q.splits * q.k_split;
      const int64_t ke = q.K < kb + q.k_split ? q.K : kb + q.k_split;
      // at least one step (of zeros where K is 0): the sums always come from products
      const int64_t steps = ke > kb ? (ke - kb + kStageDepth - 1) / kStageDepth : 1;
      const char* pb = kPackB ? q.packed + tile % q.col_tiles * q.ksteps * kBStage : nullptr;
      for (int64_t s = 0; s < steps; ++s) {
        mbar_wait(empty + slot, phase ^ 1);
        char* st = smem + slot * kStage;
        const int64_t k0 = kb + s * kStageDepth;
        // B's stage, packed, by one bulk copy that the full barrier counts, or by the producers' chunks as A's
        if (kPackB && t == 0) bulk_copy(st + kPA * kAPiece, pb + k0 / kStageDepth * kBStage, kBStage, full + slot);
        fill<BM, kPA, kTA, kPT>(q.a, m0, k0, ke, st, t);
        if (!kPackB) fill<BN, kPB, kTB, kPT>(q.b, n0, k0, ke, st + kPA * kAPiece, t);
        nvt::fence_async_smem();  // the stores visible to the tensor cores' reads
        if (kPackB && t == 0) mbar_arrive_expect_tx(full + slot, kBStage);
        else mbar_arrive(full + slot);
        if (++slot == stages) slot = 0, phase ^= 1;
      }
    }
    return;
  }

  // the consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int t = threadIdx.x;
  // with one active warpgroup (both operands split) the other computes the same sums and stores nothing: every
  // consumer thread issues every wgmma
  const bool active = wg < kActive;
  const int row_off = BM == 128 ? 64 * wg : 0, col_off = BM == 128 || kActive == 1 ? 0 : WN * wg;
  const int a_off = kTA ? row_off / 64 * kAtom : row_off * 128;
  const int b_off = kTB ? col_off / 64 * kAtom : col_off * 128;
  const int warp = (t >> 5) & 3, lane = t & 31;
  float* stg = epi + wg * 64 * kEpiStride;
  int slot = 0, prev = 0;
  uint32_t phase = 0;
  float acc[WN / 2], rest[kRest];
  for (int64_t u = blockIdx.x; u < units; u += gridDim.x) {
    const int64_t tile = u / q.splits;
    const int split = static_cast<int>(u % q.splits);
    const int64_t m0 = tile / q.col_tiles * BM;
    const int n0 = static_cast<int>(tile % q.col_tiles) * BN;
    const int64_t kb = split * q.k_split;
    const int64_t ke = q.K < kb + q.k_split ? q.K : kb + q.k_split;
    const int64_t steps = ke > kb ? (ke - kb + kStageDepth - 1) / kStageDepth : 1;
#pragma unroll
    for (int i = 0; i < WN / 2; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < kRest; ++i) rest[i] = 0.0f;
    for (int64_t s = 0; s < steps; ++s) {
      mbar_wait(full + slot, phase);
      const char* st = smem + slot * kStage;
      stage_products<BM, BN, WN, kPA, kPB, kTA, kTB, kRest>(acc, rest, st + a_off, st + kPA * kAPiece + b_off);
      // this warpgroup's products of the stage before are done (the sums are not touched while a product is in
      // flight: ptxas would serialize the wgmmas): release its slot
      nvt::wgmma_wait<1>();
      if (s > 0) mbar_arrive(empty + prev);
      prev = slot;
      if (++slot == stages) slot = 0, phase ^= 1;
    }
    nvt::wgmma_wait<0>();
    mbar_arrive(empty + prev);
    nvt::pin(acc);
    if constexpr (kSplit) nvt::pin(rest);

    // The epilogue, 64 columns at a time: the sums into the staging rows, then 16-byte row pieces of C (or of
    // this split's partial tile) with the layer's epilogue, the mask's 16 bytes gathered from 4 lanes
    const bool split_k = q.splits > 1;
    float* part = split_k ? q.partial + split * q.M * q.N : nullptr;
    if (active) {
#pragma unroll
      for (int j0 = 0; j0 < WN / kEpiCols; ++j0) {
#pragma unroll
        for (int j = 0; j < kEpiCols / 8; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * (j0 * (kEpiCols / 8) + j) + 2 * h;
            const int r = 16 * warp + (lane >> 2) + 8 * h, c = 8 * j + 2 * (lane & 3);
            *reinterpret_cast<float2*>(stg + r * kEpiStride + c) =
                make_float2(sum_of<kSplit>(acc, rest, i), sum_of<kSplit>(acc, rest, i + 1));
          }
        }
        bar_sync(1 + wg, 128);
        const int c = 4 * (t & 15);
        const int n = n0 + col_off + j0 * kEpiCols + c;
        float bv[4];
        load_bias4(q, n, bv);
#pragma unroll 2
        for (int pass = 0; pass < 8; ++pass) {
          const int r = ((t & 127) >> 4) + 8 * pass;
          const int64_t m = m0 + row_off + r;
          const float4 x = *reinterpret_cast<const float4*>(stg + r * kEpiStride + c);
          float y[4] = {x.x, x.y, x.z, x.w};
          const bool in = m < q.M && n < q.N;
          if (split_k) {
            if (in) store4(part, q, m, n, y);
            continue;
          }
          const uint32_t mk = epilogue4(q, bv, y);
          if (in) store4(q.c, q, m, n, y);
          if (!q.relu) continue;
          const uint32_t m1 = __shfl_down_sync(~0u, mk, 1), m2 = __shfl_down_sync(~0u, mk, 2),
                         m3 = __shfl_down_sync(~0u, mk, 3);
          if ((q.N & 15) == 0) {  // 16-byte rows: lanes 4 l .. 4 l + 3 hold 16 consecutive columns
            if ((t & 3) == 0 && in) *reinterpret_cast<uint4*>(q.mask + m * q.N + n) = make_uint4(mk, m1, m2, m3);
          } else if (in) {
            store_mask4(q, m, n, mk);
          }
        }
        bar_sync(1 + wg, 128);
      }
    }
    if (split_k) split_tickets(q, tile, split, m0, BM, n0, BN, t, 256, flag, [] { bar_sync(3, 256); });
  }
}

// --- launches --------------------------------------------------------------------------------------------------

int wide_stage_bytes(int bm, int bn, int pa, int pb) { return (pa * bm + pb * bn) * kStageDepth * 2; }

template <int BM, int BN, int WN, int kActive, int kPA, int kPB, int kTA, int kTB, int kPackB>
int launch_wide(const Params& q, int stages, cudaStream_t stream) {
  const int smem = stages * wide_stage_bytes(BM, BN, kPA, kPB) + kEpiBytes + kBarBytes;
  auto* kernel = mm_wide<BM, BN, WN, kActive, kPA, kPB, kTA, kTB, kPackB>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t units = q.tiles * q.splits;
  const unsigned blocks = static_cast<unsigned>(units < sms ? units : sms);
  if (kPackB) {
    pack_b<BN, kPB, kTB><<<static_cast<unsigned>(q.col_tiles * q.ksteps), 128, 0, stream>>>(q);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks, WN == 256 ? 384 : 512, smem, stream>>>(q, stages);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN, int WN, int kActive, int kPA, int kPB, int kPackB>
int wide_by_pack(const Params& q, int stages, cudaStream_t stream) {
  const int ta = !q.a.kcontig, tb = !q.b.kcontig;
  if (!ta && !tb) return launch_wide<BM, BN, WN, kActive, kPA, kPB, 0, 0, kPackB>(q, stages, stream);
  if (!ta && tb) return launch_wide<BM, BN, WN, kActive, kPA, kPB, 0, 1, kPackB>(q, stages, stream);
  if (ta && !tb) return launch_wide<BM, BN, WN, kActive, kPA, kPB, 1, 0, kPackB>(q, stages, stream);
  return launch_wide<BM, BN, WN, kActive, kPA, kPB, 1, 1, kPackB>(q, stages, stream);
}

// B packed where the plan gives it scratch (q.packed), else converted by the producers
template <int BM, int BN, int WN, int kActive, int kPA, int kPB>
int wide_by_layout(const Params& q, int stages, cudaStream_t stream) {
  return q.packed ? wide_by_pack<BM, BN, WN, kActive, kPA, kPB, 1>(q, stages, stream)
                  : wide_by_pack<BM, BN, WN, kActive, kPA, kPB, 0>(q, stages, stream);
}

// The wide path's tiles (kernels/mlp_mm.py WIDE_TILES): bfloat16 operands 128 x 128 or 128 x 256, a split A 64 x
// 128, a split B 128 x 64, both split 64 x 64 on one warpgroup
int launch_wide_tile(const Params& q, int bm, int bn, int pa, int pb, int stages, cudaStream_t stream) {
  if (pa == 1 && pb == 1 && bm == 128 && bn == 128) return wide_by_layout<128, 128, 128, 2, 1, 1>(q, stages, stream);
  if (pa == 1 && pb == 1 && bm == 128 && bn == 256) return wide_by_layout<128, 256, 256, 2, 1, 1>(q, stages, stream);
  if (pa == 3 && pb == 1 && bm == 64 && bn == 128) return wide_by_layout<64, 128, 64, 2, 3, 1>(q, stages, stream);
  if (pa == 1 && pb == 3 && bm == 128 && bn == 64) return wide_by_layout<128, 64, 64, 2, 1, 3>(q, stages, stream);
  if (pa == 3 && pb == 3 && bm == 64 && bn == 64) return wide_by_layout<64, 64, 64, 1, 3, 3>(q, stages, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int BM, int BN, int TM, int KD, int kAK>
int launch_narrow_layout(const Params& q, cudaStream_t stream) {
  if (q.k_split % KD) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 2 * narrow_a_floats<BM, KD, kAK>() * 4 + 2 * KD * (BN + 4) * 4;
  auto* kernel = mm_narrow<BM, BN, TM, KD, kAK>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(static_cast<unsigned>(q.tiles), q.splits), BM / TM * (BN / 4), smem, stream>>>(q);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN, int TM, int KD>
int launch_narrow(const Params& q, cudaStream_t stream) {
  return q.a.kcontig ? launch_narrow_layout<BM, BN, TM, KD, 1>(q, stream)
                     : launch_narrow_layout<BM, BN, TM, KD, 0>(q, stream);
}


// The narrow path's tiles (kernels/mlp_mm.py NARROW_TILES), by the smallest dimension: K 64 x 128 (256 threads), N
// (at most 16) 128 x 16 (128 threads, 32 deep), N at most 4 256 x 4 (256, 32 deep), M 16 x 256 (256)
int launch_narrow_tile(const Params& q, int bm, int bn, cudaStream_t stream) {
  if (bm == 64 && bn == 128) return launch_narrow<64, 128, 8, kNarrowDepth>(q, stream);
  if (bm == 128 && bn == 16) return launch_narrow<128, 16, 4, kNDepth>(q, stream);
  if (bm == 256 && bn == 4) return launch_narrow<256, 4, 1, kNDepth>(q, stream);
  if (bm == 16 && bn == 256) return launch_narrow<16, 256, 4, kNarrowDepth>(q, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

// An operand's strides as the kernels read it; false if neither is 1, or vec where the 16-byte loads would not be
// aligned (p may be null where K is 0: nothing is read)
bool make_operand(Operand& o, const void* p, int64_t sr, int64_t sk, int64_t rows, int64_t K, int vec) {
  o.p = static_cast<const float*>(p);
  o.sr = sr, o.sk = sk, o.rows = rows;
  o.kcontig = sk == 1;
  o.vec = vec;
  if ((!p && K > 0) || sr < 0 || sk < 0 || !(sk == 1 || sr == 1)) return false;
  if (!vec) return true;
  return aligned(p, 16) && (o.kcontig ? rows <= 1 || sr % 4 == 0 : K <= 1 || sk % 4 == 0);
}

}  // namespace

// C [M, N] = A [M, K] B [K, N] in float32 (kernels/mlp_mm.py mm_launch). Operand a: element (m, k) at a[m a_sr +
// k a_sk]; operand b: element (k, n) at b[n b_sr + k b_sk]; one stride of each is 1, vec their 16-byte loads
// along it, pieces 1 (bfloat16 values) or 3 (float32: the wide path's split; the narrow path reads the float32
// values as they are). The plan (kernels/mlp_mm.py mm_plan): path 0 narrow, 1 wide; a tile of bm x bn; the wide
// path's ring of `stages`; splits of k_split along K (a multiple of the path's stage depth) in `groups` ticket
// groups; with splits > 1, partial is [splits, M, N] float32 scratch and tickets tiles x (groups + 1) zeroed
// counters (the kernel leaves them so); on the wide path packed is col_tiles x max(1, ceil(K / 64)) x b_pieces x
// bn x 128 bytes of scratch for B packed (pack_b). bias [N] may be null; mask [M, N] bytes where relu; round 0
// none, 1 bfloat16, 2 float16.
extern "C" int nvt_mlp_mm(const void* a, int64_t a_sr, int64_t a_sk, int a_vec, int a_pieces, const void* b,
                          int64_t b_sr, int64_t b_sk, int b_vec, int b_pieces, int64_t M, int N, int64_t K, int path,
                          int bm, int bn, int stages, int64_t k_split, int splits, int groups, void* c,
                          const void* bias, void* mask, int relu, int round, void* partial, void* tickets,
                          void* packed, void* stream) {
  Params q;
  const int depth = path ? kStageDepth : kNarrowDepth;
  if (M < 0 || N < 0 || K < 0 || !c || (relu && !mask) || round < 0 || round > 2 || path < 0 || path > 1 ||
      bm <= 0 || bn <= 0 || splits < 1 || (path == 0 && splits > kMaxSplits) || k_split < depth ||
      k_split % depth || groups != (splits + kSplitGroup - 1) / kSplitGroup ||
      (splits > 1 && (!partial || !tickets)) || (static_cast<int64_t>(splits) - 1) * k_split >= (K > 0 ? K : 1) ||
      !aligned(c, 16) || (mask && !aligned(mask, 16)) || (a_pieces != 1 && a_pieces != 3) ||
      (b_pieces != 1 && b_pieces != 3) || (packed && !aligned(packed, 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (path == 1 && (stages < kMinStages || stages > kMaxStages ||
                    stages * wide_stage_bytes(bm, bn, a_pieces, b_pieces) + kEpiBytes + kBarBytes > kSmemLimit))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!make_operand(q.a, a, a_sr, a_sk, M, K, a_vec) || !make_operand(q.b, b, b_sr, b_sk, N, K, b_vec))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  const int64_t col_tiles = (N + bn - 1) / bn, tiles = (M + bm - 1) / bm * col_tiles;
  if (tiles > INT32_MAX || tiles * splits > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  q.M = M, q.K = K, q.N = N;
  q.col_tiles = static_cast<int>(col_tiles);
  q.tiles = tiles;
  q.splits = splits, q.groups = groups;
  q.k_split = k_split;
  q.c = static_cast<float*>(c);
  q.bias = static_cast<const float*>(bias);
  q.mask = static_cast<unsigned char*>(mask);
  q.relu = relu, q.round = round;
  q.partial = static_cast<float*>(partial);
  q.tickets = static_cast<int*>(tickets);
  q.packed = static_cast<char*>(packed);
  q.ksteps = K > 0 ? (K + kStageDepth - 1) / kStageDepth : 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return path ? launch_wide_tile(q, bm, bn, a_pieces, b_pieces, stages, st) : launch_narrow_tile(q, bm, bn, st);
}
