// The MLP and DCN cross-layer products of the training step on Hopper's
// tensor cores (sm_90a): kernel K21.
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
// is 1), so one kernel serves the three products of a layer:
//   * forward, h [B, in] w [in, out], the store out = round_c(relu(z)) of z
//     = y + bias and the byte mask z > 0 where ReLU applies, which K19's
//     backward reads (relu is jax.nn.relu's: -0.0 and z <= 0 give +0.0, NaN stays
//     NaN; round_c the round trip through bfloat16 or float16), or any of
//     bias, ReLU and round off (the last layer; a cross layer stores xw);
//   * dgrad, dz [B, out] w^T, launched only where autograd needs the
//     input's gradient;
//   * wgrad, h^T dz, whose depth is the batch: split along K (gridDim.y
//     splits), each block's tile written to partial[split], and the tile's
//     last block to arrive (an integer ticket, as K19's db) sums the splits
//     in order: the same bits from run to run.
//
// Why bfloat16 tensor cores compute JAX's function: an operand that holds
// bfloat16-rounded values (the compute_dtype casts of the input and the
// weights, K19's round of a hidden layer and of its gradient) converts to
// bfloat16 exactly (round to nearest even is the identity on them), and a
// product of two bfloat16 values is exact in float32. So wgmma m64nNk16 on
// bfloat16 operands with float32 sums computes what the MXU computes, in
// another summation order.
//
// A float32 operand that is not bfloat16-valued takes three pieces: hi =
// bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), each rounded to
// nearest even. hi + mid + lo == x exactly for every finite |x| >= 2^-110
// (8 + 8 + 8 bits of x's 24); below that lo's bits fall under bfloat16's
// least subnormal 2^-133, and the split loses at most 2^-134 of x. A value
// above bfloat16's largest finite value takes hi rounded toward zero. A
// non-finite x is hi alone (mid = lo = 0). Every product of a piece with a
// bfloat16 value is exact, so the sum is the plain product's sum over 3K
// exact terms (9K with both operands split). The products that take it
// (kernels/mlp_mm.py operand_pieces): the last layer's gradient dz of each
// MLP (not rounded: DLRM's [65536, 16] and [65536, 1]) in its dgrad and
// wgrad, DCN's cross gradient x0 * g (kernels/cross.py) in both, and every
// operand where compute_dtype is float32 or float16 (the step-parity
// checks' float32 runs). TF32 touches none of them.
//
// Non-finite values reach C as the float32 product gives them: the
// products hi x hi sum into one accumulator and the other pieces' into a
// second; C = main + rest where main is finite, else main. A finite main
// means every term of the sum is finite, so rest is; an inf or NaN term
// makes main what the plain product makes of it (x * 0 = NaN, x * inf =
// inf), while a zero piece times inf (0 * inf = NaN) lands only in rest.
// Padded rows, columns and depths are zero in shared memory on both sides:
// a padded depth multiplies zero by zero, and a padded row or column, which
// may meet an inf of the other operand, is never stored.
//
// Design (simple first; TMA, deeper rings and persistent blocks are later
// work): a block of two warpgroups owns a tile of 128 rows (64 a
// warpgroup) by BN = 8, 16, 64 or 128 columns (kernels/mlp_mm.py mm_plan;
// 64 at most with a split operand) over its split of K, in steps of 32.
// Each thread loads its 16-byte chunks of a step's A and B tiles from the
// float32 tensors into registers (two float4 loads along a K-contiguous row,
// else 8 loads along K that are coalesced across the warp's rows), converts
// them to bfloat16 (and pieces) and stores them K-major into a ring of 3
// staged steps in shared memory: a transposed operand is transposed here,
// so one wgmma form (both operands K-major) serves every case. The
// products are asynchronous: a step stores its tiles, passes one barrier,
// issues its wgmmas, loads the next step's tiles while they run and waits
// for the step before's products; the ring slot a step writes was last read
// three steps back, before the barrier every warpgroup passed after its
// wait. Every wgmma is issued by every thread: ptxas serializes wgmmas on
// a divergent path.
//
// Bound: at DLRM's shapes (batch 65536) bytes: the float32 operands read
// once and C written once (and the mask), about 0.27 ms for the forward at
// 3.35 TB/s against 0.06 ms of bfloat16 operations at 989 TFLOP/s. The
// kernel reads A once a column tile (from L2 after the first: consecutive
// blocks take the column tiles of one row tile) and B once a row tile.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;                 // two warpgroups
constexpr int kRows = 128;                    // a tile's rows of C: 64 a warpgroup
constexpr int kDepth = 32;                    // a step's depth: two k16 slices
constexpr int kLead = 128;                    // bytes between core matrices along K
constexpr int kStride = kDepth / 8 * kLead;   // bytes between core matrices along M or N
constexpr int kBufs = 3;                      // the ring of staged steps
constexpr int kMaxSplits = 65535;             // gridDim.y's limit
constexpr int kAPiece = kRows * kDepth * 2;   // one piece of a step's A tile in bytes

struct Operand {
  const float* p;
  int64_t sr, sk;  // element (r, k) at p[r sr + k sk]
  int64_t rows;    // M for A, N for B
  int kcontig;     // sk == 1: a chunk is 8 consecutive floats of a row
  int vec;         // kcontig, p and every row start 16-byte aligned: float4 loads
};

struct Params {
  Operand a, b;
  int64_t M, K;
  int N;
  int col_tiles;
  int64_t k_split;        // the depth of a split, a multiple of kDepth
  float* c;               // [M, N] contiguous
  const float* bias;      // [N] or null
  unsigned char* mask;    // [M, N] where relu
  int relu, round;        // round: 0 none, 1 bfloat16, 2 float16 (K19's round_c)
  float* partial;         // [splits, M, N] where gridDim.y > 1
  int* tickets;           // a counter a tile, all zero
};

// Byte offset of the 16-byte chunk (r, k0 .. k0 + 7) of a K-major tile, kc = k0 / 8
__device__ __forceinline__ int chunk_off(int r, int kc) { return (r >> 3) * kStride + kc * kLead + (r & 7) * 16; }

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) | static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16;
}

// x = hi + mid + lo (exactly for finite |x| >= 2^-110), each rounded to nearest even
__device__ __forceinline__ void split3(float x, __nv_bfloat16& hi, __nv_bfloat16& mid, __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  if (!isfinite(x)) {
    mid = lo = __float2bfloat16_rn(0.0f);
    return;
  }
  if (isinf(__bfloat162float(hi))) hi = __float2bfloat16_rz(x);  // past bfloat16's largest finite value
  const float r = __fsub_rn(x, __bfloat162float(hi));
  mid = __float2bfloat16_rn(r);
  lo = __float2bfloat16_rn(__fsub_rn(r, __bfloat162float(mid)));
}

// A step's tile of kR rows by kDepth of one operand, in kP pieces (1: the
// values are bfloat16; 3: hi, mid, lo), as 16-byte chunks a thread holds
// between its load and its store.
template <int kR, int kP>
struct Stage {
  static constexpr int kChunks = kR * kDepth / 8;
  static constexpr int kPer = (kChunks + kThreads - 1) / kThreads;
  static constexpr int kPieceBytes = kR * kDepth * 2;
  float v[kPer][8];

  // Chunk e's row and chunk of depth. Along K: a warp's lanes take 8 rows by
  // 4 chunks (each 8-lane phase of a 16-byte store fills one core matrix).
  // Along the rows: consecutive lanes take consecutive rows (coalesced loads).
  __device__ __forceinline__ static void where(const Operand& o, int e, int& r, int& kc) {
    if (o.kcontig) {
      const int lane = e & 31;
      r = (lane & 7) + 8 * (e >> 5);
      kc = lane >> 3;
    } else {
      r = e % kR;
      kc = e / kR;
    }
  }

  __device__ __forceinline__ void load(const Operand& o, int64_t r0, int64_t k0, int64_t k_end) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + i * kThreads;
      float* t = v[i];
      int r, kc;
      where(o, e, r, kc);
      const int64_t gr = r0 + r, k = k0 + kc * 8;
      if ((kChunks % kThreads != 0 && e >= kChunks) || gr >= o.rows || k >= k_end) {
#pragma unroll
        for (int j = 0; j < 8; ++j) t[j] = 0.0f;
        continue;
      }
      const float* p = o.p + gr * o.sr + k * o.sk;
      if (o.vec && k + 8 <= k_end) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(p));
        const float4 y = __ldg(reinterpret_cast<const float4*>(p) + 1);
        t[0] = x.x, t[1] = x.y, t[2] = x.z, t[3] = x.w, t[4] = y.x, t[5] = y.y, t[6] = y.z, t[7] = y.w;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) t[j] = k + j < k_end ? __ldg(p + j * o.sk) : 0.0f;
      }
    }
  }

  __device__ __forceinline__ void store(const Operand& o, char* dst) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (kChunks % kThreads != 0 && e >= kChunks) continue;
      int r, kc;
      where(o, e, r, kc);
      const int off = chunk_off(r, kc);
      const float* t = v[i];
      if constexpr (kP == 1) {
        uint4 u;
        u.x = pack2(__float2bfloat16_rn(t[0]), __float2bfloat16_rn(t[1]));
        u.y = pack2(__float2bfloat16_rn(t[2]), __float2bfloat16_rn(t[3]));
        u.z = pack2(__float2bfloat16_rn(t[4]), __float2bfloat16_rn(t[5]));
        u.w = pack2(__float2bfloat16_rn(t[6]), __float2bfloat16_rn(t[7]));
        *reinterpret_cast<uint4*>(dst + off) = u;
      } else {
        __nv_bfloat16 h[8], m[8], l[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) split3(t[j], h[j], m[j], l[j]);
        *reinterpret_cast<uint4*>(dst + off) =
            make_uint4(pack2(h[0], h[1]), pack2(h[2], h[3]), pack2(h[4], h[5]), pack2(h[6], h[7]));
        *reinterpret_cast<uint4*>(dst + kPieceBytes + off) =
            make_uint4(pack2(m[0], m[1]), pack2(m[2], m[3]), pack2(m[4], m[5]), pack2(m[6], m[7]));
        *reinterpret_cast<uint4*>(dst + 2 * kPieceBytes + off) =
            make_uint4(pack2(l[0], l[1]), pack2(l[2], l[3]), pack2(l[4], l[5]), pack2(l[6], l[7]));
      }
    }
  }
};

// A step's products for warpgroup wg's 64 rows: hi x hi into acc, every
// other pair of pieces into rest; two k16 slices, 2 kLead bytes apart along K.
template <int BN, int kPA, int kPB, int kRest>
__device__ __forceinline__ void step_products(float (&acc)[BN / 2], float (&rest)[kRest], const char* a,
                                              const char* b, int wg) {
  constexpr int kBPiece = BN * kDepth * 2;
  nvt::wgmma_fence();
#pragma unroll
  for (int sl = 0; sl < kDepth / 16; ++sl) {
    const char* as = a + wg * 8 * kStride + sl * 2 * kLead;
    const char* bs = b + sl * 2 * kLead;
    const uint64_t a0 = nvt::gmma_desc(as, kLead, kStride), b0 = nvt::gmma_desc(bs, kLead, kStride);
    nvt::wgmma_bf16<BN>(acc, a0, b0);
    if constexpr (kPB == 3) {
      nvt::wgmma_bf16<BN>(rest, a0, nvt::gmma_desc(bs + kBPiece, kLead, kStride));
      nvt::wgmma_bf16<BN>(rest, a0, nvt::gmma_desc(bs + 2 * kBPiece, kLead, kStride));
    }
    if constexpr (kPA == 3) {
#pragma unroll
      for (int pa = 1; pa < 3; ++pa) {
        const uint64_t ad = nvt::gmma_desc(as + pa * kAPiece, kLead, kStride);
        nvt::wgmma_bf16<BN>(rest, ad, b0);
        if constexpr (kPB == 3) {
          nvt::wgmma_bf16<BN>(rest, ad, nvt::gmma_desc(bs + kBPiece, kLead, kStride));
          nvt::wgmma_bf16<BN>(rest, ad, nvt::gmma_desc(bs + 2 * kBPiece, kLead, kStride));
        }
      }
    }
  }
  nvt::wgmma_commit();
}

template <int kRound>
__device__ __forceinline__ float round_c(float x) {
  if constexpr (kRound == 1) return __bfloat162float(__float2bfloat16_rn(x));
  else if constexpr (kRound == 2) return __half2float(__float2half_rn(x));
  else return x;
}

// The layer's epilogue on one element of C: z = y + bias, mask z > 0, round_c(relu(z))
__device__ __forceinline__ float epilogue(const Params& q, int n, float y, unsigned char& m) {
  const float z = q.bias ? __fadd_rn(y, q.bias[n]) : y;
  m = z > 0.0f;
  const float r = q.relu && z <= 0.0f ? 0.0f : z;
  return q.round == 1 ? round_c<1>(r) : q.round == 2 ? round_c<2>(r) : r;
}

__device__ __forceinline__ void store_one(const Params& q, int64_t m, int n, float y) {
  unsigned char mk;
  const int64_t o = m * q.N + n;
  q.c[o] = epilogue(q, n, y, mk);
  if (q.relu) q.mask[o] = mk;
}

template <int BN, int kPA, int kPB>
__global__ void __launch_bounds__(kThreads) mlp_mm_kernel(const Params q) {
  extern __shared__ __align__(128) char smem[];
  __shared__ int last;
  constexpr bool kSplit = kPA > 1 || kPB > 1;
  constexpr int kRest = kSplit ? BN / 2 : 1;
  constexpr int kBOff = kPA * kAPiece;                  // B's pieces after A's in a step's slot
  constexpr int kSlot = kBOff + kPB * BN * kDepth * 2;  // a staged step
  const int wg = threadIdx.x >> 7;
  const int64_t tile = blockIdx.x;
  const int64_t m0 = tile / q.col_tiles * kRows;
  const int n0 = static_cast<int>(tile % q.col_tiles) * BN;
  const int64_t kb = static_cast<int64_t>(blockIdx.y) * q.k_split;
  const int64_t ke = q.K < kb + q.k_split ? q.K : kb + q.k_split;
  // at least one step (of zeros where K is 0): the loop's sums always come from its products
  const int64_t steps = ke > kb ? (ke - kb + kDepth - 1) / kDepth : 1;

  float acc[BN / 2], rest[kRest];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kRest; ++i) rest[i] = 0.0f;

  Stage<kRows, kPA> sa;
  Stage<BN, kPB> sb;
  sa.load(q.a, m0, kb, ke);
  sb.load(q.b, n0, kb, ke);
  int64_t st = 0;
  do {
    char* slot = smem + (st % kBufs) * kSlot;
    sa.store(q.a, slot);
    sb.store(q.b, slot + kBOff);
    nvt::fence_async_smem();
    __syncthreads();  // the step's tiles in place; every warpgroup's products of step st - 2 are done
    step_products<BN, kPA, kPB, kRest>(acc, rest, slot, slot + kBOff, wg);
    if (st + 1 < steps) {
      sa.load(q.a, m0, kb + (st + 1) * kDepth, ke);
      sb.load(q.b, n0, kb + (st + 1) * kDepth, ke);
    }
    // this warpgroup's products of step st - 1 are done (the sums are not
    // touched while a product is in flight: ptxas would serialize the wgmmas)
    nvt::wgmma_wait<1>();
  } while (++st < steps);
  nvt::wgmma_wait<0>();
  nvt::pin(acc);
  if constexpr (kSplit) nvt::pin(rest);

  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const bool pairs = (q.N & 1) == 0;  // float2 stores of (n, n + 1): n is even
  float* out = gridDim.y == 1 ? q.c : q.partial + static_cast<int64_t>(blockIdx.y) * q.M * q.N;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t m = m0 + 64 * wg + 16 * warp + (lane >> 2) + 8 * h;
      const int n = n0 + 8 * j + 2 * (lane & 3);
      if (m >= q.M || n >= q.N) continue;
      float y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
        if constexpr (kSplit) y[e] = isfinite(acc[i]) ? __fadd_rn(acc[i], rest[i]) : acc[i];
        else y[e] = acc[i];
      }
      const int64_t o = m * q.N + n;
      if (gridDim.y > 1) {  // this split's partial tile, as it is
        if (pairs) {
          *reinterpret_cast<float2*>(out + o) = make_float2(y[0], y[1]);
        } else {
          out[o] = y[0];
          if (n + 1 < q.N) out[o + 1] = y[1];
        }
      } else if (pairs) {
        unsigned char m0b, m1b;
        const float z0 = epilogue(q, n, y[0], m0b), z1 = epilogue(q, n + 1, y[1], m1b);
        *reinterpret_cast<float2*>(q.c + o) = make_float2(z0, z1);
        if (q.relu) *reinterpret_cast<uchar2*>(q.mask + o) = make_uchar2(m0b, m1b);
      } else {
        store_one(q, m, n, y[0]);
        if (n + 1 < q.N) store_one(q, m, n + 1, y[1]);
      }
    }
  }
  if (gridDim.y == 1) return;

  // The tile's last split to arrive sums the splits' partials in order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(q.tickets + tile, 1) == static_cast<int>(gridDim.y) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int e = threadIdx.x; e < kRows * BN; e += kThreads) {
    const int64_t m = m0 + e / BN;
    const int n = n0 + e % BN;
    if (m >= q.M || n >= q.N) continue;
    const int64_t o = m * q.N + n;
    float s = __ldcg(q.partial + o);
    for (int64_t sp = 1; sp < gridDim.y; ++sp) s = __fadd_rn(s, __ldcg(q.partial + sp * q.M * q.N + o));
    store_one(q, m, n, s);
  }
  if (threadIdx.x == 0) q.tickets[tile] = 0;
}

template <int BN, int kPA, int kPB>
int launch(const Params& q, int64_t tiles, int splits, cudaStream_t stream) {
  constexpr int smem = kBufs * (kPA * kAPiece + kPB * BN * kDepth * 2);
  // past 48 KB with the static `last`: every instance opts in
  const cudaError_t attr =
      cudaFuncSetAttribute(mlp_mm_kernel<BN, kPA, kPB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  mlp_mm_kernel<BN, kPA, kPB><<<dim3(static_cast<unsigned>(tiles), splits), kThreads, smem, stream>>>(q);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int by_pieces(int pa, int pb, const Params& q, int64_t tiles, int splits, cudaStream_t stream) {
  if (pa == 1 && pb == 1) return launch<BN, 1, 1>(q, tiles, splits, stream);
  if constexpr (BN <= 64) {
    if (pa == 3 && pb == 1) return launch<BN, 3, 1>(q, tiles, splits, stream);
    if (pa == 1 && pb == 3) return launch<BN, 1, 3>(q, tiles, splits, stream);
    if (pa == 3 && pb == 3) return launch<BN, 3, 3>(q, tiles, splits, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

// An operand's strides as the kernel reads them; false if neither is 1 (p may be null where K is 0: nothing is read)
bool make_operand(Operand& o, const void* p, int64_t sr, int64_t sk, int64_t rows, int64_t K, int vec) {
  o.p = static_cast<const float*>(p);
  o.sr = sr, o.sk = sk, o.rows = rows;
  o.kcontig = sk == 1;
  o.vec = vec;
  if ((!p && K > 0) || sr < 0 || sk < 0 || !(sk == 1 || sr == 1)) return false;
  return !vec || (o.kcontig && aligned(p, 16) && (rows == 1 || sr % 4 == 0));
}

}  // namespace

// C [M, N] = A [M, K] B [K, N] in float32 (kernels/mlp_mm.py mm_launch).
// Operand a: element (m, k) at a[m a_sr + k a_sk]; operand b: element
// (k, n) at b[n b_sr + k b_sk]; one stride of each is 1, vec their float4
// loads (K-contiguous, 16-byte aligned rows), pieces 1 (bfloat16 values)
// or 3 (float32). The plan (kernels/mlp_mm.py mm_plan): bn the columns of
// a tile (8, 16, 64 or 128; at most 64 with pieces 3), splits of k_split
// (a multiple of 32) along K; with splits > 1, partial is [splits, M, N]
// float32 scratch and tickets a zeroed counter a tile (the kernel leaves
// them so). bias [N] may be null; mask [M, N] bytes where relu; round 0
// none, 1 bfloat16, 2 float16.
extern "C" int nvt_mlp_mm(const void* a, int64_t a_sr, int64_t a_sk, int a_vec, int a_pieces, const void* b,
                          int64_t b_sr, int64_t b_sk, int b_vec, int b_pieces, int64_t M, int N, int64_t K, int bn,
                          int64_t k_split, int splits, void* c, const void* bias, void* mask, int relu, int round,
                          void* partial, void* tickets, void* stream) {
  Params q;
  if (M < 0 || N < 0 || K < 0 || !c || (relu && !mask) || round < 0 || round > 2 || splits < 1 ||
      splits > kMaxSplits || k_split < kDepth || k_split % kDepth || (splits > 1 && (!partial || !tickets)) ||
      (static_cast<int64_t>(splits) - 1) * k_split >= (K > 0 ? K : 1) || !aligned(c, 8) ||
      (mask && !aligned(mask, 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!make_operand(q.a, a, a_sr, a_sk, M, K, a_vec) || !make_operand(q.b, b, b_sr, b_sk, N, K, b_vec))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  const int64_t col_tiles = (N + bn - 1) / bn, tiles = (M + kRows - 1) / kRows * col_tiles;
  if (tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  q.M = M, q.K = K, q.N = N;
  q.col_tiles = static_cast<int>(col_tiles);
  q.k_split = k_split;
  q.c = static_cast<float*>(c);
  q.bias = static_cast<const float*>(bias);
  q.mask = static_cast<unsigned char*>(mask);
  q.relu = relu, q.round = round;
  q.partial = static_cast<float*>(partial);
  q.tickets = static_cast<int*>(tickets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 8: return by_pieces<8>(a_pieces, b_pieces, q, tiles, splits, st);
    case 16: return by_pieces<16>(a_pieces, b_pieces, q, tiles, splits, st);
    case 64: return by_pieces<64>(a_pieces, b_pieces, q, tiles, splits, st);
    case 128: return by_pieces<128>(a_pieces, b_pieces, q, tiles, splits, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
