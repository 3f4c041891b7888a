// The xDeepFM Compressed Interaction Network layer and its gradient for
// Hopper (sm_90a): kernel K13d.
//
// Replaces nvtabular_tpu/models/layers.py:120-141 (xdeepfm_outer_product):
// for x_k [B, Hk, D] and x_0 [B, F, D] of one element type T (float32,
// bfloat16 or float16) and w [Hk * F, Hn] in T or float32,
//
//   out[b, h, d] = sum_{i, j} w[i * F + j, h] * x_k[b, i, d] * x_0[b, j, d],
//
// the outer product z[b, i * F + j, d] = x_k[b, i, d] * x_0[b, j, d] (pair
// index i-major, as the reference's reshape) compressed by w, and the
// transpose XLA derives for it. With the pair index k = i * F + j and the
// column n = b * D + d, the layer is one matrix product
//
//   out[h, n] = sum_k w[k, h] * z[k, n]
//
// of M = Hn rows, depth K = Hk * F and N = B * D columns, whose right
// operand z is never stored: each block builds its tiles of z in shared
// memory as it goes (the reference materialises all of z, 21.8 GB at
// [65536, 200 * 26, 16]). Each z value is rounded once (__fmul_rn), as the
// reference's separate product rounds it; the sums run in float32 with fmaf,
// in another order than XLA's.
//
// The 16-bit element types follow the reference's rounding points: z is
// rounded to T (an exact __fmul_rn product of two T values, then
// __float2bfloat16_rn or __float2half_rn) before the float32 sum, and out is
// rounded to T. In the backward g is widened to float32; dz = sum_h w g is
// summed in float32 and rounded to T; each product dz * x_0 and dz * x_k is
// rounded to T before dx_k's and dx_0's float32 sums, which are rounded to T
// once; dw's float32 sum is rounded to w's type. For float32 every round is
// the identity and the kernels compute what they computed before. Loads and
// stores are in T (and w's type), the tiles in shared memory too, so a
// 16-bit tile stages half the bytes; the sums and z stay float32.
//
// Bound: operations. The forward is 2 * Hn * K * N flops (the backward twice
// that), against float32 outside the tensor cores (67 TFLOP/s): 283 GFLOP,
// 4.2 ms, at layer 1 of xDeepFM's Criteo setting ([65536, 26, 16] x
// [65536, 26, 16] -> 200), against 0.4 GB of bytes. Every kernel keeps an
// 8 x 8 register tile, whose shared-memory reads (4 float4 for 64 fmaf) just
// keep pace with the fmaf units. A 16-bit layer does the same float32
// operations (its products are not on the tensor cores).
//
// nvt_cin_fwd (cin_fwd_kernel): a block owns kFwdCols = 64 columns and every
// output row, so each z tile is built once. Hn is cut into passes of at most
// 256 rows (one pass up to Hn = 256; 200 rows stay 200, a multiple of 8),
// and the block has 8 threads for each 8 rows: a thread keeps an 8 x 8
// register tile (rows 8 ty .. 8 ty + 7; columns 4 tx .. 4 tx + 3 and 32 + 4
// tx .. 32 + 4 tx + 3, so a quarter-warp's float4 reads of z are 128
// consecutive bytes), 4 vector reads of shared memory for 64 fmaf. The block
// stages x_k[b, :, d] and x_0[b, :, d] of its columns in shared memory, so a
// step's z tile is __fmul_rn of two shared values: a step is one i and up to
// kFwdDepth consecutive j, and its w rows k = i * F + j .. are one contiguous
// run of w. The w tiles are double buffered and copied with cp.async: step
// s + 1's tile arrives while step s multiplies, behind one __syncthreads a
// step. Where all Hk + F rows of 64 columns fit beside the w buffers, they
// are staged once (91 KB at layer 2 in float32: two blocks an SM); else the
// host's plan cuts x_k into chunks of ci rows and x_0 into chunks of cj, and
// the steps walk chunk by chunk (x_k's chunks outer), each chunk staged once
// a pass.
//
// nvt_cin_bwd, for the output gradient g [B, Hn, D], in two kernels:
//   * cin_bwd_x: dz[k, n] = sum_h w[k, h] g[h, n] for 64 columns n a
//     block, then dx_k[i, n] = sum_j dz[i F + j, n] x_0[j, n] and dx_0[j, n]
//     = sum_i dz[i F + j, n] x_k[i, n]. A pass takes 256 consecutive pairs
//     (i, j) of a chunk of x_0's rows (all F up to kBxChunk), a thread an 8
//     x 8 tile of 8 pairs by 8 columns; dz runs over all h in steps of
//     kBxDepth whose w tiles (rows k, h contiguous: cp.async from w as it
//     lies) and g tiles are double buffered by cp.async; g's tile is read
//     along the columns and w's along h, 16 vector reads for 256 fmaf. A
//     warp whose 32 pairs are past the chunk's Hk * F skips the products.
//     The pass's products dz x_0 and then dz x_k go to shared memory (the
//     w tiles' room), where each dx_k entry sums its j and each dx_0 entry
//     its i in a fixed order (no atomics), dx_k onto the passes and chunks
//     before it in a float32 dx_k (the output itself for float32, else a
//     scratch rounded to T by cin_round_kernel), dx_0 across passes in
//     shared memory. x_k is staged a pass's rows at a time, so Hk has no
//     limit, and x_0 a chunk.
//   * cin_bwd_w: dw[k, h] = sum_n z[k, n] g[h, n], the reduction over the
//     B * D columns that JAX computes inside this function. A block owns
//     64 k and every row h (passes of at most 256, 8 threads for each 8
//     rows, as the forward) over one split of the columns; a step of 32
//     columns stages g's rows, and x_k and x_0 at each k's i and j, by
//     cp.async (double buffered), builds the z tile from them in shared
//     memory (__fmul_rn), and multiplies 8 x 8 register tiles. Blocks of
//     one split take consecutive block indices, so the split's g is read
//     from device memory about once. Each block adds its tile to a float32
//     dw (zeroed first; w's own dw for float32, else a scratch rounded to
//     w's type by cin_round_kernel) with one global atomic an entry: a
//     fixed-order second pass would store and reread a [splits, K, Hn]
//     partial (2.1 GB at layer 1's 96 splits) for no gain in speed.
// Global atomics make dw's summation order, and so its last bits, vary
// from run to run; dx_k and dx_0 sum in a fixed order.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include "async.cuh"

namespace {

constexpr int kSmemOptIn = 227 * 1024;  // the shared memory an H100 block can opt into

// --- element types: float, __nv_bfloat16, __half ------------------------------------------
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <class T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }
template <>
__device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }

// v rounded to T and widened again: the identity for float
template <class T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

template <class T>
constexpr int kVecElems = 16 / static_cast<int>(sizeof(T));  // the elements of a 16-byte copy

// 4 consecutive elements of shared memory (16-byte aligned for float, 8
// for 16 bits) as floats
template <class T>
__device__ __forceinline__ float4 load4(const T* p) {
  if constexpr (sizeof(T) == 4) {
    return *reinterpret_cast<const float4*>(p);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    T e[4];
    memcpy(e, &u, sizeof(u));
    return make_float4(to_f(e[0]), to_f(e[1]), to_f(e[2]), to_f(e[3]));
  }
}

// 8 consecutive elements of shared memory (16-byte aligned) as floats
template <class T>
__device__ __forceinline__ void load8(const T* p, float (&v)[8]) {
  if constexpr (sizeof(T) == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    T e[8];
    memcpy(e, &u, sizeof(u));
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = to_f(e[i]);
  }
}

// 16 bytes, global to shared, asynchronously (both ends 16-byte aligned)
template <class T>
__device__ __forceinline__ void copy16(T* dst, const T* src) {
  nvt::cp_async16(reinterpret_cast<float*>(dst), reinterpret_cast<const float*>(src));
}

// One element, global to shared: asynchronously for 4 bytes; a 2-byte
// element by a load and a store (cp.async copies 4, 8 or 16 bytes)
template <class T>
__device__ __forceinline__ void copy1(T* dst, const T* src) {
  if constexpr (sizeof(T) == 4) {
    nvt::cp_async4(reinterpret_cast<float*>(dst), reinterpret_cast<const float*>(src));
  } else {
    *dst = *src;
  }
}

__device__ __forceinline__ void zero16(void* dst) { *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0); }

struct Shape {
  int64_t B;
  int Hk, F, D, Hn;
  __host__ __device__ int64_t N() const { return B * D; }
  __host__ __device__ int K() const { return Hk * F; }
};

// Each column's offset in x_k, x_0 and [B, Hn, D] (out or g) for the
// columns [n0, n0 + count), -1 past N.
__device__ __forceinline__ void column_bases(const Shape& s, int64_t n0, int count, int64_t* bxk, int64_t* bx0,
                                             int64_t* bh) {
  const int64_t N = s.N();
  for (int c = threadIdx.x; c < count; c += blockDim.x) {
    const int64_t n = n0 + c;
    if (n < N) {
      const int64_t b = n / s.D;
      const int64_t d = n - b * s.D;
      bxk[c] = b * s.Hk * s.D + d;
      bx0[c] = b * s.F * s.D + d;
      bh[c] = b * s.Hn * s.D + d;
    } else {
      bxk[c] = bx0[c] = bh[c] = -1;
    }
  }
}

// dst[r][c] = src[base[c] + (r0 + r) * D] for r < nrows, c < 64 (0 past N);
// rows [nrows, rows) zeroed. Synchronous loads (the staging a pass or chunk).
template <class T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, const int64_t* base, int D, int r0, int nrows,
                                           int rows, T* dst) {
  for (int e = threadIdx.x; e < rows * 64; e += blockDim.x) {
    const int r = e / 64;
    const int64_t o = base[e % 64];
    dst[e] = (r < nrows && o >= 0) ? src[o + static_cast<int64_t>(r0 + r) * D] : from_f<T>(0.0f);
  }
}

// --- the forward ----------------------------------------------------------------------
constexpr int kFwdCols = 64;          // columns (b, d) of a block
constexpr int kFwdDepth = 16;         // pairs k of a step: one i, up to 16 consecutive j
constexpr int kFwdMaxGroups = 32;     // 8-row groups of a pass: at most 256 rows, 256 threads

// Shared memory of a forward block: the columns' offsets, ci rows of x_k
// and cj of x_0 (64 columns each, es bytes an element), two buffers of w
// tiles (ws bytes an element) and two of float z tiles.
size_t fwd_smem(int rows, int ci, int cj, size_t es, size_t ws) {
  return 3 * kFwdCols * sizeof(int64_t) + static_cast<size_t>(ci + cj) * kFwdCols * es +
         2 * kFwdDepth * static_cast<size_t>(rows) * ws + 2 * kFwdDepth * kFwdCols * sizeof(float);
}

int fwd_rows(int Hn) {
  int groups = (Hn + 7) / 8;
  if (groups > kFwdMaxGroups) groups = kFwdMaxGroups;
  return 8 * groups;
}

// dst[kk][m] = w[k0 + kk, h0 + m] for kk < depth and m < live, 0 for live
// <= m < rows: a step's w tile, copied asynchronously. kVec: 16-byte copies
// (Hn a multiple of kVecElems, w 16-byte aligned); a thread copies chunk q
// of rows kk0, kk0 + kk_step, ...; else one element a copy, a thread column
// m = q.
template <bool kVec, class TW>
__device__ __forceinline__ void load_w_tile(const TW* __restrict__ w, int Hn, int k0, int depth, int h0, int rows,
                                            int live, int q, int kk0, int kk_step, TW* __restrict__ dst) {
  const int m = kVec ? kVecElems<TW> * q : q;
  const TW* src = w + static_cast<int64_t>(k0) * Hn + h0 + m;
  for (int kk = kk0; kk < depth; kk += kk_step) {
    TW* d = dst + kk * rows + m;
    if (kVec) {
      if (m < live) copy16(d, src + static_cast<int64_t>(kk) * Hn);
      else zero16(d);
    } else {
      if (m < live) copy1(d, src + static_cast<int64_t>(kk) * Hn);
      else *d = from_f<TW>(0.0f);
    }
  }
  nvt::cp_async_commit();
}

template <bool kVec, class T, class TW>
__global__ void __launch_bounds__(256, 2)
cin_fwd_kernel(const T* __restrict__ xk, const T* __restrict__ x0, const TW* __restrict__ w, Shape s, int rows,
               int ci, int cj, T* __restrict__ out) {
  extern __shared__ float4 smem4[];
  int64_t* base_xk = reinterpret_cast<int64_t*>(smem4);  // [kFwdCols]: a column's offset in x_k, -1 past N
  int64_t* base_x0 = base_xk + kFwdCols;                  // ... in x_0
  int64_t* base_out = base_x0 + kFwdCols;                 // ... in out
  T* xks = reinterpret_cast<T*>(base_out + kFwdCols);     // [ci][kFwdCols]
  T* x0s = xks + ci * kFwdCols;                           // [cj][kFwdCols]
  TW* ws = reinterpret_cast<TW*>(x0s + cj * kFwdCols);    // [2][kFwdDepth][rows]
  float* zs = reinterpret_cast<float*>(ws + 2 * kFwdDepth * rows);  // [2][kFwdDepth][kFwdCols]
  const int nthreads = blockDim.x, tid = threadIdx.x;
  column_bases(s, static_cast<int64_t>(blockIdx.x) * kFwdCols, kFwdCols, base_xk, base_x0, base_out);
  __syncthreads();

  const int tx = tid % 8, ty = tid / 8;  // columns 4 tx + {0..3}, 32 + 4 tx + {0..3}; rows 8 ty + {0..7}
  // this thread's share of a w tile's copy
  const int chunks = kVec ? rows / kVecElems<TW> : rows;
  const int q = tid % chunks, kk0 = tid / chunks, kk_step = nthreads / chunks;
  int staged_i = -1, staged_j = -1;  // the chunks in shared memory
  for (int h0 = 0; h0 < s.Hn; h0 += rows) {
    const int live = s.Hn - h0 < rows ? s.Hn - h0 : rows;
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
    // chunks of x_k outer, then x_0's; in a chunk, i, then j in steps of
    // kFwdDepth (one chunk of each where all rows fit: ci = Hk, cj = F)
    load_w_tile<kVec>(w, s.Hn, 0, cj < kFwdDepth ? cj : kFwdDepth, h0, rows, live, q, kk0, kk_step, ws);
    int step = 0;
    for (int ic0 = 0; ic0 < s.Hk; ic0 += ci) {
      const int i_end = ic0 + ci < s.Hk ? ic0 + ci : s.Hk;
      for (int jc0 = 0; jc0 < s.F; jc0 += cj) {
        const int j_end = jc0 + cj < s.F ? jc0 + cj : s.F;
        if (ic0 != staged_i || jc0 != staged_j) {  // every thread is past the last z build
          if (ic0 != staged_i) stage_rows(xk, base_xk, s.D, ic0, i_end - ic0, ci, xks);
          if (jc0 != staged_j) stage_rows(x0, base_x0, s.D, jc0, j_end - jc0, cj, x0s);
          staged_i = ic0;
          staged_j = jc0;
          __syncthreads();
        }
        const int steps = (i_end - ic0) * ((j_end - jc0 + kFwdDepth - 1) / kFwdDepth);
        int i = ic0, j0 = jc0;  // the step's pairs: i, j0 .. j0 + depth - 1
        for (int st = 0; st < steps; ++st, ++step) {
          const int buf = step & 1;
          const int depth = j_end - j0 < kFwdDepth ? j_end - j0 : kFwdDepth;
          float* zb = zs + buf * kFwdDepth * kFwdCols;
          const T* xi = xks + (i - ic0) * kFwdCols;
          const T* xj = x0s + (j0 - jc0) * kFwdCols;
          for (int e = tid; e < depth * kFwdCols; e += nthreads)
            zb[e] = round_to<T>(__fmul_rn(to_f(xi[e % kFwdCols]), to_f(xj[e])));
          nvt::cp_async_wait<0>();
          __syncthreads();  // z and w of this step in place; every thread done with the other buffers
          int ni = i, nj = j0 + kFwdDepth;
          if (nj >= j_end) {
            nj = jc0;
            ++ni;
          }
          // the next step's w tile: in this chunk, else the next chunk's first
          int nk = -1, ndepth = 0;
          if (st + 1 < steps) {
            nk = ni * s.F + nj;
            ndepth = j_end - nj < kFwdDepth ? j_end - nj : kFwdDepth;
          } else {
            const int nic0 = jc0 + cj < s.F ? ic0 : ic0 + ci, njc0 = jc0 + cj < s.F ? jc0 + cj : 0;
            const int nj_end = njc0 + cj < s.F ? njc0 + cj : s.F;
            if (nic0 < s.Hk) {
              nk = nic0 * s.F + njc0;
              ndepth = nj_end - njc0 < kFwdDepth ? nj_end - njc0 : kFwdDepth;
            }
          }
          if (nk >= 0)
            load_w_tile<kVec>(w, s.Hn, nk, ndepth, h0, rows, live, q, kk0, kk_step,
                              ws + (buf ^ 1) * kFwdDepth * rows);
          const TW* wb = ws + buf * kFwdDepth * rows + ty * 8;
          const float* zt = zb + tx * 4;
#pragma unroll 2
          for (int kk = 0; kk < depth; ++kk) {
            float av[8];
            load8(wb + kk * rows, av);
            const float4 b0 = *reinterpret_cast<const float4*>(zt + kk * kFwdCols);
            const float4 b1 = *reinterpret_cast<const float4*>(zt + kk * kFwdCols + 32);
            const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int r = 0; r < 8; ++r)
#pragma unroll
              for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
          }
          i = ni;
          j0 = nj;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int h = h0 + ty * 8 + r;
      if (h >= s.Hn) break;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int64_t o = base_out[(c < 4 ? 0 : 32) + tx * 4 + (c & 3)];
        if (o >= 0) out[o + static_cast<int64_t>(h) * s.D] = from_f<T>(acc[r][c]);
      }
    }
    __syncthreads();  // the next pass refills both buffers
  }
}

// --- the backward: dz, dx_k and dx_0 ------------------------------------------------------
constexpr int kBxCols = 64;     // columns of a block
constexpr int kBxThreads = 256; // 8 column threads x 32 row threads, an 8 x 8 tile each
constexpr int kBxRows = 256;    // rows k of a pass: 32 row threads x 8
constexpr int kBxDepth = 32;    // h of a step
constexpr int kBxChunk = 128;   // x_0's rows a chunk, at most
// the w tiles' room: two [kBxRows][kBxDepth] tiles of float32 w, or after a
// pass its float32 products [kBxRows][kBxCols] (the same 64 KB; 16-bit w
// tiles take half of it)
constexpr size_t kBxWorkBytes = static_cast<size_t>(kBxRows) * kBxCols * sizeof(float);

struct BxLayout {
  int jr, xk_rows;  // x_0's rows a chunk; x_k's rows a pass spans, at most
  size_t smem;
};

// The host's plan (kernels/cin.py bwd_x_plan): x_0's rows in chunks of jr
// (the last narrower), a pass's pairs spanning at most xk_rows rows of x_k.
// Shared memory: the columns' offsets; each pass row's k, i and j; the
// work room (two w tiles, then a pass's products for dx_k and then dx_0);
// two g tiles [kBxDepth][64] (es bytes an element); x_0's chunk's float32
// dx_0 sums [jr][64]; the chunk's rows of x_0 [jr][64] and x_k's rows of a
// pass [xk_rows][64] (es bytes an element). Refused (smem 0) where xk_rows
// is short of what the narrowest chunk's passes span.
BxLayout bx_layout(int F, int jr, int xk_rows, size_t es) {
  if (jr < 1 || jr > F) return {jr, xk_rows, 0};
  const int narrowest = F - (F - 1) / jr * jr;
  if (xk_rows < (kBxRows - 1 + narrowest - 1) / narrowest + 1) return {jr, xk_rows, 0};
  const size_t smem = 3 * kBxCols * sizeof(int64_t) + 3 * kBxRows * sizeof(int) + kBxWorkBytes +
                      2 * kBxDepth * kBxCols * es + static_cast<size_t>(jr) * kBxCols * sizeof(float) +
                      static_cast<size_t>(jr + xk_rows) * kBxCols * es;
  return {jr, xk_rows, smem};
}

// A step's tiles: w rows rowk[m] (zero where -1), h [h0, h0 + kBxDepth),
// into wd[m][hh]; g rows h of the block's columns into gd[hh][c]; h past Hn
// zeroed in both up to a multiple of 4. kVecW, kVecG: 16-byte copies (Hn,
// and D, a multiple of the copy's elements; aligned).
template <bool kVecW, bool kVecG, class T, class TW>
__device__ __forceinline__ void bx_load_tiles(const TW* __restrict__ w, const T* __restrict__ g,
                                              const int64_t* base_g, const int* rowk, const Shape& s, int h0,
                                              TW* __restrict__ wd, T* __restrict__ gd) {
  const int depth = s.Hn - h0 < kBxDepth ? s.Hn - h0 : kBxDepth;
  const int depth4 = (depth + 3) & ~3;
  constexpr int vw = kVecW ? kVecElems<TW> : 1;
  constexpr int wq = kBxDepth / vw;  // copies a w row
  for (int e = threadIdx.x; e < kBxRows * wq; e += kBxThreads) {
    const int m = e / wq, hh = (e - m * wq) * vw;
    if (hh >= depth4) continue;
    const int k = rowk[m];
    TW* d = wd + m * kBxDepth + hh;
    const TW* src = w + static_cast<int64_t>(k) * s.Hn + h0 + hh;
    if constexpr (kVecW) {
      if (k >= 0 && hh < depth) copy16(d, src);
      else zero16(d);
    } else {
      if (k >= 0 && hh < depth) copy1(d, src);
      else *d = from_f<TW>(0.0f);
    }
  }
  constexpr int vg = kVecG ? kVecElems<T> : 1;
  constexpr int gq = kBxCols / vg;  // copies a g row
  for (int e = threadIdx.x; e < depth4 * gq; e += kBxThreads) {
    const int hh = e / gq, c = (e - hh * gq) * vg;
    const int64_t o = base_g[c];
    T* d = gd + hh * kBxCols + c;
    const T* src = g + o + static_cast<int64_t>(h0 + hh) * s.D;
    if constexpr (kVecG) {
      if (o >= 0 && hh < depth) copy16(d, src);
      else zero16(d);
    } else {
      if (o >= 0 && hh < depth) copy1(d, src);
      else *d = from_f<T>(0.0f);
    }
  }
  nvt::cp_async_commit();
}

// Each of this thread's 8 rows m: acc[r][c] * the shared row sel(m) of
// `rows` at this thread's columns, rounded to T, into scratch[m][c] (0
// where rowk is -1).
template <class T, class Sel>
__device__ __forceinline__ void bx_products(const float (&acc)[8][8], const int* rowk, const T* rows, Sel sel,
                                            int ty, int tx, float* scratch) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int m = ty * 8 + r;
    const bool kept = rowk[m] >= 0;
    const T* xr = rows + (kept ? sel(m) : 0) * kBxCols + tx * 4;
    const float4 lo = load4(xr);
    const float4 hi = load4(xr + 32);
    const float xv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    float pv[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) pv[c] = kept ? round_to<T>(__fmul_rn(acc[r][c], xv[c])) : 0.0f;
    float* pr = scratch + m * kBxCols + tx * 4;
    *reinterpret_cast<float4*>(pr) = make_float4(pv[0], pv[1], pv[2], pv[3]);
    *reinterpret_cast<float4*>(pr + 32) = make_float4(pv[4], pv[5], pv[6], pv[7]);
  }
}

// dxk: float32 [B, Hk, D] (summed into across passes and chunks); dx0: T.
template <bool kVecW, bool kVecG, class T, class TW>
__global__ void __launch_bounds__(kBxThreads, 2)
cin_bwd_x_kernel(const T* __restrict__ xk, const T* __restrict__ x0, const TW* __restrict__ w,
                 const T* __restrict__ g, Shape s, BxLayout L, float* __restrict__ dxk, T* __restrict__ dx0) {
  extern __shared__ float4 smem4[];
  int64_t* base_xk = reinterpret_cast<int64_t*>(smem4);
  int64_t* base_x0 = base_xk + kBxCols;
  int64_t* base_g = base_x0 + kBxCols;
  int* rowk = reinterpret_cast<int*>(base_g + kBxCols);  // [kBxRows]: a pass row's k (-1 past the chunk's rows)
  int* rowi = rowk + kBxRows;                            // its i
  int* rowj = rowi + kBxRows;                            // its j within the chunk
  char* work = reinterpret_cast<char*>(rowj + kBxRows);
  TW* ws = reinterpret_cast<TW*>(work);                  // [2][kBxRows][kBxDepth]
  float* prod = reinterpret_cast<float*>(work);          // a pass's products after: [kBxRows][kBxCols]
  T* gs = reinterpret_cast<T*>(work + kBxWorkBytes);     // [2][kBxDepth][kBxCols]
  float* dx0s = reinterpret_cast<float*>(gs + 2 * kBxDepth * kBxCols);  // [jr][kBxCols]
  T* x0s = reinterpret_cast<T*>(dx0s + L.jr * kBxCols);  // [jr][kBxCols]
  T* xks = x0s + L.jr * kBxCols;                         // [xk_rows][kBxCols]
  const int tid = threadIdx.x;
  const int tx = tid % 8, ty = tid / 8;  // columns 4 tx + {0..3}, 32 + 4 tx + {0..3}; pass rows 8 ty + {0..7}
  column_bases(s, static_cast<int64_t>(blockIdx.x) * kBxCols, kBxCols, base_xk, base_x0, base_g);
  const int steps = (s.Hn + kBxDepth - 1) / kBxDepth;
  for (int jc0 = 0; jc0 < s.F; jc0 += L.jr) {
    const int jw = s.F - jc0 < L.jr ? s.F - jc0 : L.jr;  // the chunk's rows of x_0
    const int64_t kc = static_cast<int64_t>(s.Hk) * jw;  // its pairs (i, j), row-major: the passes' rows
    __syncthreads();  // the chunk before is done with x_0's rows and its sums
    stage_rows(x0, base_x0, s.D, jc0, jw, L.jr, x0s);
    for (int e = tid; e < L.jr * kBxCols; e += kBxThreads) dx0s[e] = 0.0f;
    for (int64_t p0 = 0; p0 < kc; p0 += kBxRows) {
      {
        const int64_t kp = p0 + tid;  // kBxThreads == kBxRows: one row a thread
        const int i = static_cast<int>(kp / jw), j = static_cast<int>(kp - static_cast<int64_t>(i) * jw);
        rowi[tid] = i;
        rowj[tid] = j;
        rowk[tid] = kp < kc ? i * s.F + jc0 + j : -1;
      }
      const int i_lo = static_cast<int>(p0 / jw);
      const int i_hi = static_cast<int>((p0 + kBxRows - 1 < kc ? p0 + kBxRows - 1 : kc - 1) / jw);
      stage_rows(xk, base_xk, s.D, i_lo, i_hi - i_lo + 1, i_hi - i_lo + 1, xks);
      __syncthreads();  // the rows' k, i, j and x_k's rows in place
      const bool live = p0 + (tid / 32) * 32 < kc;  // this warp's 32 rows hold a pair (warp-uniform)
      float acc[8][8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
      bx_load_tiles<kVecW, kVecG>(w, g, base_g, rowk, s, 0, ws, gs);
      for (int step = 0; step < steps; ++step) {
        const int buf = step & 1;
        nvt::cp_async_wait<0>();
        __syncthreads();  // this step's tiles in place; every thread done with the other buffers
        if (step + 1 < steps)
          bx_load_tiles<kVecW, kVecG>(w, g, base_g, rowk, s, (step + 1) * kBxDepth,
                                      ws + (buf ^ 1) * kBxRows * kBxDepth, gs + (buf ^ 1) * kBxDepth * kBxCols);
        if (!live) continue;
        const int h0 = step * kBxDepth;
        const int depth4 = ((s.Hn - h0 < kBxDepth ? s.Hn - h0 : kBxDepth) + 3) & ~3;
        const TW* wt = ws + buf * kBxRows * kBxDepth + ty * 8 * kBxDepth;
        const T* gt = gs + buf * kBxDepth * kBxCols + tx * 4;
        for (int hh = 0; hh < depth4; hh += 4) {
          float b[4][8];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4 lo = load4(gt + (hh + u) * kBxCols);
            const float4 hi = load4(gt + (hh + u) * kBxCols + 32);
            b[u][0] = lo.x; b[u][1] = lo.y; b[u][2] = lo.z; b[u][3] = lo.w;
            b[u][4] = hi.x; b[u][5] = hi.y; b[u][6] = hi.z; b[u][7] = hi.w;
          }
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const float4 a = load4(wt + r * kBxDepth + hh);
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              float t = fmaf(a.x, b[0][c], acc[r][c]);
              t = fmaf(a.y, b[1][c], t);
              t = fmaf(a.z, b[2][c], t);
              acc[r][c] = fmaf(a.w, b[3][c], t);
            }
          }
        }
      }
      // acc[r][c] = dz[rowk[8 ty + r], column c], rounded to T as the reference's cast rounds it
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = round_to<T>(acc[r][c]);
      __syncthreads();  // every thread is done with the w tiles, which now take the products
      bx_products(acc, rowk, x0s, [&](int m) { return rowj[m]; }, ty, tx, prod);
      __syncthreads();
      // dx_k: each (i, column) sums its row's products in j order, onto the passes and chunks before
      for (int e = tid; e < (i_hi - i_lo + 1) * kBxCols; e += kBxThreads) {
        const int u = e / kBxCols, c = e - u * kBxCols;
        const int64_t o = base_xk[c];
        if (o < 0) continue;
        const int64_t first = static_cast<int64_t>(i_lo + u) * jw - p0;  // the row's j = 0, relative to the pass
        const int m0 = first > 0 ? static_cast<int>(first) : 0;
        const int m1 = first + jw < kBxRows ? static_cast<int>(first + jw) : kBxRows;
        float sum = 0.0f;
        for (int m = m0; m < m1; ++m) sum += prod[m * kBxCols + c];
        float* d = dxk + o + static_cast<int64_t>(i_lo + u) * s.D;
        *d = (jc0 == 0 && first >= 0) ? sum : *d + sum;
      }
      __syncthreads();
      bx_products(acc, rowk, xks, [&](int m) { return rowi[m] - i_lo; }, ty, tx, prod);
      __syncthreads();
      // dx_0: each (j, column) sums the pass's products in i order
      for (int e = tid; e < jw * kBxCols; e += kBxThreads) {
        const int j = e / kBxCols, c = e - j * kBxCols;
        int64_t m = static_cast<int64_t>(i_lo) * jw + j - p0;
        if (m < 0) m += jw;
        float sum = dx0s[e];
        for (; m < kBxRows && rowk[m] >= 0; m += jw) sum += prod[m * kBxCols + c];
        dx0s[e] = sum;
      }
      __syncthreads();  // the next pass refills the tables, x_k's rows and the w tiles
    }
    for (int e = tid; e < jw * kBxCols; e += kBxThreads) {
      const int j = e / kBxCols;
      const int64_t o = base_x0[e % kBxCols];
      if (o >= 0) dx0[o + static_cast<int64_t>(jc0 + j) * s.D] = from_f<T>(dx0s[e]);
    }
  }
}

// --- the backward: dw -----------------------------------------------------------------------
constexpr int kBwCols = 64;   // k of a block's tile
constexpr int kBwDepth = 32;  // columns n of a step
constexpr int kZStride = kBwCols + 4;  // the z tile's row: 16-byte aligned, its transposed writes 2-way at most
constexpr int kTargetBlocks = 132 * 8;

// Shared memory of cin_bwd_w: the tile's i and j of each k, two stages of g
// [rows][kBwDepth] and of x_k, x_0 at each k [kBwCols][kBwDepth] (es bytes
// an element), then the float32 z tile [kBwDepth][kZStride].
size_t bw_smem(int rows, size_t es) {
  return 2 * kBwCols * sizeof(int) + 2 * (static_cast<size_t>(rows) * kBwDepth + 2 * kBwCols * kBwDepth) * es +
         kBwDepth * kZStride * sizeof(float);
}

// The sample and dimension of column n.
__device__ __forceinline__ void column_of(const Shape& s, int64_t n, int64_t& b, int64_t& d) {
  if (s.N() <= INT32_MAX) {
    const uint32_t q = static_cast<uint32_t>(n) / static_cast<uint32_t>(s.D);
    b = q;
    d = n - static_cast<int64_t>(q) * s.D;
  } else {
    b = n / s.D;
    d = n - b * s.D;
  }
}

// A step's staging: columns [c0, c0 + kBwDepth) (those below hi), g's rows
// [h0, h0 + rows) into gd[m][nn], x_k[b, i(k), d] and x_0[b, j(k), d] for
// the tile's k into xd, yd [kk][nn]; zero past hi, Hn and K. kVec: the
// consecutive columns of one sample in a 16-byte copy (D a multiple of
// kVecElems, aligned).
template <bool kVec, class T>
__device__ __forceinline__ void bw_stage(const T* __restrict__ xk, const T* __restrict__ x0,
                                         const T* __restrict__ g, const Shape& s, const int* ki, const int* kj,
                                         int h0, int rows, int64_t c0, int64_t hi, T* __restrict__ gd,
                                         T* __restrict__ xd, T* __restrict__ yd) {
  if constexpr (kVec) {  // a thread's columns the same on every row (the block's threads a multiple of 8)
    constexpr int per_row = kBwDepth / kVecElems<T>;
    const int nn = (threadIdx.x % per_row) * kVecElems<T>, step = blockDim.x / per_row;
    const int64_t n = c0 + nn;
    int64_t b, d;
    column_of(s, n, b, d);
    const bool live = n < hi;
    const T* gb = g + (b * s.Hn + h0) * s.D + d;
    for (int row = threadIdx.x / per_row; row < rows; row += step) {
      T* dst = gd + row * kBwDepth + nn;
      if (live && h0 + row < s.Hn) copy16(dst, gb + static_cast<int64_t>(row) * s.D);
      else zero16(dst);
    }
    const T* xb = xk + b * s.Hk * s.D + d;
    const T* yb = x0 + b * s.F * s.D + d;
    for (int kk = threadIdx.x / per_row; kk < kBwCols; kk += step) {
      T* dx = xd + kk * kBwDepth + nn;
      T* dy = yd + kk * kBwDepth + nn;
      if (live && ki[kk] >= 0) {
        copy16(dx, xb + static_cast<int64_t>(ki[kk]) * s.D);
        copy16(dy, yb + static_cast<int64_t>(kj[kk]) * s.D);
      } else {
        zero16(dx);
        zero16(dy);
      }
    }
  } else {
    for (int e = threadIdx.x; e < (rows + kBwCols) * kBwDepth; e += blockDim.x) {
      const int row = e / kBwDepth, nn = e - row * kBwDepth;
      const int64_t n = c0 + nn;
      int64_t b, d;
      column_of(s, n, b, d);
      if (row < rows) {
        const int h = h0 + row;
        if (n < hi && h < s.Hn) copy1(gd + row * kBwDepth + nn, g + (b * s.Hn + h) * s.D + d);
        else gd[row * kBwDepth + nn] = from_f<T>(0.0f);
      } else {
        const int kk = row - rows;
        T* dx = xd + kk * kBwDepth + nn;
        T* dy = yd + kk * kBwDepth + nn;
        if (n < hi && ki[kk] >= 0) {
          copy1(dx, xk + (b * s.Hk + ki[kk]) * s.D + d);
          copy1(dy, x0 + (b * s.F + kj[kk]) * s.D + d);
        } else {
          *dx = from_f<T>(0.0f);
          *dy = from_f<T>(0.0f);
        }
      }
    }
  }
  nvt::cp_async_commit();
}

// dw: float32 [K, Hn], zeroed before, summed into by atomics
template <bool kVec, class T>
__global__ void __launch_bounds__(256, 2)
cin_bwd_w_kernel(const T* __restrict__ xk, const T* __restrict__ x0, const T* __restrict__ g, Shape s, int rows,
                 int k_tiles, int64_t cols_per_split, float* __restrict__ dw) {
  extern __shared__ float4 smem4[];
  int* ki = reinterpret_cast<int*>(smem4);           // [kBwCols]: k's i, -1 past K
  int* kj = ki + kBwCols;                             // [kBwCols]: k's j
  T* gst = reinterpret_cast<T*>(kj + kBwCols);        // [2][rows][kBwDepth]
  T* xst = gst + 2 * rows * kBwDepth;                 // [2][kBwCols][kBwDepth]
  T* yst = xst + 2 * kBwCols * kBwDepth;              // [2][kBwCols][kBwDepth]
  float* zs = reinterpret_cast<float*>(yst + 2 * kBwCols * kBwDepth);  // [kBwDepth][kZStride]
  const int tid = threadIdx.x;
  const int tx = tid % 8, ty = tid / 8;  // k columns 4 tx + {0..3}, 32 + 4 tx + {0..3}; rows h 8 ty + {0..7}
  const int k0 = static_cast<int>(blockIdx.x % k_tiles) * kBwCols;
  const int64_t split = blockIdx.x / k_tiles;
  const int64_t N = s.N();
  const int K = s.K();
  const int64_t lo = split * cols_per_split;
  const int64_t hi = lo + cols_per_split < N ? lo + cols_per_split : N;
  const int steps = static_cast<int>((hi - lo + kBwDepth - 1) / kBwDepth);
  for (int kk = tid; kk < kBwCols; kk += blockDim.x) {
    const int k = k0 + kk;
    ki[kk] = k < K ? k / s.F : -1;
    kj[kk] = k < K ? k - (k / s.F) * s.F : 0;
  }
  __syncthreads();
  for (int h0 = 0; h0 < s.Hn; h0 += rows) {
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
    if (steps > 0) bw_stage<kVec>(xk, x0, g, s, ki, kj, h0, rows, lo, hi, gst, xst, yst);
    for (int step = 0; step < steps; ++step) {
      const int buf = step & 1;
      nvt::cp_async_wait<0>();
      __syncthreads();  // this step's staging in place; every thread done with the last step's z tile
      const T* xb = xst + buf * kBwCols * kBwDepth;
      const T* yb = yst + buf * kBwCols * kBwDepth;
      for (int e = tid; e < kBwDepth * kBwCols; e += blockDim.x) {
        const int kk = e / kBwDepth, nn = e - kk * kBwDepth;
        zs[nn * kZStride + kk] = round_to<T>(__fmul_rn(to_f(xb[e]), to_f(yb[e])));
      }
      __syncthreads();  // the z tile in place; every thread done with the other stage
      if (step + 1 < steps)
        bw_stage<kVec>(xk, x0, g, s, ki, kj, h0, rows, lo + static_cast<int64_t>(step + 1) * kBwDepth, hi,
                       gst + (buf ^ 1) * rows * kBwDepth, xst + (buf ^ 1) * kBwCols * kBwDepth,
                       yst + (buf ^ 1) * kBwCols * kBwDepth);
      const T* gt = gst + buf * rows * kBwDepth + ty * 8 * kBwDepth;
      const float* zt = zs + tx * 4;
#pragma unroll 1
      for (int nn = 0; nn < kBwDepth; nn += 4) {
        float b[4][8];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 l = *reinterpret_cast<const float4*>(zt + (nn + u) * kZStride);
          const float4 h = *reinterpret_cast<const float4*>(zt + (nn + u) * kZStride + 32);
          b[u][0] = l.x; b[u][1] = l.y; b[u][2] = l.z; b[u][3] = l.w;
          b[u][4] = h.x; b[u][5] = h.y; b[u][6] = h.z; b[u][7] = h.w;
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float4 a = load4(gt + r * kBwDepth + nn);
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            float t = fmaf(a.x, b[0][c], acc[r][c]);
            t = fmaf(a.y, b[1][c], t);
            t = fmaf(a.z, b[2][c], t);
            acc[r][c] = fmaf(a.w, b[3][c], t);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int h = h0 + ty * 8 + r;
      if (h >= s.Hn) break;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int k = k0 + (c < 4 ? 0 : 32) + tx * 4 + (c & 3);
        if (k < K) atomicAdd(&dw[static_cast<int64_t>(k) * s.Hn + h], acc[r][c]);
      }
    }
    __syncthreads();  // the next pass restages both stages
  }
}

// --- the 16-bit outputs' one round: dst = src rounded to TO ------------------------------------
template <class TO>
__global__ void __launch_bounds__(256) cin_round_kernel(const float* __restrict__ src, TO* __restrict__ dst,
                                                        int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < n; e += stride)
    dst[e] = from_f<TO>(src[e]);
}

bool bad_shape(const Shape& s) {
  return s.B < 0 || s.Hk < 1 || s.F < 1 || s.D < 1 || s.Hn < 1 ||
         static_cast<int64_t>(s.Hk) * s.F > INT32_MAX / 2;
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <class Kernel>
int launch_setup(Kernel kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem)));
}

// 8 threads for each 8 rows
template <bool kVec, class T, class TW>
int launch_fwd(const T* xk, const T* x0, const TW* w, const Shape& s, int rows, int ci, int cj, size_t smem,
               int64_t blocks, T* out, cudaStream_t stream) {
  if (int rc = launch_setup(cin_fwd_kernel<kVec, T, TW>, smem)) return rc;
  cin_fwd_kernel<kVec, T, TW><<<static_cast<unsigned>(blocks), static_cast<unsigned>(rows), smem, stream>>>(
      xk, x0, w, s, rows, ci, cj, out);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVecW, bool kVecG, class T, class TW>
int launch_bwd_x(const T* xk, const T* x0, const TW* w, const T* g, const Shape& s, const BxLayout& L, float* dxk,
                 T* dx0, cudaStream_t stream) {
  if (int rc = launch_setup(cin_bwd_x_kernel<kVecW, kVecG, T, TW>, L.smem)) return rc;
  cin_bwd_x_kernel<kVecW, kVecG, T, TW>
      <<<static_cast<unsigned>(ceil_div(s.N(), kBxCols)), kBxThreads, L.smem, stream>>>(xk, x0, w, g, s, L, dxk,
                                                                                        dx0);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec, class T>
int launch_bwd_w(const T* xk, const T* x0, const T* g, const Shape& s, float* dw, cudaStream_t stream) {
  const int rows = fwd_rows(s.Hn);
  const size_t smem = bw_smem(rows, sizeof(T));
  if (int rc = launch_setup(cin_bwd_w_kernel<kVec, T>, smem)) return rc;
  // enough column splits to fill the card, each at least 256 columns, a multiple of kBwDepth
  const int64_t N = s.N();
  const int64_t k_tiles = ceil_div(s.K(), kBwCols);
  int64_t splits = kTargetBlocks / k_tiles;
  if (splits < 1) splits = 1;
  if (splits > ceil_div(N, 256)) splits = ceil_div(N, 256);
  const int64_t cols = ceil_div(ceil_div(N, splits), kBwDepth) * kBwDepth;
  splits = ceil_div(N, cols);
  cin_bwd_w_kernel<kVec, T><<<static_cast<unsigned>(k_tiles * splits), rows, smem, stream>>>(
      xk, x0, g, s, rows, static_cast<int>(k_tiles), cols, dw);
  return static_cast<int>(cudaGetLastError());
}

template <class TO>
int launch_round(const float* src, TO* dst, int64_t n, cudaStream_t stream) {
  if (n == 0) return 0;
  int64_t blocks = ceil_div(n, 256);
  if (blocks > kTargetBlocks) blocks = kTargetBlocks;
  cin_round_kernel<TO><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(src, dst, n);
  return static_cast<int>(cudaGetLastError());
}

template <class T, class TW>
int fwd_typed(const void* xk_, const void* x0_, const void* w_, const Shape& s, int ci, int cj, void* out_,
              cudaStream_t stream) {
  const T* xk = static_cast<const T*>(xk_);
  const T* x0 = static_cast<const T*>(x0_);
  const TW* w = static_cast<const TW*>(w_);
  T* out = static_cast<T*>(out_);
  const int rows = fwd_rows(s.Hn);
  const size_t smem = fwd_smem(rows, ci, cj, sizeof(T), sizeof(TW));
  if (ci < 1 || ci > s.Hk || cj < 1 || cj > s.F || smem > kSmemOptIn) return static_cast<int>(cudaErrorInvalidValue);
  if (s.B == 0) return 0;
  const int64_t blocks = ceil_div(s.N(), kFwdCols);
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = s.Hn % kVecElems<TW> == 0 && aligned16(w);
  return vec ? launch_fwd<true>(xk, x0, w, s, rows, ci, cj, smem, blocks, out, stream)
             : launch_fwd<false>(xk, x0, w, s, rows, ci, cj, smem, blocks, out, stream);
}

template <class T, class TW>
int bwd_typed(const void* xk_, const void* x0_, const void* w_, const void* g_, const Shape& s, int jr, int xk_rows,
              void* dxk_, void* dx0_, void* dw_, float* dxk_acc, float* dw_acc, cudaStream_t stream) {
  const T* xk = static_cast<const T*>(xk_);
  const T* x0 = static_cast<const T*>(x0_);
  const TW* w = static_cast<const TW*>(w_);
  const T* g = static_cast<const T*>(g_);
  T* dx0 = static_cast<T*>(dx0_);
  // float32 outputs are their own sums
  if constexpr (std::is_same_v<T, float>) dxk_acc = static_cast<float*>(dxk_);
  if constexpr (std::is_same_v<TW, float>) dw_acc = static_cast<float*>(dw_);
  const BxLayout L = bx_layout(s.F, jr, xk_rows, sizeof(T));
  if (L.smem == 0 || L.smem > kSmemOptIn || bw_smem(fwd_rows(s.Hn), sizeof(T)) > kSmemOptIn)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t dw_elems = static_cast<int64_t>(s.K()) * s.Hn;
  cudaError_t err = cudaMemsetAsync(dw_acc, 0, dw_elems * sizeof(float), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t N = s.N();
  if (N == 0) return launch_round(dw_acc, static_cast<TW*>(dw_), std::is_same_v<TW, float> ? 0 : dw_elems, stream);
  if (ceil_div(N, kBxCols) > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_w = s.Hn % kVecElems<TW> == 0 && aligned16(w);
  const bool vec_g = s.D % kVecElems<T> == 0 && aligned16(g) && aligned16(xk) && aligned16(x0);
  int rc;
  if constexpr (std::is_same_v<T, float>) {
    rc = vec_w ? (vec_g ? launch_bwd_x<true, true>(xk, x0, w, g, s, L, dxk_acc, dx0, stream)
                        : launch_bwd_x<true, false>(xk, x0, w, g, s, L, dxk_acc, dx0, stream))
               : (vec_g ? launch_bwd_x<false, true>(xk, x0, w, g, s, L, dxk_acc, dx0, stream)
                        : launch_bwd_x<false, false>(xk, x0, w, g, s, L, dxk_acc, dx0, stream));
  } else {  // 16 bits: both copies vectorized or neither (half the template instances)
    rc = vec_w && vec_g ? launch_bwd_x<true, true>(xk, x0, w, g, s, L, dxk_acc, dx0, stream)
                        : launch_bwd_x<false, false>(xk, x0, w, g, s, L, dxk_acc, dx0, stream);
  }
  if (rc) return rc;
  rc = vec_g ? launch_bwd_w<true>(xk, x0, g, s, dw_acc, stream) : launch_bwd_w<false>(xk, x0, g, s, dw_acc, stream);
  if (rc) return rc;
  if constexpr (!std::is_same_v<T, float>) {
    rc = launch_round(dxk_acc, static_cast<T*>(dxk_), N * s.Hk, stream);
    if (rc) return rc;
  }
  if constexpr (!std::is_same_v<TW, float>) rc = launch_round(dw_acc, static_cast<TW*>(dw_), dw_elems, stream);
  return rc;
}

// The element types (kernels/cin.py DTYPES): 0 float32, 1 bfloat16, 2
// float16; x_k, x_0, g and the outputs in T, w and dw in T or float32.
template <class Fn>
int with_types(int dtype, int wdtype, Fn&& fn) {
  if (dtype == 0 && wdtype == 0) return fn(float{}, float{});
  if (dtype == 1 && wdtype == 1) return fn(__nv_bfloat16{}, __nv_bfloat16{});
  if (dtype == 1 && wdtype == 0) return fn(__nv_bfloat16{}, float{});
  if (dtype == 2 && wdtype == 2) return fn(__half{}, __half{});
  if (dtype == 2 && wdtype == 0) return fn(__half{}, float{});
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x_k [B, Hk, D], x_0 [B, F, D] in T, w [Hk * F, Hn] in T or float32, all
// contiguous → out [B, Hn, D] in T, contiguous. ci, cj: the rows of x_k and
// x_0 a block stages at once (the wrapper's plan; Hk and F where all fit).
extern "C" int nvt_cin_fwd(const void* xk, const void* x0, const void* w, int64_t B, int Hk, int F, int D, int Hn,
                           int ci, int cj, int dtype, int wdtype, void* out, void* stream_ptr) {
  const Shape s{B, Hk, F, D, Hn};
  if (bad_shape(s)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return with_types(dtype, wdtype, [&](auto t, auto tw) {
    return fwd_typed<decltype(t), decltype(tw)>(xk, x0, w, s, ci, cj, out, stream);
  });
}

// g [B, Hn, D] in T, contiguous → dxk [B, Hk, D], dx0 [B, F, D] (every
// entry written) in T and dw [Hk * F, Hn] in w's type. dxk_acc (float32
// [B, Hk, D]) and dw_acc (float32 [Hk * F, Hn]): the float32 sums of a
// 16-bit dx_k and dw, rounded into them at the end (unread where the output
// is float32). jr, xk_rows: cin_bwd_x's plan (x_0's rows a chunk; x_k's
// rows a pass spans, at most).
extern "C" int nvt_cin_bwd(const void* xk, const void* x0, const void* w, const void* g, int64_t B, int Hk, int F,
                           int D, int Hn, int jr, int xk_rows, int dtype, int wdtype, void* dxk, void* dx0, void* dw,
                           float* dxk_acc, float* dw_acc, void* stream_ptr) {
  const Shape s{B, Hk, F, D, Hn};
  if (bad_shape(s)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return with_types(dtype, wdtype, [&](auto t, auto tw) {
    return bwd_typed<decltype(t), decltype(tw)>(xk, x0, w, g, s, jr, xk_rows, dxk, dx0, dw, dxk_acc, dw_acc,
                                                stream);
  });
}
